"""Plain reference of Instant-NGP (Mueller et al., SIGGRAPH 2022) on the
brick grid, and of the hash grid's encoding.

What the NGP cell's timed path computes, written out from the definitions
in plain PyTorch, fp32, the MLPs' operands rounded to bf16 (fp32 sums), as
the configuration states:

* :meth:`NGPReference.encode`: the multiresolution grid in the brick
  layout.  A level's cell of resolution ``res`` holds 2x2x2 corners of F
  features; a position is read as the trilinear sum of its cell's 8
  corners.  Dense levels (``res^3 <= 2^log2_rows``) read the corners from
  a shared ``(res + 1)^3`` corner grid; hashed levels read them from the
  row ``spatial_hash(cell) mod 2^log2_rows``, which holds the cell's 8
  corners.  :func:`hash_encode` is the hash grid's layout (corner entries
  hashed one by one).
* :meth:`NGPReference.density` / :meth:`field`: a 1-hidden-layer MLP of
  the encoding (channel 0 through TruncExp is sigma, the 16 outputs the
  geometry feature), the direction's degree-4 SH, a 2-hidden-layer rgb MLP
  with a sigmoid.
* :meth:`NGPReference.march`: fixed steps of ``sqrt(3) / 1024`` from the
  box entry (moved by the ray's noise), each probed against the occupancy
  bit of the cell it lies in, the first ``sample_cap`` occupied kept.
* :meth:`NGPReference.composite`: front-to-back, exclusive transmittance,
  samples at transmittance ``<= t_threshold`` dropped; white background.
* :meth:`NGPReference.loss`, :meth:`adam`, :meth:`refresh` (the sampled
  density-grid refresh: probes, max-merge into the decayed grid, the
  threshold, the occupancy bits).

Departures from the program, on purpose: no kernels, no packing, no
batching (the field is evaluated at every marched sample; the program
evaluates the first ``pack_cap`` valid samples); the march probes every
sample's own cell (the program's cell-interval marcher probes one point an
interval between cell boundaries: the two differ only for a sample on a
boundary to within rounding); the exclusive transmittance is a shifted
cumulative sum (the program subtracts each sample's optical depth from the
inclusive sum); the table gradients are autograd's of plain gathers.

Nothing here imports the program; the reference turns TF32 off
(:func:`fp32_matmuls`) when it is made.  ``tf32=True`` makes the control:
the operands of every fp32 product of a sample (the march's and the
field's positions, the encoders' interpolation, the composite) and, in the
backward, the product's incoming gradient rounded to TF32 first, what the
card's TF32 units would compute.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.pyramid import (_TF32Operand, _TF32Product,
                                         fp32_matmuls, sh_encode)

U32 = 0xFFFFFFFF
PRIMES = (1, 2654435761, 805459861)
NEAR = 0.01
SQRT3 = math.sqrt(3.0)
B1, B2 = 0.9, 0.999
CORNERS = [(c & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8)]
# a sample this near a cell boundary (in cells) lies in either cell to
# within the rounding of a march that finds its cell another way: the
# program's crossing times err by ~1e-4 cells
TIE = 5e-4


def spatial_hash(c: torch.Tensor) -> torch.Tensor:
    """``x * 1 xor y * 2654435761 xor z * 805459861`` mod 2^32 of
    non-negative int64 cell coordinates ``(..., 3)``."""
    h = (c[..., 0] * PRIMES[0]) & U32
    for d in (1, 2):
        h = h ^ ((c[..., d] * PRIMES[d]) & U32)
    return h


def morton(c: torch.Tensor) -> torch.Tensor:
    """Morton code of int64 coordinates ``(..., 3)`` below 1024: bit ``b``
    of x, y, z at bits ``3b``, ``3b + 1``, ``3b + 2``."""
    code = torch.zeros_like(c[..., 0])
    for b in range(10):
        for d in range(3):
            code = code | (((c[..., d] >> b) & 1) << (3 * b + d))
    return code


def morton_invert(code: torch.Tensor) -> torch.Tensor:
    return torch.stack([sum(((code >> (3 * b + d)) & 1) << b
                            for b in range(10)) for d in range(3)], dim=-1)


def _resolution(base: float, log_b: float, lv: int) -> int:
    return int(np.ceil(float(base) * np.exp(lv * log_b) - 1.0)) + 1


def _scale(base: float, log_b: float, lv: int) -> float:
    return float(base) * math.exp(lv * log_b) - 1.0


class BrickGeometry(NamedTuple):
    """The brick layout's levels: resolution, scale, dense or hashed, and
    where each level starts among the corners (dense) or rows (hashed)."""

    F: int
    rows: int  # rows of a hashed level
    res: Tuple[int, ...]
    scale: Tuple[float, ...]
    dense: Tuple[bool, ...]
    start: Tuple[int, ...]

    @classmethod
    def of(cls, brick: dict) -> "BrickGeometry":
        L = int(brick["levels"])
        base = float(brick["base_res"])
        log_b = math.log(float(brick["max_res"]) / base) / max(L - 1, 1)
        rows = 2 ** int(brick["log2_rows"])
        res, scale, dense, start = [], [], [], []
        corner = row = 0
        for lv in range(L):
            r = _resolution(base, log_b, lv)
            res.append(r)
            scale.append(_scale(base, log_b, lv))
            dense.append(r ** 3 <= rows)
            if dense[-1]:
                start.append(corner)
                corner += (r + 1) ** 3
            else:
                start.append(row)
                row += rows
        return cls(int(brick["feature_per_level"]), rows, tuple(res),
                   tuple(scale), tuple(dense), tuple(start))


class HashGeometry(NamedTuple):
    """The hash grid's levels: resolution, scale, table size, start, and
    whether the level is hashed."""

    F: int
    res: Tuple[int, ...]
    scale: Tuple[float, ...]
    size: Tuple[int, ...]
    start: Tuple[int, ...]
    hashed: Tuple[bool, ...]

    @classmethod
    def of(cls, grid: dict) -> "HashGeometry":
        L = int(grid["levels"])
        base = float(grid["base_res"])
        log_b = math.log(float(grid["max_res"]) / base) / (L - 1)
        cap = 2 ** int(grid["log2_T"])
        res, scale, size, start, hashed = [], [], [], [], []
        off, first_hashed = 0, L
        for lv in range(L):
            r = _resolution(base, log_b, lv)
            n = min(cap, (r ** 3 + 7) // 8 * 8)
            if r ** 3 > n and first_hashed == L:
                first_hashed = lv
            res.append(r)
            scale.append(_scale(base, log_b, lv))
            size.append(n)
            start.append(off)
            off += n
        hashed = [lv >= first_hashed for lv in range(L)]
        return cls(int(grid["feature_per_level"]), tuple(res), tuple(scale),
                   tuple(size), tuple(start), tuple(hashed))


def _cell(x01: torch.Tensor, scale: float):
    """The cell (int64) of positions in [0, 1]^3 at a level, and the
    position inside it."""
    pos = x01 * scale + 0.5
    cell = torch.floor(pos)
    return cell.long(), pos - cell


def _weights(frac: torch.Tensor) -> List[torch.Tensor]:
    """The 8 trilinear weights, corner (bx, by, bz) in ``CORNERS`` order."""
    lo = 1.0 - frac
    out = []
    for bits in CORNERS:
        w = None
        for d, b in enumerate(bits):
            f = frac[:, d] if b else lo[:, d]
            w = f if w is None else w * f
        out.append(w)
    return out


def brick_entries(x01: torch.Tensor, geo: BrickGeometry) -> List[torch.Tensor]:
    """Per level, the (M, 8) indices that positions (M, 3) in [0, 1]^3
    read: dense levels the corner entries (into the level's own corner
    grid, z slowest), hashed levels the cell's row (the same for its 8
    corners)."""
    out = []
    for lv in range(len(geo.res)):
        cell, _ = _cell(x01, geo.scale[lv])
        if geo.dense[lv]:
            n = geo.res[lv] + 1
            out.append(torch.stack(
                [((cell[:, 2] + bz) * n + cell[:, 1] + by) * n + cell[:, 0]
                 + bx for bx, by, bz in CORNERS], dim=1))
        else:
            row = spatial_hash(cell) % geo.rows
            out.append(row[:, None].expand(-1, 8))
    return out


def _product(w: torch.Tensor, v, tf32: bool) -> torch.Tensor:
    """``w * v`` (``v`` a tensor or a number); with ``tf32`` both operands
    and the product's incoming gradient rounded to TF32."""
    if not tf32:
        return w * v
    if not torch.is_tensor(v):
        v = torch.tensor(v, dtype=torch.float32, device=w.device)
    return _TF32Product.apply(_TF32Operand.apply(w) * _TF32Operand.apply(v))


def brick_encode(corners, bricks, x01, geo: BrickGeometry,
                 tf32: bool = False) -> torch.Tensor:
    """(M, 3) positions in [0, 1]^3 (clamped) -> (M, L * F) features,
    level-major.  ``corners`` (dense corner entries, F), ``bricks`` (hashed
    rows, 8F: corner-major)."""
    x01 = torch.clamp(x01, 0.0, 1.0)
    F = geo.F
    feats = []
    for lv, idx in enumerate(brick_entries(x01, geo)):
        _, frac = _cell(x01, geo.scale[lv])
        w = _weights(frac)
        acc = None
        for c in range(8):
            if geo.dense[lv]:
                v = corners[geo.start[lv] + idx[:, c]]
            else:
                v = bricks[geo.start[lv] + idx[:, c], c * F:(c + 1) * F]
            term = _product(w[c][:, None], v, tf32)
            acc = term if acc is None else acc + term
        feats.append(acc)
    return torch.cat(feats, dim=1)


def hash_encode(table, x01, geo: HashGeometry,
                tf32: bool = False) -> torch.Tensor:
    """(M, 3) positions in [0, 1]^3 -> (M, L * F), level-major; ``table``
    (F, entries).  Dense levels index ``x + y res + z res^2`` of the
    corner (mod the level's size), hashed levels its spatial hash."""
    feats = []
    for lv in range(len(geo.res)):
        cell, frac = _cell(x01, geo.scale[lv])
        w = _weights(frac)
        acc = None
        for c, bits in enumerate(CORNERS):
            k = cell + torch.tensor(bits, device=cell.device)
            r = geo.res[lv]
            i = (spatial_hash(k) if geo.hashed[lv]
                 else k[:, 0] + k[:, 1] * r + k[:, 2] * r * r)
            v = table[:, geo.start[lv] + i % geo.size[lv]].t()
            term = _product(w[c][:, None], v, tf32)
            acc = term if acc is None else acc + term
        feats.append(acc)
    return torch.cat(feats, dim=1)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def mlp(weights: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """ReLU between layers, none after the last; bf16 operands, fp32
    sums, no biases."""
    for i, w in enumerate(weights):
        x = torch.matmul(_bf16(x), _bf16(w))
        if i < len(weights) - 1:
            x = torch.relu(x)
    return x


class _TruncExp(torch.autograd.Function):
    """exp whose backward clamps its input to [-15, 15]."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


class March(NamedTuple):
    ts: torch.Tensor  # (N, S)
    valid: torch.Tensor  # (N, S)
    counts: torch.Tensor  # (N,)
    dt: float
    # the reference's own march: each ray's first step, and over its steps
    # (N, K) those kept and those within ``TIE`` of a cell whose bit differs
    t0: Optional[torch.Tensor] = None
    kept: Optional[torch.Tensor] = None
    tied: Optional[torch.Tensor] = None

    def steps(self, t0: torch.Tensor, n_steps: int) -> torch.Tensor:
        """The (N, K) mask of the fixed steps this march's samples take,
        counted from the first steps ``t0``."""
        ray, j = torch.nonzero(self.valid, as_tuple=True)
        k = torch.round((self.ts[ray, j] - t0[ray]) / self.dt).long()
        out = torch.zeros((self.ts.shape[0], n_steps), dtype=torch.bool,
                          device=self.ts.device)
        out[ray, k.clamp(0, n_steps - 1)] = True
        return out


class Composite(NamedTuple):
    rgb: torch.Tensor  # (N, 3) with the background
    opacity: torch.Tensor
    vr_samples: torch.Tensor


def _leaf_list(params, prefix: str) -> List[torch.Tensor]:
    return [params[k] for k in sorted(params) if k.startswith(prefix)]


class NGPReference:
    """The reference at a configuration's ``model``, ``render`` and
    ``train`` (the program's keys).  Params are named leaves:
    ``brick.corners``, ``brick.bricks``, ``xyz_mlp.w<i>``,
    ``rgb_mlp.w<i>``."""

    def __init__(self, config: dict, tf32: bool = False):
        fp32_matmuls()
        self.m, self.r, self.t = (config["model"], config["render"],
                                  config["train"])
        self.scale = float(self.m["scale"])
        self.G = int(self.m["grid_size"])
        self.geo = BrickGeometry.of(self.m["brick"])
        self.tf32 = tf32

    def mul(self, a, b):
        """An fp32 product (TF32 operands in the control)."""
        return _product(a, b, self.tf32)

    # --------------------------------------------------------------- field

    def encode(self, params, x01):
        return brick_encode(params["brick.corners"], params["brick.bricks"],
                            x01, self.geo, self.tf32)

    def density(self, params, xyz):
        """Positions (M, 3) in the scene box -> sigma (M,), feature (M, 16)."""
        x01 = (xyz + self.scale) / (2.0 * self.scale)
        h = mlp(_leaf_list(params, "xyz_mlp."), self.encode(params, x01))
        return _TruncExp.apply(h[:, 0]), h

    def field(self, params, xyz, dirs):
        """sigma (M,) and rgb (M, 3) at positions and ray directions."""
        sigma, h = self.density(params, xyz)
        d = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        x = torch.cat([sh_encode((d + 1.0) / 2.0), h], dim=-1)
        rgb = torch.sigmoid(mlp(_leaf_list(params, "rgb_mlp."), x))
        return sigma, rgb

    # ---------------------------------------------------------------- rays

    @staticmethod
    def rays(poses, K, width: int, img, pix):
        """Origins and directions of the drawn (image, pixel) pairs: the
        pixel centre's camera direction turned by the pose."""
        u = (pix % width).float()
        v = torch.div(pix, width, rounding_mode="floor").float()
        cam = torch.stack([(u - float(K[0, 2]) + 0.5) / float(K[0, 0]),
                           (v - float(K[1, 2]) + 0.5) / float(K[1, 1]),
                           torch.ones_like(u)], dim=-1)
        pose = poses[img]
        d = (cam[:, 0:1] * pose[:, :, 0] + cam[:, 1:2] * pose[:, :, 1]
             + cam[:, 2:3] * pose[:, :, 2])
        return pose[:, :, 3], d

    def march(self, o, d, noise, occ: torch.Tensor, cap: int) -> March:
        """The first ``cap`` occupied fixed-step samples of each ray inside
        the box; ``occ`` the (G^3,) occupancy bits in morton order.  Also
        marks the steps within ``TIE`` of a cell boundary whose two cells'
        bits differ."""
        s, G = self.scale, self.G
        dt = SQRT3 / int(self.r["max_samples"])
        inv = 1.0 / d
        t_a, t_b = (-s - o) * inv, (s - o) * inv
        t_in = torch.amax(torch.minimum(t_a, t_b), dim=-1)
        t_out = torch.amin(torch.maximum(t_a, t_b), dim=-1)
        t_in = torch.clamp(t_in, min=NEAR)
        hit = t_out > t_in
        t0 = t_in + dt * noise
        n_steps = int(math.ceil(2.0 * SQRT3 * s / dt)) + 2
        k = torch.arange(n_steps, dtype=torch.float32, device=o.device)
        ts = t0[:, None] + self.mul(k, dt)
        live = hit[:, None] & (ts < t_out[:, None])
        xyz = o[:, None, :] + self.mul(ts[..., None], d[:, None, :])
        u = torch.clamp(0.5 * (xyz / s + 1.0) * G, 0.0, G - 1.0)
        cell = u.long()
        own = occ[morton(cell)]
        tied = torch.zeros_like(own)
        for ax in range(3):
            frac = u[..., ax] - cell[..., ax]
            for side, near in ((-1, frac < TIE), (1, frac > 1.0 - TIE)):
                other = cell.clone()
                other[..., ax] = torch.clamp(other[..., ax] + side, 0, G - 1)
                tied |= near & (occ[morton(other)] != own)
        del u, cell
        keep = live & own
        keep = keep & (torch.cumsum(keep.long(), dim=1) <= cap)
        counts = keep.sum(dim=1)
        # the kept samples, in order, into (N, cap)
        slot = torch.cumsum(keep.long(), dim=1) - 1
        ray, j = torch.nonzero(keep, as_tuple=True)
        out = torch.zeros((o.shape[0], cap), dtype=ts.dtype, device=o.device)
        out[ray, slot[ray, j]] = ts[ray, j]
        valid = torch.arange(cap, device=o.device)[None, :] < counts[:, None]
        return March(out, valid, counts, dt, t0, keep, live & tied)

    def composite(self, sigma, rgb, m: March) -> Composite:
        """Front to back over the (N, S) grid: alpha of each sample's
        optical depth, the transmittance of the samples before it."""
        tau = torch.where(m.valid, self.mul(sigma, m.dt), 0.0)
        alpha = 1.0 - torch.exp(-tau)
        before = torch.cat([torch.zeros_like(tau[:, :1]),
                            torch.cumsum(tau, dim=1)[:, :-1]], dim=1)
        trans = torch.exp(-before)
        counted = m.valid & (trans > float(self.r["t_threshold"]))
        w = torch.where(counted, self.mul(alpha, trans), 0.0)
        opacity = w.sum(dim=1)
        color = self.mul(w[..., None], rgb).sum(dim=1)
        bg = 1.0 if self.r["white_bg"] else 0.0
        return Composite(color + bg * (1.0 - opacity)[:, None], opacity,
                         counted.sum())

    def render(self, params, o, d, m: March) -> Composite:
        """The rays' colours (with the background) at the samples of a
        march."""
        ray, j = torch.nonzero(m.valid, as_tuple=True)
        xyz = o[ray] + self.mul(m.ts[ray, j][:, None], d[ray])
        sig, col = self.field(params, xyz, d[ray])
        shape = m.ts.shape
        sigma = torch.zeros(shape, device=o.device).index_put((ray, j), sig)
        rgb = torch.zeros(shape + (3,), device=o.device).index_put(
            (ray, j), col)
        return self.composite(sigma, rgb, m)

    def loss(self, params, gt, o, d, m: March):
        """The step's MSE at the samples of a march, and the samples the
        composite counted."""
        comp = self.render(params, o, d, m)
        return torch.mean((comp.rgb - gt) ** 2), int(comp.vr_samples)

    # ----------------------------------------------------------- optimiser

    def adam(self, params: Dict[str, torch.Tensor], grads, mu, nu,
             count: int, sched: int) -> None:
        """One Adam step in place (``count`` the bias correction's count
        before the step, ``sched`` the schedule's): cosine from ``lr`` to
        ``lr / lr_final_div`` over ``max_steps``."""
        t = self.t
        base, steps = float(t["lr"]), int(t["max_steps"])
        a = 1.0 / float(t["lr_final_div"])
        c = min(float(sched), float(steps))
        lr = base * ((1.0 - a) * 0.5 * (1.0 + math.cos(math.pi * c / steps))
                     + a)
        n = count + 1
        bc1, bc2 = 1.0 - B1 ** n, 1.0 - B2 ** n
        eps = float(t["adam_eps"])
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                mu[k].mul_(B1).add_((1.0 - B1) * g)
                nu[k].mul_(B2).add_((1.0 - B2) * g * g)
                p.sub_(lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps))

    # ------------------------------------------------------------- refresh

    def threshold(self) -> float:
        return 0.01 * int(self.r["max_samples"]) / SQRT3

    def refresh_points(self, density_grid, coords1, keys, noise):
        """The sampled refresh's probes of the (G^3,) morton-ordered
        density grid: ``G^3 / 4`` drawn cells and as many occupied ones
        (the top drawn keys among the cells above the threshold; ties, and
        the cells below it, lowest index first), each at its centre moved
        by its jitter.  Returns their cells (morton) and positions."""
        G, s = self.G, self.scale
        occupied = density_grid > self.threshold()
        order = torch.sort(torch.where(occupied, keys, -1.0),
                           descending=True, stable=True).indices
        m = coords1.shape[0]
        idx1 = morton(coords1.long())
        idx2 = order[:m] if bool(occupied.any()) else idx1
        idx = torch.cat([idx1, idx2])
        cells = torch.cat([coords1.long(), morton_invert(idx2)])
        half = s / G
        xyz = (self.mul(cells.float() / (G - 1) * 2.0 - 1.0, s - half)
               + self.mul(noise, half))
        return idx, xyz

    @torch.no_grad()
    def refresh(self, params, density_grid, coords1, keys, noise,
                chunk: int = 1 << 20):
        """The sampled refresh: the density at :meth:`refresh_points`
        max-merged into the decayed grid (cells at -1, unseen, stay); the
        bits above the smaller of the mean positive density and the
        threshold.  Returns the grid and its bits."""
        idx, xyz = self.refresh_points(density_grid, coords1, keys, noise)
        sig = torch.cat([self.density(params, xyz[i:i + chunk])[0]
                         for i in range(0, xyz.shape[0], chunk)])
        probe = torch.zeros_like(density_grid).scatter_reduce(
            0, idx, sig, reduce="amax")
        decay = float(self.t["density_decay"])
        grid = torch.where(density_grid < 0, density_grid,
                           torch.maximum(density_grid * decay, probe))
        pos = grid > 0
        mean = grid[pos].sum() / max(int(pos.sum()), 1)
        return grid, grid > min(float(mean), self.threshold())
