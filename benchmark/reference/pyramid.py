"""Plain reference of the dense pyramid on the shear-warp renderer.

What the pyramid cells' timed paths compute, written out in plain PyTorch
for the one case they run: outside cameras, deferred shading, an unsplit
grid, full-matrix resamples (linear or Catmull-Rom), no distortion.

* :meth:`PyramidReference.bake`: the levels summed coarse to fine, each
  running sum trilinearly upsampled to the next level (pixel-centre aligned,
  edges clamped), channel 0 through ``exp(min(logit + bias, 11))``;
* :meth:`PyramidReference.render`: one frame.  The grid is cut into chunks
  of slabs along the dominant view axis; every slab is resampled onto its
  chunk's lattice (dense interpolation matrices) and composited front to
  back; the chunk frames are resampled onto the global frame on the cube's
  centre plane and folded; a two-pass band-matrix warp (or a bilinear
  gather) takes the global frame to pixels; the rgb MLP shades the
  opacity-normalised features once per pixel (bf16 operands, fp32 sums);
* :meth:`PyramidReference.loss`: the record recipe's loss on one crop
  (random background, opacity, sigma L1 and per-level TV terms);
* :meth:`PyramidReference.adam`: Adam (b1 0.9, b2 0.999, eps 1e-15) on a
  cosine schedule, in fp32.

The geometry follows the JAX package's ``render/swr.py`` and
``train/swr_step.py`` (the program's pattern); nothing here imports the
program.  Every fp32 product is a plain ``torch.matmul``: the caller keeps
TF32 off (:func:`fp32_matmuls`).  ``tf32=True`` makes the control: each
fp32 matmul's operands rounded to TF32 (10 mantissa bits, to nearest
even) first, what the card's TF32 tensor cores compute.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def fp32_matmuls() -> None:
    """Full fp32 for every float32 matmul and convolution."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (to nearest even), kept fp32."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class _TF32Operand(torch.autograd.Function):
    """Forward: the operand rounded to TF32; backward: the gradient as it
    comes (the product's backward rounds it, :class:`_TF32Product`)."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _TF32Product(torch.autograd.Function):
    """Forward: the product as it comes; backward: its gradient rounded to
    TF32, so the backward's products take TF32 operands too."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


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


def interp_kernel(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Weight at signed source distance ``x``: the 2-tap tent ("linear")
    or Catmull-Rom, a = -0.5 ("cubic")."""
    ax = torch.abs(x)
    if kind == "linear":
        return torch.clamp(1.0 - ax, min=0.0)
    w1 = (1.5 * ax - 2.5) * ax * ax + 1.0
    w2 = ((-0.5 * ax + 2.5) * ax - 4.0) * ax + 2.0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(ax <= 1.0, w1, torch.where(ax < 2.0, w2, zero))


def sh_encode(d: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 16) degree-4 real SH basis (instant-ngp's
    constants; callers pass ``(dir + 1) / 2``)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ], dim=-1)


def _guard(x: torch.Tensor, eps: float) -> torch.Tensor:
    """|x| < eps becomes +-eps, keeping the sign."""
    return torch.where(torch.abs(x) < eps,
                       torch.where(x >= 0, eps, -eps).to(x.dtype), x)


def _dirs(pose: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """World directions of (..., 3) camera directions, as explicit sums."""
    return (cam[..., 0:1] * pose[:, 0] + cam[..., 1:2] * pose[:, 1]
            + cam[..., 2:3] * pose[:, 2])


# ------------------------------------------------------------- host choices


def sweep_axis(pose) -> Tuple[int, bool]:
    """The dominant view axis and whether the sweep runs descending (the
    camera on the + side of that axis)."""
    pose = np.asarray(pose, np.float32).reshape(3, 4)
    axis = int(np.argmax(np.abs(pose[:, 2])))
    return axis, bool(pose[axis, 3] > 0)


def _grid_dirs(pose, K, img_wh, n_grid, crop_xy=(0, 0)) -> np.ndarray:
    w, h = img_wh
    u = crop_xy[0] + np.linspace(0.0, w - 1.0, n_grid)
    v = crop_xy[1] + np.linspace(0.0, h - 1.0, n_grid)
    uu, vv = np.meshgrid(u, v, indexing="xy")
    K = np.asarray(K, np.float64)
    cam = np.stack([(uu - K[0, 2] + 0.5) / K[0, 0],
                    (vv - K[1, 2] + 0.5) / K[1, 1], np.ones_like(uu)], -1)
    return cam @ np.asarray(pose, np.float64).reshape(3, 4)[:, :3].T


def pick_warp(pose, K, img_wh, axis: int, crop_xy=(0, 0)) -> str:
    """The final warp for a view: the band-matrix warp solving for camera y
    ("matmul") where its pass-A denominator keeps away from zero over the
    view's slopes, else solving for x ("matmul_x"), else the bilinear
    gather."""
    pose = np.asarray(pose, np.float64).reshape(3, 4)
    d = _grid_dirs(pose, K, img_wh, 7, crop_xy)
    c_axis = [x for x in range(3) if x != axis][1]
    da = d[..., axis]
    sc = d[..., c_axis] / np.where(np.abs(da) < 1e-12, 1e-12, da)
    sc_lo, sc_hi = float(sc.min()), float(sc.max())
    r = pose[:, :3]
    ra, rc = r[axis], r[c_axis]
    pad = 0.05 * max(sc_hi - sc_lo, 0.1)
    lo, hi = sc_lo - pad, sc_hi + pad
    for s, name in ((1, "matmul"), (0, "matmul_x")):
        e0, e1 = rc[s] - lo * ra[s], rc[s] - hi * ra[s]
        if e0 * e1 > 0 and min(abs(e0), abs(e1)) > 1e-3:
            return name
    return "gather"


# ----------------------------------------------------------------- reference


class PyramidReference:
    """The plain pyramid for one model configuration.

    ``cfg`` holds ``resolutions``, ``features`` (channel 0 the density
    logit), ``rgb_width``, ``rgb_depth``, ``scale``, ``sigma_bias``,
    ``n_chunks`` and ``resample_kind``; ``tf32`` makes the control.
    """

    def __init__(self, cfg: dict, tf32: bool = False):
        self.cfg = cfg
        self.tf32 = tf32
        self.R = int(cfg["resolutions"][-1])
        self.F = int(cfg["features"])
        self.kind = cfg["resample_kind"]

    # -- products

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """fp32 product, its operands rounded to TF32 for the control."""
        if not self.tf32:
            return torch.matmul(a, b)
        return _TF32Product.apply(torch.matmul(_TF32Operand.apply(a),
                                               _TF32Operand.apply(b)))

    def resample(self, x, start, step, out_len: int, axis: int, kind: str):
        """Affine resample of ``x`` along ``axis`` onto ``out_len`` points
        ``start + i * step`` (zero outside the source), as one product with
        the dense (n, out_len) interpolation matrix."""
        n = x.shape[axis]
        m = torch.arange(n, dtype=torch.float32, device=x.device)[:, None]
        i = torch.arange(out_len, dtype=torch.float32,
                         device=x.device)[None, :]
        w = interp_kernel(m - (start + i * step), kind)
        out = self.mm(torch.movedim(x, axis, -1), w)
        return torch.movedim(out, -1, axis)

    # -- the field

    def _upsample3(self, g: torch.Tensor, r_out: int) -> torch.Tensor:
        """Trilinear (r, r, r, F) -> (r_out, ...), three separable passes
        of 2-tap band matrices, pixel-centre aligned, edges clamped."""
        n_in = g.shape[0]
        pos = (torch.arange(r_out, dtype=torch.float32, device=g.device)
               + 0.5) * (n_in / r_out) - 0.5
        pos = torch.clamp(pos, 0.0, float(n_in - 1))
        m = torch.arange(n_in, dtype=torch.float32, device=g.device)[:, None]
        w = torch.clamp(1.0 - torch.abs(m - pos[None, :]), min=0.0)
        for ax in range(3):
            g = torch.movedim(self.mm(torch.movedim(g, ax, -1), w), -1, ax)
        return g

    def bake(self, params) -> torch.Tensor:
        """The (R, R, R, F) grid: channel 0 sigma, the rest features."""
        out = None
        for g in params["levels"]:
            if out is not None and out.shape[0] != g.shape[0]:
                out = self._upsample3(out, g.shape[0])
            out = g if out is None else out + g
        if out.shape[0] != self.R:
            out = self._upsample3(out, self.R)
        sigma = _TruncExp.apply(torch.clamp(
            out[..., 0] + float(self.cfg["sigma_bias"]), max=11.0))
        return torch.cat([sigma[..., None], out[..., 1:]], dim=-1)

    def rgb(self, params, feats: torch.Tensor, dirs: torch.Tensor):
        """(..., F-1) features and (..., 3) unit directions -> (..., 3) rgb:
        ReLU MLP without biases, sigmoid output, bf16 operands."""
        h = torch.cat([sh_encode((dirs + 1.0) / 2.0), feats], dim=-1)
        mlp = params["rgb_mlp"]
        depth = int(self.cfg["rgb_depth"])
        for i in range(depth + 1):
            w = mlp[f"w{i}"].to(torch.bfloat16).float()
            h = torch.matmul(h.to(torch.bfloat16).float(), w)
            h = torch.relu(h) if i < depth else torch.sigmoid(h)
        return h

    # -- the sweep

    def sweep(self, vol_cs, rs_par, z_rel, ch_par, nq: int):
        """Composite every chunk's slabs: (nc, F + 2, nq, nq) frames
        ``[acc (F-1) | depth | opacity | tau]``; one slab a step, each
        resampled by two dense interpolation matrices."""
        kind = self.kind
        nc, dc, F, Rb, Rc = vol_cs.shape
        dev = vol_cs.device
        lat = torch.arange(nq, dtype=torch.float32, device=dev)

        def interp_T(start, step, n):
            m = torch.arange(n, dtype=torch.float32, device=dev)
            pos = (start[:, None, None]
                   + lat[None, :, None] * step[:, None, None])
            return interp_kernel(m[None, None, :] - pos, kind)

        b0r, db, c0r, dcc, va, h = (ch_par[:, k, None, None]
                                    for k in range(6))
        vb = b0r + db * lat[None, :, None]
        vc = c0r + dcc * lat[None, None, :]
        norm = torch.sqrt(va * va + vb * vb + vc * vc)
        dt = h * norm / torch.abs(va)
        acc = torch.zeros((nc, F - 1, nq, nq), dtype=torch.float32,
                          device=dev)
        dep = torch.zeros((nc, nq, nq), dtype=torch.float32, device=dev)
        tau = torch.zeros((nc, nq, nq), dtype=torch.float32, device=dev)
        slabs = vol_cs.unbind(1)
        for s in range(dc):
            sb, stb, sc, stc = (rs_par[:, s, k] for k in range(4))
            wb = interp_T(sb, stb, Rb)
            wc = interp_T(sc, stc, Rc)
            x1 = self.mm(wb[:, None], slabs[s])
            x2 = self.mm(x1, wc[:, None].transpose(-1, -2))
            sdt = torch.relu(x2[:, 0]) * dt
            w = (1.0 - torch.exp(-sdt)) * torch.exp(-tau)
            acc = acc + w[:, None] * x2[:, 1:]
            dep = dep + w * (z_rel[:, s, None, None] * norm / va)
            tau = tau + sdt
        return torch.cat([acc, dep[:, None], (1.0 - torch.exp(-tau))[:, None],
                          tau[:, None]], dim=1)

    # -- one frame

    def render_fixed_axis(self, params, grid, pose, K, img_wh, axis: int,
                          flip: bool, lat_size: int = 0,
                          white_bg: bool = True, warp: str = "matmul",
                          lat_pad: int = 16, device=None
                          ) -> Dict[str, torch.Tensor]:
        """One frame with a given sweep axis and direction.  Also returns
        the slabs' resample parameters ``rs_par`` (n_chunks, dc, 4) and
        ``needed``, the chunks an early exit at 1e-4 must composite (those
        holding some sigma > 1e-4 while some pixel's transmittance is still
        above 1e-4).  With ``grid=None`` only ``rs_par`` is worked out (on
        ``device``)."""
        dev = grid.device if grid is not None else torch.device(device)
        f32 = torch.float32
        kind = self.kind
        pose = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
        K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
        s = float(self.cfg["scale"])
        R, F = self.R, self.F
        h = 2.0 * s / R
        n_chunks = min(int(self.cfg["n_chunks"]), R)
        w_img, h_img = img_wh
        nq = lat_size if lat_size else max(w_img, h_img) + lat_pad
        acc_ch = F - 1
        b_axis, c_axis = [d for d in range(3) if d != axis]
        zs = -s + (torch.arange(R, dtype=f32, device=dev) + 0.5) * h
        if flip:
            zs = torch.flip(zs, dims=(0,))
        if grid is not None:
            vol = grid.permute(axis, 3, b_axis, c_axis)
            if flip:
                vol = torch.flip(vol, dims=(0,))
            vol = vol.contiguous()
        o = pose[:, 3]
        o_a, o_b, o_c = o[axis], o[b_axis], o[c_axis]

        # frustum corner slopes: q(z) = o_bc + (z - o_a) * slope
        cu = torch.tensor([0.0, w_img - 1.0], dtype=f32, device=dev)
        cv = torch.tensor([0.0, h_img - 1.0], dtype=f32, device=dev)
        uu, vv = torch.meshgrid(cu, cv, indexing="xy")
        corner_cam = torch.stack([(uu - K[0, 2] + 0.5) / K[0, 0],
                                  (vv - K[1, 2] + 0.5) / K[1, 1],
                                  torch.ones_like(uu)], -1).reshape(-1, 3)
        corner_w = _dirs(pose, corner_cam)
        d_a_c = _guard(corner_w[:, axis], 1e-12)
        slope_b = corner_w[:, b_axis] / d_a_c
        slope_c = corner_w[:, c_axis] / d_a_c
        sb_lo, sb_hi = slope_b.min(), slope_b.max()
        sc_lo, sc_hi = slope_c.min(), slope_c.max()
        d_ac = corner_w[:, axis]
        frustum_ok = (d_ac.min() > 0) | (d_ac.max() < 0)

        def shadow(za, b0, b1, c0, c1):
            """The frame clipped to the cube's (grown by 2h) central
            projection on the plane."""
            sE = s + 2.0 * h
            r_hi = za / _guard(sE - o_a, 1e-6)
            r_lo = za / _guard(-sE - o_a, 1e-6)
            qb = torch.stack([o_b + (sE - o_b) * r_hi, o_b + (sE - o_b) * r_lo,
                              o_b + (-sE - o_b) * r_hi,
                              o_b + (-sE - o_b) * r_lo])
            qc = torch.stack([o_c + (sE - o_c) * r_hi, o_c + (sE - o_c) * r_lo,
                              o_c + (-sE - o_c) * r_hi,
                              o_c + (-sE - o_c) * r_lo])
            qb_lo, qb_hi = qb.amin(dim=0), qb.amax(dim=0)
            qc_lo, qc_hi = qc.amin(dim=0), qc.amax(dim=0)
            nb0 = torch.where(frustum_ok, torch.maximum(b0, qb_lo), qb_lo)
            nb1 = torch.where(frustum_ok, torch.minimum(b1, qb_hi), qb_hi)
            nc0 = torch.where(frustum_ok, torch.maximum(c0, qc_lo), qc_lo)
            nc1 = torch.where(frustum_ok, torch.minimum(c1, qc_hi), qc_hi)
            return (nb0, torch.maximum(nb1, nb0 + 1e-5),
                    nc0, torch.maximum(nc1, nc0 + 1e-5))

        def frame_at(z_ref):
            """Lattice origin and spacing covering the frustum (clipped to
            the cube's shadow) on the plane ``z_ref``, a margin centred."""
            za = z_ref - o_a
            pos = za >= 0
            b0 = o_b + za * torch.where(pos, sb_lo, sb_hi)
            b1 = o_b + za * torch.where(pos, sb_hi, sb_lo)
            c0 = o_c + za * torch.where(pos, sc_lo, sc_hi)
            c1 = o_c + za * torch.where(pos, sc_hi, sc_lo)
            b0, b1, c0, c1 = shadow(za, b0, b1, c0, c1)
            db = (b1 - b0) / (nq - 1 - lat_pad)
            dc = (c1 - c0) / (nq - 1 - lat_pad)
            return b0 - db * (lat_pad // 2), db, c0 - dc * (lat_pad // 2), dc

        dcs = R // n_chunks
        zs_c = zs.reshape(n_chunks, dcs)
        z_g = torch.zeros((), dtype=f32, device=dev)
        g_b0, g_db, g_c0, g_dc = frame_at(z_g)
        z_ref_c = zs_c.mean(dim=1)
        fb0_c, fdb_c, fc0_c, fdc_c = frame_at(z_ref_c)

        # per-slab resample parameters and per-chunk ray geometry
        rho = (z_ref_c[:, None] - o_a) / (zs_c - o_a)
        rs_par = torch.stack([
            (o_b + (fb0_c[:, None] - o_b) / rho + s) / h - 0.5,
            fdb_c[:, None] / (rho * h),
            (o_c + (fc0_c[:, None] - o_c) / rho + s) / h - 0.5,
            fdc_c[:, None] / (rho * h)], dim=-1)
        z_rel = zs_c - o_a
        ch_par = torch.stack([fb0_c - o_b, fdb_c, fc0_c - o_c, fdc_c,
                              z_ref_c - o_a, torch.full_like(z_ref_c, h)], -1)
        if grid is None:
            return {"rs_par": rs_par.cpu().numpy(), "nq": nq}
        frames = self.sweep(vol.reshape(n_chunks, dcs, *vol.shape[1:]),
                            rs_par, z_rel, ch_par, nq)

        acc_g = torch.zeros((acc_ch, nq, nq), dtype=f32, device=dev)
        depth_g = torch.zeros((nq, nq), dtype=f32, device=dev)
        t_g = torch.ones((nq, nq), dtype=f32, device=dev)
        occupied = (vol.reshape(n_chunks, dcs, *vol.shape[1:])[:, :, 0]
                    .amax(dim=(1, 2, 3)) > 1e-4).tolist()
        needed = []
        for g in range(n_chunks):
            if occupied[g] and float(t_g.detach().max()) > 1e-4:
                needed.append(g)
            # the ray at global lattice q crosses chunk g's plane at
            # o + (q - o) * rho_cg
            rho_cg = (z_ref_c[g] - o_a) / (z_g - o_a)
            start_b = (o_b * (1 - rho_cg) + g_b0 * rho_cg - fb0_c[g]) / fdb_c[g]
            step_b = g_db * rho_cg / fdb_c[g]
            start_c = (o_c * (1 - rho_cg) + g_c0 * rho_cg - fc0_c[g]) / fdc_c[g]
            step_c = g_dc * rho_cg / fdc_c[g]
            packed = self.resample(frames[g, :acc_ch + 2], start_b, step_b,
                                   nq, 1, kind)
            packed = self.resample(packed, start_c, step_c, nq, 2, kind)
            op_w = torch.clamp(packed[acc_ch + 1], 0.0, 1.0)
            acc_g = acc_g + t_g[None] * packed[:acc_ch]
            depth_g = depth_g + t_g * packed[acc_ch]
            t_g = t_g * (1.0 - op_w)

        # the final projective warp: pixel -> global-frame lattice
        u = torch.arange(w_img, dtype=f32, device=dev)
        v = torch.arange(h_img, dtype=f32, device=dev)
        uu, vv = torch.meshgrid(u, v, indexing="xy")
        dir_cam = torch.stack([(uu - K[0, 2] + 0.5) / K[0, 0],
                               (vv - K[1, 2] + 0.5) / K[1, 1],
                               torch.ones_like(uu)], -1)
        dir_w = _dirs(pose, dir_cam)
        da = dir_w[..., axis]
        grazing = torch.abs(da) < 1e-6
        t_hit = (z_g - o_a) / _guard(da, 1e-6)
        pb = o_b + t_hit * dir_w[..., b_axis]
        pc = o_c + t_hit * dir_w[..., c_axis]
        li = torch.clamp((pb - g_b0) / g_db, -1.0, float(nq))
        lj = torch.clamp((pc - g_c0) / g_dc, -1.0, float(nq))
        behind = (t_hit <= 0.0) | grazing
        img = torch.cat([acc_g, depth_g[None], (1.0 - t_g)[None]], dim=0)
        if warp == "gather":
            i0 = torch.clamp(torch.floor(li).long(), 0, nq - 2)
            j0 = torch.clamp(torch.floor(lj).long(), 0, nq - 2)
            fi = torch.clamp(li - i0, 0.0, 1.0)
            fj = torch.clamp(lj - j0, 0.0, 1.0)
            pix = (img[:, i0, j0] * ((1 - fi) * (1 - fj))
                   + img[:, i0, j0 + 1] * ((1 - fi) * fj)
                   + img[:, i0 + 1, j0] * (fi * (1 - fj))
                   + img[:, i0 + 1, j0 + 1] * (fi * fj))
        else:
            # two passes of linear tents: A solves each lattice row j for
            # one camera-plane coordinate, B resamples along j
            r = pose[:, :3]
            ra, rb, rc = r[axis], r[b_axis], r[c_axis]
            xs_pix = (torch.arange(w_img, dtype=f32, device=dev) - K[0, 2]
                      + 0.5) / K[0, 0]
            ys_pix = (torch.arange(h_img, dtype=f32, device=dev) - K[1, 2]
                      + 0.5) / K[1, 1]
            j_ar = torch.arange(nq, dtype=f32, device=dev)
            oa_rel = o_a - z_g
            gam = o_c - g_c0 - j_ar * g_dc
            if warp == "matmul_x":
                fidx, sidx, free = 1, 0, ys_pix
            else:
                fidx, sidx, free = 0, 1, xs_pix
            num = ((oa_rel * rc[fidx] - gam[:, None] * ra[fidx]) * free[None]
                   + (oa_rel * rc[2] - gam[:, None] * ra[2]))
            den = gam[:, None] * ra[sidx] - oa_rel * rc[sidx] + torch.zeros_like(num)
            sol = num / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
            if warp == "matmul_x":
                x_p, y_p = sol, free[None, :] + torch.zeros_like(sol)
            else:
                x_p, y_p = free[None, :] + torch.zeros_like(sol), sol
            da_j = ra[0] * x_p + ra[1] * y_p + ra[2]
            db_j = rb[0] * x_p + rb[1] * y_p + rb[2]
            posA = ((o_b - g_b0) * da_j - oa_rel * db_j) / (
                g_db * torch.where(torch.abs(da_j) < 1e-12, 1e-12, da_j))
            posA = torch.where(torch.isfinite(posA), posA, -1e9)
            i_ar = torch.arange(nq, dtype=f32, device=dev)
            WA = torch.clamp(1.0 - torch.abs(i_ar[None, :, None]
                                             - posA[:, None, :]), min=0.0)
            inter = self.mm(img.permute(2, 0, 1), WA)  # (J, C, N)
            posB = lj if warp == "matmul_x" else lj.T
            posB = torch.where(torch.isfinite(posB), posB, -1e9)
            WB = torch.clamp(1.0 - torch.abs(j_ar[None, :, None]
                                             - posB[:, None, :]), min=0.0)
            del WA
            pixT = self.mm(inter.permute(2, 1, 0), WB)  # (N, C, N')
            pix = (pixT.permute(1, 0, 2) if warp == "matmul_x"
                   else pixT.permute(1, 2, 0))
        pix = torch.where(behind[None], 0.0, pix)

        # deferred shading: the opacity-normalised features once a pixel
        depth = pix[acc_ch]
        opacity = pix[acc_ch + 1]
        dirs_pix = dir_w / torch.linalg.vector_norm(dir_w, dim=-1,
                                                    keepdim=True)
        feat_avg = pix[:acc_ch].permute(1, 2, 0) / torch.clamp(
            opacity, min=1e-6)[..., None]
        rgb = self.rgb(params, feat_avg, dirs_pix) * opacity[..., None]
        if white_bg:
            rgb = rgb + (1.0 - opacity)[..., None]
        n = h_img * w_img
        return {"rgb": rgb.reshape(n, 3), "depth": depth.reshape(n),
                "opacity": opacity.reshape(n),
                "rs_par": rs_par.detach().cpu().numpy(), "nq": nq,
                "needed": needed}

    def render(self, params, grid, pose, K, img_wh, lat_cap=None):
        """A served frame: the pose's own sweep axis and warp; ``lat_cap``
        bounds the lattice side (None: image side + 16)."""
        axis, flip = sweep_axis(pose)
        lat_size = 0
        if lat_cap and max(img_wh) + 16 > lat_cap:
            lat_size = int(lat_cap)
        warp = pick_warp(pose, K, img_wh, axis)
        return self.render_fixed_axis(params, grid, pose, K, img_wh, axis,
                                      flip, lat_size=lat_size, warp=warp)

    def crop_geometry(self, pose, K, crop_xy, crop: int, device):
        """``rs_par`` and the lattice side of a training crop's sweep."""
        K_crop = np.asarray(K, np.float32).copy()
        K_crop[0, 2] -= float(crop_xy[0])
        K_crop[1, 2] -= float(crop_xy[1])
        axis, flip = sweep_axis(pose)
        return self.render_fixed_axis(None, None, pose, K_crop, (crop, crop),
                                      axis, flip, device=device)

    # -- training

    def loss(self, params, gt_u8: torch.Tensor, pose, K, crop_xy,
             bg: torch.Tensor, tv_starts: Sequence[int], tcfg: dict):
        """The record recipe's loss on one ``crop`` x ``crop`` crop of the
        uint8 (H, W, 4) rgba image at top-left ``crop_xy``: the MSE of the
        render over the random background ``bg`` (crop^2, 3) against the
        GT put over the same background, ``alpha_w`` x the opacity's MSE,
        ``sigma_l1`` x the mean baked sigma, and ``tv_w`` x the squared
        differences of every level (the finest over a window of its first
        axis starting at ``tv_starts[0]``).  Returns ``(loss, mse)``."""
        c = int(tcfg["crop"])
        x0, y0 = int(crop_xy[0]), int(crop_xy[1])
        gt = gt_u8[y0:y0 + c, x0:x0 + c].reshape(c * c, 4).float() / 255.0
        gt_alpha, gt = gt[:, 3], gt[:, :3]
        K_crop = np.asarray(K, np.float32).copy()
        K_crop[0, 2] -= float(x0)
        K_crop[1, 2] -= float(y0)
        axis, flip = sweep_axis(pose)
        warp = pick_warp(pose, K, (c, c), axis, crop_xy=(x0, y0))
        grid = self.bake(params)
        out = self.render_fixed_axis(params, grid, pose, K_crop, (c, c), axis,
                                     flip, white_bg=False, warp=warp)
        rgb = out["rgb"] + (1.0 - out["opacity"])[:, None] * bg
        gt_eff = gt + (1.0 - gt_alpha)[:, None] * (bg - 1.0)
        mse = torch.mean((rgb - gt_eff) ** 2)
        loss = mse + float(tcfg["alpha_w"]) * torch.mean(
            (out["opacity"] - gt_alpha) ** 2)
        loss = loss + float(tcfg["sigma_l1"]) * torch.mean(grid[..., 0])
        tv = 0.0
        levels = params["levels"]
        for g in levels[:-1]:
            for ax in range(3):
                d = torch.diff(g, dim=ax)
                tv = tv + torch.mean(d * d)
        fine = levels[-1]
        s0 = int(tv_starts[0])
        win = fine[s0:s0 + max(fine.shape[0] // 4, 2)]
        for ax in range(3):
            d = torch.diff(win, dim=ax)
            tv = tv + torch.mean(d * d)
        return loss + float(tcfg["tv_w"]) * tv, mse

    @staticmethod
    def adam(params, grads, mu, nu, count: int, tcfg: dict) -> None:
        """Adam step ``count`` (1-based; the schedule reads ``count - 1``)
        on lists of leaves, in place, fp32 host scalars as the recipe
        computes them."""
        b1, b2, eps = 0.9, 0.999, 1e-15
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(b2) ** f32(count))
        max_steps, a = int(tcfg["max_steps"]), float(tcfg["lr_final_ratio"])
        c = min(float(count - 1), float(max_steps))
        cos = 0.5 * (1.0 + math.cos(math.pi * c / max_steps))
        lr = float(tcfg["lr"]) * ((1.0 - a) * cos + a)
        step = float(f32(-lr))
        with torch.no_grad():
            for g, m, v, p in zip(grads, mu, nu, params):
                m.copy_((1.0 - b1) * g + b1 * m)
                v.copy_((1.0 - b2) * (g * g) + b2 * v)
                p.add_(step * ((m / bc1) / (torch.sqrt(v / bc2) + eps)))
