"""Occupancy-grid ray marching: probe every candidate, then compact.

Port of the JAX package's ``ops/marching.py``.  Each ray's step lattice
``t_{k+1} = t_k + calc_dt(t_k)`` has a closed form (:func:`lattice_at`), so
all candidates are probed at once against the bitfield, and the first ``S``
occupied ones are compacted into a dense ``(N, S)`` sample grid.

Two marchers, as in the JAX package: the cell-interval marcher (one probe
per crossed cell; one cascade and constant ``dt``, the flagship's path)
and the lattice marcher (any cascades, ``exp_step_factor > 0``, and the
test renderer's resumable window).

Compaction.  The JAX code compacts with ``lax.top_k`` of keys that decrease
with the candidate index.  The occupied candidates of a ray have distinct
keys, and the unoccupied ones (tied at 0) are masked out afterwards, so the
result is "the first S occupied candidates in ascending order".  The port
computes exactly that with a cumulative sum and one scatter
(:func:`_first_occupied`): static shapes, no sort, no host read.

The cell-interval marcher has two implementations of the one function:
CUDA rays run the hand-written kernel of ``csrc/ngp_march.cu`` (operator
``taichi_nerfs_torch::ngp_march``: one launch walks each ray's cell
crossings in order and writes its first ``S`` samples), bit-equal to the
plain version on the card; CPU rays run the plain version,
:func:`_march_rays_intervals`.  The lattice marcher is plain PyTorch on
every device.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ._build import declare, on_cuda
from .math import (
    SQRT3_2,
    SQRT3_MAX_SAMPLES,
    bitfield_test,
    calc_dt,
    mip_from_dt,
    mip_from_pos,
    morton3d,
)


class MarchResult(NamedTuple):
    ts: torch.Tensor  # (N, S) sample positions along the ray
    deltas: torch.Tensor  # (N, S) sample intervals
    counts: torch.Tensor  # (N,) int32 valid samples per ray
    t_final: torch.Tensor  # (N,) where marching stopped


def num_candidates(scale: float, exp_step_factor: float,
                   grid_size: int = 128, near: float = 0.01) -> int:
    """Static candidate-window size covering a full AABB traversal."""
    dt_min = SQRT3_MAX_SAMPLES
    dt_max = SQRT3_2 * scale / grid_size
    span = 2.0 * math.sqrt(3.0) * scale
    if exp_step_factor == 0.0:
        return int(math.ceil(span / dt_min)) + 8
    t_lo_end = dt_min / exp_step_factor
    n1 = int(math.ceil(max(t_lo_end - near, 0.0) / dt_min))
    t_start_geo = max(near, t_lo_end)
    n2 = int(math.ceil(
        math.log(max((near + span) / t_start_geo, 1.0 + 1e-6))
        / math.log1p(exp_step_factor)
    ))
    n3 = int(math.ceil(span / dt_max)) + 8
    return n1 + n2 + min(n3, 4096)


def lattice_at(t_start: torch.Tensor, k: torch.Tensor,
               exp_step_factor: float, grid_size: int, scale: float):
    """The closed-form step lattice at float step indices ``k`` (N, ...)
    from per-ray origins ``t_start`` (N,): ``(ts, dts)`` of ``k``'s shape.
    Constant ``dt_min`` steps, then geometric growth, then ``dt_max``."""
    dt_min = SQRT3_MAX_SAMPLES
    dt_max = SQRT3_2 * scale / grid_size
    t1 = t_start.reshape(t_start.shape + (1,) * (k.ndim - 1))
    if exp_step_factor == 0.0:
        ts = t1 + k * dt_min
        return ts, torch.full_like(ts, dt_min)
    f = exp_step_factor
    log1pf = math.log1p(f)
    t_lo_end = dt_min / f
    t_hi_end = dt_max / f
    n1 = torch.ceil(torch.clamp(t_lo_end - t1, min=0.0) / dt_min)
    t_geo0 = t1 + n1 * dt_min
    n2 = torch.ceil(
        torch.log(torch.clamp(t_hi_end / torch.clamp(t_geo0, min=1e-30),
                              min=1.0)) / log1pf
    )
    t_hi0 = t_geo0 * torch.exp(n2 * log1pf)
    in_r1 = k < n1
    in_r2 = ~in_r1 & (k < n1 + n2)
    ts = torch.where(
        in_r1,
        t1 + k * dt_min,
        torch.where(in_r2, t_geo0 * torch.exp((k - n1) * log1pf),
                    t_hi0 + (k - n1 - n2) * dt_max),
    )
    return ts, torch.clamp(ts * f, dt_min, dt_max)


def candidate_lattice(t_start: torch.Tensor, n_candidates: int,
                      exp_step_factor: float, grid_size: int, scale: float):
    """(N, K) candidate ``t``s and their ``dt``s."""
    k = torch.arange(n_candidates, dtype=torch.float32,
                     device=t_start.device).expand(t_start.shape[0], -1)
    return lattice_at(t_start, k, exp_step_factor, grid_size, scale)


def occupancy_probe(xyz: torch.Tensor, dt: torch.Tensor,
                    bitfield: torch.Tensor, cascades: int, grid_size: int,
                    scale: float) -> torch.Tensor:
    """Cascade = max(mip_from_pos, mip_from_dt); the position normalised
    into that cascade's cube; its morton-indexed bit."""
    mip = torch.maximum(mip_from_pos(xyz, cascades),
                        mip_from_dt(dt, grid_size, cascades))
    mip_bound = torch.clamp(torch.exp2(mip.float() - 1.0), max=scale)
    nxyz = torch.clamp(0.5 * (xyz / mip_bound[..., None] + 1.0) * grid_size,
                       0.0, grid_size - 1.0)
    idx = mip.long() * grid_size**3 + morton3d(nxyz.long())
    return bitfield_test(bitfield, idx)


def _first_occupied(mask: torch.Tensor, values: torch.Tensor, S: int):
    """Per row, ``values`` at the first ``S`` True entries of ``mask``, in
    order, zero-padded to (N, S); and the number of True entries."""
    n = mask.shape[0]
    total = torch.sum(mask, dim=1)
    pos = torch.cumsum(mask, dim=1) - 1
    slot = torch.where(mask & (pos < S), pos, S)  # S is the discard column
    out = torch.zeros((n, S + 1), dtype=values.dtype, device=values.device)
    out.scatter_(1, slot, values)
    return out[:, :S], total


def _resume_point(ts, deltas, counts, sample_cap):
    """Where a ray stops when its cap was hit: after its last sample."""
    last = torch.clamp(counts.long() - 1, min=0)[:, None]
    t_after_cap = (torch.gather(ts, 1, last) + torch.gather(deltas, 1, last))
    return counts >= sample_cap, t_after_cap[:, 0]


def _march_rays_intervals(rays_o, rays_d, t_start, t_end, bitfield, *,
                          scale: float, grid_size: int,
                          sample_cap: int) -> MarchResult:
    """Cell-interval marcher (one cascade, constant ``dt``).

    The cell-boundary crossings along the ray are sorted; each interval
    between two crossings gets one probe at its midpoint's cell, and an
    occupied interval contributes its lattice indices ``ceil((lo - t0) /
    dt) .. ceil((hi - t0) / dt) - 1``.  The same samples as the lattice
    marcher up to float boundary ties."""
    n = rays_o.shape[0]
    G = grid_size
    dev = rays_o.device
    dt = SQRT3_MAX_SAMPLES
    h = 2.0 * scale / G
    # lattice points per interval at most (a diagonal crossing), +1 slack
    E = int(math.ceil((h * math.sqrt(3.0)) / dt)) + 1

    alive = t_start >= 0.0
    t0 = torch.where(alive, t_start, 0.0)
    t1 = torch.maximum(torch.where(alive, t_end, 0.0), t0)

    planes = -scale + torch.arange(1, G, dtype=torch.float32, device=dev) * h
    inv_d = torch.where(torch.abs(rays_d) > 1e-12, 1.0 / rays_d,
                        torch.inf)
    cross = (planes[None, None, :] - rays_o[:, :, None]) * inv_d[:, :, None]
    cross = cross.reshape(n, 3 * (G - 1))
    inside = (cross > t0[:, None]) & (cross < t1[:, None])
    cross = torch.where(inside, cross, torch.inf)
    # the AABB exit closes the last interval
    b = torch.sort(torch.cat([cross, t1[:, None]], dim=1), dim=1).values
    lo = torch.cat([t0[:, None], b[:, :-1]], dim=1)
    hi = b

    finite = torch.isfinite(hi) & (lo < t1[:, None])
    t_mid = torch.where(finite, 0.5 * (lo + hi), t0[:, None])
    xyz = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
    nxyz = torch.clamp(0.5 * (xyz / scale + 1.0) * G, 0.0, G - 1.0)
    occ = (bitfield_test(bitfield, morton3d(nxyz.long())) & finite
           & alive[:, None])

    k_lo = torch.ceil((lo - t0[:, None]) / dt)
    k_hi = torch.ceil((torch.minimum(hi, t1[:, None]) - t0[:, None]) / dt)
    count = torch.clamp(k_hi - k_lo, 0.0, float(E))
    e = torch.arange(E, dtype=torch.float32, device=dev)
    ks = (k_lo[:, :, None] + e).reshape(n, -1)
    valid_c = ((e < count[:, :, None]) & occ[:, :, None]).reshape(n, -1)

    # the valid lattice indices increase along the flattened (interval,
    # e) axis, so the first S valid entries are the S smallest indices
    sel, total = _first_occupied(valid_c, ks, sample_cap)
    counts = torch.clamp(total, max=sample_cap).to(torch.int32)
    valid = valid_mask(counts, sample_cap)
    ts = torch.where(valid, t0[:, None] + sel * dt, 0.0)
    deltas = torch.where(valid, dt, 0.0)
    capped, t_after_cap = _resume_point(ts, deltas, counts, sample_cap)
    t_final = torch.where(capped, t_after_cap, t_end)
    t_final = torch.where(alive, t_final, t_start)
    return MarchResult(ts=ts, deltas=deltas, counts=counts, t_final=t_final)


# ---- the kernel (csrc/ngp_march.cu) --------------------------------------


def _kernel_lattice(scale: float, grid_size: int):
    """The cell side ``h``, the lattice step ``dt`` and ``E`` (the most
    lattice points of one interval) as :func:`_march_rays_intervals`
    computes them, Python floats that the kernel rounds to fp32 as
    PyTorch's ops round their scalar operands."""
    dt = SQRT3_MAX_SAMPLES
    h = 2.0 * scale / grid_size
    return h, dt, int(math.ceil((h * math.sqrt(3.0)) / dt)) + 1


def _check_march_args(rays_o, rays_d, t_start, t_end, bitfield, scale,
                      grid_size, sample_cap):
    """Raise unless the kernel takes these."""
    if grid_size < 2 or grid_size > 1024 or grid_size & (grid_size - 1):
        raise ValueError(f"no ngp-march kernel for grid_size={grid_size} "
                         "(a power of two, 2 to 1024)")
    if sample_cap < 1:
        raise ValueError(f"sample_cap must be >= 1, got {sample_cap}")
    if not 0.0 < scale < math.inf:
        raise ValueError(f"scale must be positive and finite, got {scale}")
    n = rays_o.shape[0]
    for name, t, shape, dtype in (
            ("rays_o", rays_o, (n, 3), torch.float32),
            ("rays_d", rays_d, (n, 3), torch.float32),
            ("t_start", t_start, (n,), torch.float32),
            ("t_end", t_end, (n,), torch.float32),
            ("bitfield", bitfield, (bitfield.numel(),), torch.int32)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != rays_o.device:
            raise ValueError(f"{name} is on {t.device}, rays_o on "
                             f"{rays_o.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the ngp-march kernel "
                            f"takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bitfield.numel() * 32 < grid_size**3:
        raise ValueError(f"bitfield has {bitfield.numel()} words, a "
                         f"{grid_size}^3 grid needs {grid_size**3 // 32}")


def _march_fake(rays_o, rays_d, t_start, t_end, bitfield, scale, grid_size,
                sample_cap):
    """``MarchResult``'s tensors: ts, deltas (N, S), counts (N,) int32,
    t_final (N,)."""
    _check_march_args(rays_o, rays_d, t_start, t_end, bitfield, scale,
                      grid_size, sample_cap)
    n = rays_o.shape[0]
    return (rays_o.new_empty((n, sample_cap)),
            rays_o.new_empty((n, sample_cap)),
            rays_o.new_empty((n,), dtype=torch.int32),
            rays_o.new_empty((n,)))


def _march_op(launch, out, rays_o, rays_d, t_start, t_end, bitfield, scale,
              grid_size, sample_cap):
    if rays_o.shape[0]:
        h, dt, e_max = _kernel_lattice(scale, grid_size)
        ptrs = (t.data_ptr() for t in (rays_o, rays_d, t_start, t_end,
                                       bitfield, *out))
        launch(rays_o.device, *ptrs, rays_o.shape[0], grid_size, sample_cap,
               e_max, scale, h, dt)


# C arguments: pointers (rays_o, rays_d, t_start, t_end, bitfield, ts,
# deltas, counts, t_final), then N, G, S, E, then scale, h and dt
declare(
    "ngp_march(Tensor rays_o, Tensor rays_d, Tensor t_start, Tensor t_end, "
    "Tensor bitfield, float scale, int grid_size, int sample_cap) -> "
    "(Tensor, Tensor, Tensor, Tensor)",
    "ngp_march", (ctypes.c_void_p,) * 9 + (ctypes.c_longlong,)
    + (ctypes.c_int,) * 3 + (ctypes.c_double,) * 3,
    _march_fake, _march_op)


def march_rays(rays_o, rays_d, t_start, t_end, bitfield, *, cascades: int,
               scale: float, exp_step_factor: float, grid_size: int,
               sample_cap: int, n_candidates: int | None = None
               ) -> MarchResult:
    """March rays (N, 3) from ``t_start`` (< 0: a dead ray) to ``t_end``
    through the int32 bitfield, collecting at most ``sample_cap`` samples.

    ``n_candidates``: the probe window (default: a full AABB traversal).
    With one cascade, constant ``dt`` and no window, the cell-interval
    marcher runs: on CUDA rays the kernel (``csrc/ngp_march.cu``, each
    launch counted in ``_build.LAUNCHES``), on CPU rays the plain
    version."""
    if n_candidates is None and cascades == 1 and exp_step_factor == 0.0:
        if on_cuda(rays_o, "ngp-march"):
            return MarchResult(*torch.ops.taichi_nerfs_torch.ngp_march(
                rays_o.contiguous(), rays_d.contiguous(),
                t_start.contiguous(), t_end.contiguous(), bitfield, scale,
                grid_size, sample_cap))
        return _march_rays_intervals(
            rays_o, rays_d, t_start, t_end, bitfield, scale=scale,
            grid_size=grid_size, sample_cap=sample_cap,
        )
    if n_candidates is None:
        n_candidates = num_candidates(scale, exp_step_factor)
    K = n_candidates
    ts_cand, dts_cand = candidate_lattice(t_start, K, exp_step_factor,
                                          grid_size, scale)
    live = (t_start >= 0.0)[:, None] & (ts_cand < t_end[:, None])
    xyz = rays_o[:, None, :] + ts_cand[..., None] * rays_d[:, None, :]
    occ = occupancy_probe(xyz, dts_cand, bitfield, cascades, grid_size,
                          scale) & live
    k = torch.arange(K, dtype=torch.float32,
                     device=rays_o.device).expand_as(ts_cand)
    sel, total = _first_occupied(occ, k, sample_cap)
    counts = torch.clamp(total, max=sample_cap).to(torch.int32)
    valid = valid_mask(counts, sample_cap)
    # the selected samples' t and dt are recomputed from their index
    ts, deltas = lattice_at(t_start, sel, exp_step_factor, grid_size, scale)
    ts = torch.where(valid, ts, 0.0)
    deltas = torch.where(valid, deltas, 0.0)
    # resume after the S-th sample if the cap was hit, else after the
    # window (cut at the AABB exit)
    capped, t_after_cap = _resume_point(ts, deltas, counts, sample_cap)
    t_window_end = torch.minimum(ts_cand[:, -1] + dts_cand[:, -1], t_end)
    t_final = torch.where(capped, t_after_cap, t_window_end)
    t_final = torch.where(t_start >= 0.0, t_final, t_start)
    return MarchResult(ts=ts, deltas=deltas, counts=counts, t_final=t_final)


def perturb_t_start(hits_t: torch.Tensor, noise: torch.Tensor,
                    exp_step_factor: float, grid_size: int,
                    scale: float) -> torch.Tensor:
    """First sample moved by ``noise * dt``."""
    t1 = hits_t[:, 0]
    dt = calc_dt(t1, exp_step_factor, grid_size, scale)
    return torch.where(t1 >= 0.0, t1 + dt * noise, t1)


def sample_positions(rays_o, rays_d, ts):
    """(N, S) sample ``t``s -> (N, S, 3) positions."""
    return rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]


def valid_mask(counts: torch.Tensor, sample_cap: int) -> torch.Tensor:
    """(N,) counts -> (N, S) sample validity."""
    return (torch.arange(sample_cap, device=counts.device)[None, :]
            < counts[:, None])
