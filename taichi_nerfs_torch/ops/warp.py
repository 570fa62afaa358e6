"""Separable affine resampling as dense interpolation-matrix products.

Port of the JAX package's ``ops/warp.py``: the dense resample
(``interp_kernel``, ``interp_matrix``, ``resample_matmul``), the per-batch
one (``resample_matmul_batched``, a slab's two sigma sub-slabs) and the
windowed one (``resample_window``, ``resample_matmul_windowed``), with the
static window helpers ``residual_window`` and ``drift_window``.  The
roll-select ``resample_affine`` of the JAX module exists for TPU grid sizes
and is not carried.

The shear-warp renderer's final projective warp lives here too:
:func:`band_warp_reference`, the two-pass band-matrix warp of the JAX
renderer (dense (J, I, N) and (N, J, N') tent matrices, two batched
products), and :func:`band_warp`, which runs the hand-written kernel
``csrc/swr_warp.cu`` (operator ``taichi_nerfs_torch::swr_band_warp``) on a
CUDA frame that needs no gradient and the plain version otherwise.

Operand dtypes follow the JAX module: the interpolation weights take
``dtype`` if it is given, else ``x``'s dtype; products accumulate in fp32
and the result is fp32, cast to ``dtype`` only when it is given.  Every
resample runs as a plain fp32 ``torch.matmul`` of the operands (a product
of two bf16 values is exact in fp32, so bf16 operands give the JAX
``preferred_element_type=float32`` product); on CUDA that is full fp32 as
long as ``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's
default).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as nnf

from ._build import declare, on_cuda


def residual_window(
    step_min: float, step_max: float, out_len: int
) -> tuple[int, int]:
    """Static bounds of the residual drift ``floor(p_i) - origin - i`` of an
    affine resample whose step lies in ``[step_min, step_max]``: the drift
    is centred at the output midpoint, so it spans about
    ``+-|step - 1| * out_len / 2``."""
    hl = out_len // 2
    cands = [(s - 1.0) * (i - hl) for s in (step_min, step_max)
             for i in (0.0, float(out_len - 1))]
    return int(math.floor(min(cands))), int(math.floor(max(cands) + 1.0))


def drift_window(
    start_min: float, start_max: float, step_min: float, step_max: float,
    out_len: int,
) -> tuple[int, int]:
    """:func:`residual_window`; the ``start`` bounds do not matter (the
    origin split absorbs them)."""
    del start_min, start_max
    return residual_window(step_min, step_max, out_len)


def interp_kernel(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Resampling weight at signed source distance ``x``.

    "linear": the 2-tap tent (support 1).  "cubic": Catmull-Rom (a=-0.5,
    support 2).
    """
    ax = torch.abs(x)
    if kind == "linear":
        return torch.clamp(1.0 - ax, min=0.0)
    if kind != "cubic":
        raise ValueError(f"unknown resample kind {kind!r}")
    w1 = (1.5 * ax - 2.5) * ax * ax + 1.0
    w2 = ((-0.5 * ax + 2.5) * ax - 4.0) * ax + 2.0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(ax <= 1.0, w1, torch.where(ax < 2.0, w2, zero))


def interp_matrix(
    start: torch.Tensor | float,
    step: torch.Tensor | float,
    n: int,
    out_len: int,
    kind: str = "linear",
    device=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Dense (n, out_len) matrix ``W[m, i] = k(m - (start + i*step))``,
    computed in fp32 and cast to ``dtype``.

    ``out = x @ W`` reproduces the affine resample with zero padding
    outside the source.
    """
    if isinstance(start, torch.Tensor):
        device = start.device
    m = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(out_len, dtype=torch.float32, device=device)[None, :]
    pos = start + i * step
    return interp_kernel(m - pos, kind).to(dtype)


def _dot(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w`` with fp32 accumulation and an fp32 result, cast to
    ``dtype`` when it is given."""
    out = torch.matmul(x.float(), w.float())
    return out if dtype is None else out.to(dtype)


def resample_matmul(
    x: torch.Tensor,
    start: torch.Tensor | float,
    step: torch.Tensor | float,
    out_len: int,
    axis: int,
    kind: str = "linear",
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Affine 1D resample of ``x`` along ``axis`` as one matmul; weights in
    ``dtype or x.dtype``."""
    axis = axis % x.ndim
    w = interp_matrix(
        start, step, x.shape[axis], out_len, kind=kind, device=x.device,
        dtype=dtype or x.dtype,
    )
    # contract on the last axis, then put the new axis back in place
    out = _dot(torch.movedim(x, axis, -1), w, dtype)
    return torch.movedim(out, -1, axis)


def resample_matmul_batched(
    x: torch.Tensor,
    start: torch.Tensor,
    step: torch.Tensor,
    out_len: int,
    axis: int,
    kind: str = "linear",
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Affine 1D resample along ``axis`` with one affine map per leading
    batch entry: ``x`` is (B, ..., N, ...), ``start`` and ``step`` are (B,)
    and batch b uses its own interpolation matrix, in one batched matmul
    (a slab's two sigma sub-slabs lie on two world planes); weights in
    ``dtype or x.dtype``."""
    axis = axis % x.ndim
    if axis == 0:
        raise ValueError("axis 0 is the batch dimension")
    n = x.shape[axis]
    m = torch.arange(n, dtype=torch.float32, device=x.device)[None, :, None]
    i = torch.arange(out_len, dtype=torch.float32, device=x.device)
    pos = start[:, None, None] + i[None, None, :] * step[:, None, None]
    w = interp_kernel(m - pos, kind).to(dtype or x.dtype)  # (B, N, out_len)
    xm = torch.movedim(x, axis, -1)
    out = _dot(xm.reshape(x.shape[0], -1, n), w, dtype)
    out = out.reshape(*xm.shape[:-1], out_len)
    return torch.movedim(out, -1, axis)


def resample_window(
    step_abs_max: float, out_len: int, multiple: int = 32
) -> int:
    """Static source-window width covering an affine resample's support:
    ``(out_len - 1) * |step| + 2`` source cells (plus one), rounded up to a
    multiple so the width varies little across poses."""
    need = int(math.ceil((out_len - 1) * step_abs_max)) + 3
    return ((need + multiple - 1) // multiple) * multiple


def resample_matmul_windowed(
    x: torch.Tensor,
    start: torch.Tensor | float,
    step: torch.Tensor | float,
    out_len: int,
    axis: int,
    window: int,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Affine 1D linear resample as a window of the source, then one
    ``(window, out_len)`` matrix product; weights in ``dtype or x.dtype``.

    The window starts one cell below the support's low end (an offset
    computed on the device, so no host read) in the source zero-padded by
    ``window`` on both sides; positions outside it read as zero, which
    matches :func:`resample_matmul` only when ``window`` covers the support
    (:func:`resample_window`).  Falls back to the full matrix when
    ``window >= N``.  Linear tents only, as in the JAX module.
    """
    axis = axis % x.ndim
    n = x.shape[axis]
    if window >= n:
        return resample_matmul(x, start, step, out_len, axis, dtype=dtype)
    dev = x.device
    start = torch.as_tensor(start, dtype=torch.float32, device=dev)
    step = torch.as_tensor(step, dtype=torch.float32, device=dev)
    lo = torch.minimum(start, start + (out_len - 1) * step)
    origin = torch.floor(lo).to(torch.int64) - 1
    off = torch.clamp(origin + window, 0, n + window)
    xm = torch.movedim(x, axis, -1)
    xp = nnf.pad(xm, (window, window))
    idx = off + torch.arange(window, device=dev)
    xw = torch.index_select(xp, -1, idx)
    w = interp_matrix(start - (off - window).to(torch.float32), step,
                      window, out_len, dtype=dtype or x.dtype)
    return torch.movedim(_dot(xw, w, dtype), -1, axis)


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the operand ``dtype``, kept fp32 (a matmul of such
    operands is the JAX fp32-accumulated product)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def band_warp_reference(img, lj, behind, pose, K, frame, axis, warp,
                        rs_dtype=torch.float32):
    """Plain two-pass (Catmull-Smith) warp of the global frame to pixels,
    as batched band-matrix products.

    ``img`` is the (C, nq, nq) global frame on its lattice, ``lj`` the
    (H, W) lattice j coordinate of each pixel's ray and ``behind`` (H, W)
    the pixels whose ray misses the frame's plane (zeroed); ``pose`` (3, 4)
    and ``K`` (3, 3) the camera, ``frame`` the global frame's plane and
    lattice ``(z_g, g_b0, g_db, g_c0, g_dc)`` (0-d tensors) and ``axis``
    the sweep axis.  Pass A solves each lattice row j for one camera-plane
    coordinate ("matmul": y, per column u; "matmul_x": x, per row v), pass
    B resamples along j.  Both passes use linear tents; with a bf16
    ``rs_dtype`` the tents and both passes' operands are rounded to bf16,
    the sums fp32.  Returns the (C, H, W) fp32 pixels.
    """
    z_g, g_b0, g_db, g_c0, g_dc = frame
    f32, dev = torch.float32, img.device
    nq = img.shape[1]
    h_img, w_img = lj.shape
    b_axis, c_axis = [d for d in range(3) if d != axis]
    o = pose[:, 3]
    o_a, o_b, o_c = o[axis], o[b_axis], o[c_axis]
    r = pose[:, :3]  # world = r @ cam
    ra, rb, rc = r[axis], r[b_axis], r[c_axis]
    xs_pix = (torch.arange(w_img, dtype=f32, device=dev) - K[0, 2]
              + 0.5) / K[0, 0]
    ys_pix = (torch.arange(h_img, dtype=f32, device=dev) - K[1, 2]
              + 0.5) / K[1, 1]
    j_ar = torch.arange(nq, dtype=f32, device=dev)
    oa_rel = o_a - z_g
    gam = o_c - g_c0 - j_ar * g_dc  # (J,)
    if warp == "matmul_x":
        fidx, sidx, free = 1, 0, ys_pix
    else:
        fidx, sidx, free = 0, 1, xs_pix
    num = (oa_rel * rc[fidx] - gam[:, None] * ra[fidx]) * free[
        None, :
    ] + (oa_rel * rc[2] - gam[:, None] * ra[2])  # (J, N)
    den = (
        gam[:, None] * ra[sidx] - oa_rel * rc[sidx]
        + torch.zeros_like(num)
    )
    sol = num / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    if warp == "matmul_x":
        x_p, y_p = sol, free[None, :] + torch.zeros_like(sol)
    else:
        x_p, y_p = free[None, :] + torch.zeros_like(sol), sol
    da_j = ra[0] * x_p + ra[1] * y_p + ra[2]  # (J, N)
    db_j = rb[0] * x_p + rb[1] * y_p + rb[2]
    posA = ((o_b - g_b0) * da_j - oa_rel * db_j) / (
        g_db * torch.where(torch.abs(da_j) < 1e-12, 1e-12, da_j)
    )  # (J, N): source-i position for (row j, output line n)
    posA = torch.where(torch.isfinite(posA), posA, -1e9)
    i_ar = torch.arange(nq, dtype=f32, device=dev)
    WA = _round_to(torch.clamp(
        1.0 - torch.abs(i_ar[None, :, None] - posA[:, None, :]), min=0.0
    ), rs_dtype)  # (J, I, N)
    # inter[j, c, n] = sum_i img[c, i, j] * WA[j, i, n]
    inter = torch.bmm(_round_to(img.permute(2, 0, 1), rs_dtype),
                      WA)  # (J, C, N)
    posB = lj if warp == "matmul_x" else lj.T  # (N', N)
    posB = torch.where(torch.isfinite(posB), posB, -1e9)
    WB = _round_to(torch.clamp(
        1.0 - torch.abs(j_ar[None, :, None] - posB[:, None, :]), min=0.0
    ), rs_dtype)  # (N, J, N')
    # pixT[n, c, n'] = sum_j inter[j, c, n] * WB[n, j, n']
    pixT = torch.bmm(_round_to(inter.permute(2, 1, 0), rs_dtype),
                     WB)  # (N, C, N')
    if warp == "matmul_x":
        pix = pixT.permute(1, 0, 2)  # (C, H, W)
    else:
        pix = pixT.permute(1, 2, 0)  # (C, H, W)
    return torch.where(behind[None], 0.0, pix)


_WARPS = {"matmul": 0, "matmul_x": 1}
_OP_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's per-frame scalars: pose (3, 4) and K (3, 3) row-major, then
# (z_g, g_b0, g_db, g_c0, g_dc)
GEO_LEN = 12 + 9 + 5


def _check_band_warp_args(img, lj, behind, geo, axis, warp, dtype):
    if warp not in _WARPS:
        raise ValueError(f"no band-warp kernel for warp {warp!r}")
    if dtype not in _OP_DTYPES:
        raise TypeError(f"resample operand dtype {dtype}: float32 or "
                        "bfloat16 only")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis {axis} is not 0, 1 or 2")
    if img.dim() != 3 or img.shape[1] != img.shape[2]:
        raise ValueError(f"img must be (C, nq, nq), got {tuple(img.shape)}")
    if lj.dim() != 2 or tuple(behind.shape) != tuple(lj.shape):
        raise ValueError(f"lj {tuple(lj.shape)} and behind "
                         f"{tuple(behind.shape)} must be one (H, W)")
    if tuple(geo.shape) != (GEO_LEN,):
        raise ValueError(f"geo shape {tuple(geo.shape)} != ({GEO_LEN},)")
    if min(*img.shape, *lj.shape) <= 0:
        raise ValueError("empty band warp")
    for name, t, want in (("img", img, torch.float32),
                          ("lj", lj, torch.float32),
                          ("behind", behind, torch.bool),
                          ("geo", geo, torch.float32)):
        if t.device != img.device:
            raise ValueError(f"{name} is on {t.device}, img on {img.device}")
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}; the band-warp kernel "
                            f"takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _band_warp_fake(img, lj, behind, geo, axis, warp, dtype):
    _check_band_warp_args(img, lj, behind, geo, axis, warp, dtype)
    return img.new_empty((img.shape[0], *lj.shape), dtype=torch.float32)


def _band_warp_op(launch, out, img, lj, behind, geo, axis, warp, dtype):
    (h, w), (c, nq) = lj.shape, img.shape[:2]
    launch(img.device, img.data_ptr(), lj.data_ptr(), behind.data_ptr(),
           geo.data_ptr(), out.data_ptr(), c, nq, h, w, axis, _WARPS[warp],
           _OP_DTYPES[dtype])


# C arguments: pointers (img, lj, behind, geo, out), then (C, nq, H, W,
# axis, warp, operand dtype)
declare(
    "swr_band_warp(Tensor img, Tensor lj, Tensor behind, Tensor geo, "
    "int axis, str warp, ScalarType dtype) -> Tensor",
    "swr_warp", (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7,
    _band_warp_fake, _band_warp_op)


def band_warp(img, lj, behind, pose, K, frame, axis, warp,
              rs_dtype=torch.float32):
    """The band-matrix warp of :func:`band_warp_reference` ("matmul" or
    "matmul_x"), (C, H, W) fp32 pixels.

    A CUDA frame that needs no gradient (``img`` does not require grad:
    every served frame) runs
    ``csrc/swr_warp.cu`` on the current stream through the operator
    ``taichi_nerfs_torch::swr_band_warp``, counted in
    ``_build.LAUNCHES``: only the two nonzero tents of each pass, with
    the per-frame scalars packed into one small device tensor (no host
    read).  The kernel has no backward: a frame under autograd (a training
    step) and a CPU frame run :func:`band_warp_reference`.
    """
    if img.requires_grad or not on_cuda(img, "band-warp"):
        return band_warp_reference(img, lj, behind, pose, K, frame, axis,
                                   warp, rs_dtype)
    geo = torch.cat([pose.reshape(-1), K.reshape(-1),
                     *(x.reshape(1) for x in frame)])
    return torch.ops.taichi_nerfs_torch.swr_band_warp(
        img, lj, behind, geo, axis, warp, rs_dtype)
