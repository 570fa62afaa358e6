"""Separable affine resampling as dense interpolation-matrix products.

Port of the JAX package's ``ops/warp.py``: the dense resample
(``interp_kernel``, ``interp_matrix``, ``resample_matmul``), the per-batch
one (``resample_matmul_batched``, a slab's two sigma sub-slabs) and the
windowed one (``resample_window``, ``resample_matmul_windowed``), with the
static window helpers ``residual_window`` and ``drift_window``.  The
roll-select ``resample_affine`` of the JAX module exists for TPU grid sizes
and is not carried.

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

import math

import torch
import torch.nn.functional as nnf


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
