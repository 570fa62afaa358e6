"""Separable affine resampling as dense interpolation-matrix products.

Port of the JAX package's ``ops/warp.py`` (``interp_kernel``,
``interp_matrix``, ``resample_matmul``).  The roll-select and windowed
variants of the JAX module exist for TPU grid sizes and are not carried.

Operands are fp32.  ``resample_matmul`` runs as a plain fp32
``torch.matmul``; on CUDA that is full fp32 as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default).
"""

from __future__ import annotations

import torch


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
) -> torch.Tensor:
    """Dense (n, out_len) fp32 matrix ``W[m, i] = k(m - (start + i*step))``.

    ``out = x @ W`` reproduces the affine resample with zero padding
    outside the source.
    """
    if isinstance(start, torch.Tensor):
        device = start.device
    m = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(out_len, dtype=torch.float32, device=device)[None, :]
    pos = start + i * step
    return interp_kernel(m - pos, kind)


def resample_matmul(
    x: torch.Tensor,
    start: torch.Tensor | float,
    step: torch.Tensor | float,
    out_len: int,
    axis: int,
    kind: str = "linear",
) -> torch.Tensor:
    """Affine 1D resample of fp32 ``x`` along ``axis`` as one matmul."""
    axis = axis % x.ndim
    w = interp_matrix(
        start, step, x.shape[axis], out_len, kind=kind, device=x.device
    )
    # contract on the last axis, then put the new axis back in place
    out = torch.matmul(torch.movedim(x, axis, -1), w)
    return torch.movedim(out, -1, axis)
