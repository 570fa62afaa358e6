"""Instant-NGP model pieces.  Only ``trunc_exp`` is ported so far.

Port of the JAX package's ``models/ngp.py:trunc_exp``; the hash-grid NGP
model itself is still to be ported (ROADMAP, "Modules to port", item 11).
"""

from __future__ import annotations

import torch


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


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
