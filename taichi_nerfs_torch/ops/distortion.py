"""Mip-NeRF-360 distortion loss (the DVGO-v2 form) over the dense sample
grid.  Port of the JAX package's ``ops/distortion.py``; the gradient is
plain autograd of the cumulative sums."""

from __future__ import annotations

import torch


def distortion_loss(ws: torch.Tensor, deltas: torch.Tensor, ts: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Per-ray loss (N,) of weights, intervals and positions (N, S):
    ``sum_s 2 (wts_inc ws_exc - ws_inc wts_exc) + w^2 delta / 3``."""
    w = torch.where(valid, ws, 0.0)
    wt = w * ts
    ws_inc = torch.cumsum(w, dim=-1)
    wts_inc = torch.cumsum(wt, dim=-1)
    ws_exc = ws_inc - w
    wts_exc = wts_inc - wt
    per_sample = 2.0 * (wts_inc * ws_exc - ws_inc * wts_exc) + (
        1.0 / 3.0) * w * w * torch.where(valid, deltas, 0.0)
    return torch.sum(torch.where(valid, per_sample, 0.0), dim=-1)
