"""Front-to-back volume compositing over the dense ``(N, S)`` sample grid.

Port of the JAX package's ``ops/composite.py``.  Transmittance is computed
in log space, ``T_s = exp(-sum_{k<s} sigma_k delta_k)``, and the early stop
is the contribution mask ``T > t_threshold``.  Gradients are plain autograd
of the cumulative sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompositeResult(NamedTuple):
    opacity: torch.Tensor  # (N,)
    depth: torch.Tensor  # (N,)
    rgb: torch.Tensor  # (N, 3)
    ws: torch.Tensor  # (N, S) per-sample weights
    vr_samples: torch.Tensor  # () contributing samples


def exclusive_transmittance(optical_depth: torch.Tensor) -> torch.Tensor:
    """``T_s = exp(-sum_{k<s} tau_k)`` along the last axis (T_0 = 1)."""
    acc = torch.cumsum(optical_depth, dim=-1)
    return torch.exp(-(acc - optical_depth))


def composite_train(sigmas, rgbs, deltas, ts, valid, t_threshold: float,
                    t_in: torch.Tensor | None = None) -> CompositeResult:
    """Composite sigmas (N, S), rgbs (N, S, 3) at intervals and positions
    (N, S) where ``valid``; ``t_in`` (N,) is an incoming transmittance
    (the test renderer resumes from ``1 - opacity``)."""
    tau = torch.where(valid, sigmas * deltas, 0.0)
    alpha = 1.0 - torch.exp(-tau)
    trans = exclusive_transmittance(tau)
    if t_in is not None:
        trans = trans * t_in[:, None]
    contrib = valid & (trans > t_threshold)
    w = torch.where(contrib, alpha * trans, 0.0)
    return CompositeResult(
        opacity=torch.sum(w, dim=-1),
        depth=torch.sum(w * ts, dim=-1),
        rgb=torch.sum(w[..., None] * rgbs, dim=-2),
        ws=w,
        vr_samples=torch.sum(contrib),
    )


def apply_background(rgb, opacity, rgb_bg):
    """Blend the background colour behind the composite."""
    return rgb + rgb_bg * (1.0 - opacity)[..., None]


def composite_test_round(sigmas, rgbs, deltas, ts, valid, t_threshold: float,
                         opacity, depth, rgb):
    """One round of the incremental test-time compositor: resume from
    ``1 - opacity``, accumulate; returns ``(opacity, depth, rgb,
    converged)`` with ``converged`` the per-ray ``T <= t_threshold``."""
    res = composite_train(sigmas, rgbs, deltas, ts, valid, t_threshold,
                          t_in=1.0 - opacity)
    opacity = opacity + res.opacity
    depth = depth + res.depth
    rgb = rgb + res.rgb
    return opacity, depth, rgb, (1.0 - opacity) <= t_threshold
