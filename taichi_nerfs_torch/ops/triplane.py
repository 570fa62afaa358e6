"""Tri-plane positional encoder.

Port of the JAX package's ``ops/triplane.py``: three axis-aligned feature
planes (XY, YZ, ZX) in one table of shape ``(3, max_res**2, F)``; per
(sample, level) a bilinear 4-corner gather on each plane, with the corner
coordinates upscaled into ``max_res`` indexing, and the elementwise
product of the three planes' features.  The output is feature-major,
``out[..., j * levels + level]``, unlike the hash encoder's level-major
layout.

Outside the unit cube the JAX function's behaviour is kept: a corner below
0 is clamped to cell 0 (the JAX uint32 cast takes a negative float to 0),
and a corner whose flat index is ``>= max_res**2`` reads NaN (``jnp.take``
fills an out-of-range index with NaN).  No index is ever out of range here:
such corners gather row 0 and are then set to NaN.

One ``index_select`` per level gathers the 4 corners of the 3 planes; its
backward is a scatter-add into the table.
"""

from __future__ import annotations

import math

import torch

from ..config import TriPlaneConfig


def init_triplane_table(cfg: TriPlaneConfig,
                        generator: torch.Generator | None = None,
                        device=None) -> torch.Tensor:
    """U[0, 1) table of shape (3, max_res**2, F)."""
    return torch.rand((3, cfg.max_res**2, cfg.feature_per_level),
                      generator=generator, dtype=torch.float32,
                      device=device)


def triplane_encode(table: torch.Tensor, xyz: torch.Tensor,
                    cfg: TriPlaneConfig) -> torch.Tensor:
    """Positions (..., 3) normalized to [0, 1] -> features
    (..., levels * F), feature-major."""
    max_res = cfg.max_res
    n_rows = max_res**2
    F = table.shape[-1]
    lead = xyz.shape[:-1]
    x = xyz.reshape(-1, 3)
    # plane uv coords: XY, YZ, ZX
    uv = torch.stack([torch.stack([x[:, a], x[:, b]], dim=-1)
                      for a, b in ((0, 1), (1, 2), (2, 0))], dim=1)
    flat = table.reshape(3 * n_rows, F)
    plane_base = torch.arange(3, device=table.device) * n_rows  # (3,)

    per_level = []
    for level in range(cfg.levels):
        scale = cfg.base_res * math.exp(level * cfg.log_b) - 1.0
        res = int(math.ceil(scale)) + 1

        pos = uv * float(res - 1) + 0.5  # (N, 3, 2)
        pos_grid = torch.floor(pos)
        frac = pos - pos_grid
        pos_grid = pos_grid.clamp_min(0).to(torch.int64)

        idx, weights = [], []
        for corner in range(4):
            sel = [(corner >> d) & 1 for d in range(2)]
            w = None
            for d in range(2):
                f = frac[..., d] if sel[d] else 1.0 - frac[..., d]
                w = f if w is None else w * f
            # upscale corner coords into max_res indexing
            cu, cv = (((pos_grid[..., d] + sel[d]).float() / res
                       * (max_res - 1)).to(torch.int64) for d in range(2))
            idx.append(cu + cv * max_res)  # (N, 3)
            weights.append(w)
        idx = torch.stack(idx)  # (4, N, 3)
        outside = idx >= n_rows
        rows = torch.where(outside, 0, idx) + plane_base
        feats = flat.index_select(0, rows.reshape(-1)).view(*idx.shape, F)
        feats = feats.masked_fill(outside[..., None], float("nan"))
        acc = None  # (N, 3, F) per-plane bilinear features
        for corner in range(4):
            term = weights[corner][..., None] * feats[corner]
            acc = term if acc is None else acc + term
        per_level.append(acc[:, 0] * acc[:, 1] * acc[:, 2])  # (N, F)

    # (N, levels, F) -> feature-major (N, F, levels) -> flat
    out = torch.stack(per_level, dim=-2).transpose(-1, -2)
    return out.reshape(*lead, cfg.levels * F)
