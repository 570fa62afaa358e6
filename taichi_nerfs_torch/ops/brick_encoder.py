"""Brick-layout multiresolution grid encoder (the flagship encoder).

Port of the JAX package's ``ops/brick_encoder.py``.  One flat table of
``(n_rows, 8F)`` rows, each the full 2x2x2xF corner block of one cell:

* dense levels (``res^3 <= 2**log2_rows``) keep a shared-corner grid
  ``(res+1)^3 x F`` as parameters; their bricks are materialised from it by
  8 shifted slices every call, and the gradient comes back through the
  transposed shifts;
* hashed levels keep brick rows as parameters, keyed by ``fast_hash(cell)
  % rows``.

uint32 arithmetic: the hash multiplies wrap mod 2**32 and the modulo is
unsigned; the port computes them in int64 with the hash encoder's
:func:`~taichi_nerfs_torch.ops.hash_encoder.fast_hash`, bit-equal to JAX.

The JAX ``custom_vjp`` becomes :class:`_BrickEncode`, whose backward returns
only the table gradient (positions come from the marcher and carry none):
a scatter-add (``index_add_``) of the weighted output cotangent into the
rows, one for all hashed levels and one a dense level, and for dense levels
the transposed 8-shift add into the corner grid.  Row indices and weights
are computed for all levels at once (few launches a call: the step is
short enough that the host's issue rate matters).  With
``table_dtype="bfloat16"`` the parameters are cast to bf16 inside the
function (the gather reads bf16, the products widen to fp32) and the
gradient stays fp32, as in the JAX code.  The corner
reduction is an fp32 sum over the corner axis, not a matmul.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from ..config import BrickGridConfig
from ..utils import profiling
from .hash_encoder import fast_hash, level_scales, linear_index
from .math import as_u32


@dataclasses.dataclass(frozen=True)
class BrickGridLayout:
    levels: int
    F: int
    base_res: float
    log_b: float
    resolutions: Tuple[int, ...]  # cell-grid resolution per level
    rows: Tuple[int, ...]  # brick rows per level
    offsets: Tuple[int, ...]  # level start row in the flat brick table
    dense: Tuple[bool, ...]
    corner_res: Tuple[int, ...]  # dense levels: res + 1, else 0
    corner_offsets: Tuple[int, ...]  # dense levels: first corner, else -1
    n_corner_params: int
    n_rows: int
    table_dtype: str = "float32"

    @property
    def out_dim(self) -> int:
        return self.levels * self.F

    @property
    def row_width(self) -> int:
        return 8 * self.F

    @property
    def hashed_rows(self) -> int:
        return sum(r for r, d in zip(self.rows, self.dense) if not d)


def build_brick_layout(cfg: BrickGridConfig) -> BrickGridLayout:
    rows_cap = 2**cfg.log2_rows
    resolutions: List[int] = []
    rows: List[int] = []
    offsets: List[int] = []
    dense: List[bool] = []
    corner_res: List[int] = []
    corner_offsets: List[int] = []
    row_off = 0
    corner_off = 0
    for i in range(cfg.levels):
        res = int(
            np.ceil(float(cfg.base_res) * np.exp(i * cfg.log_b) - 1.0) + 1
        )
        is_dense = res**3 <= rows_cap
        resolutions.append(res)
        rows.append(res**3 if is_dense else rows_cap)
        offsets.append(row_off)
        dense.append(is_dense)
        row_off += rows[-1]
        if is_dense:
            corner_res.append(res + 1)
            corner_offsets.append(corner_off)
            corner_off += (res + 1) ** 3
        else:
            corner_res.append(0)
            corner_offsets.append(-1)
    return BrickGridLayout(
        levels=cfg.levels,
        F=cfg.feature_per_level,
        base_res=float(cfg.base_res),
        log_b=cfg.log_b,
        resolutions=tuple(resolutions),
        rows=tuple(rows),
        offsets=tuple(offsets),
        dense=tuple(dense),
        corner_res=tuple(corner_res),
        corner_offsets=tuple(corner_offsets),
        n_corner_params=corner_off,
        n_rows=row_off,
        table_dtype=cfg.table_dtype,
    )


def init_brick_params(layout: BrickGridLayout,
                      generator: torch.Generator | None = None, device=None):
    """``{"corners": (n_corner_params, F), "bricks": (hashed rows, 8F)}``,
    U[0, 1)."""
    corners = torch.rand((layout.n_corner_params, layout.F),
                         generator=generator, device=device)
    bricks = torch.rand((max(layout.hashed_rows, 1), layout.row_width),
                        generator=generator, device=device)
    return {"corners": corners, "bricks": bricks}


def _materialize_dense_bricks(corners: torch.Tensor,
                              layout: BrickGridLayout) -> List[torch.Tensor]:
    """Dense levels: ``brick[g, cz*4 + cy*2 + cx] = corner[g + (cx, cy,
    cz)]`` from 8 shifted slices of the corner grid."""
    out = []
    for lv in range(layout.levels):
        if not layout.dense[lv]:
            continue
        res = layout.resolutions[lv]
        cres = layout.corner_res[lv]
        off = layout.corner_offsets[lv]
        grid = corners[off : off + cres**3].reshape(cres, cres, cres,
                                                     layout.F)
        shifts = [grid[cz : cz + res, cy : cy + res, cx : cx + res]
                  for cz in (0, 1) for cy in (0, 1) for cx in (0, 1)]
        b = torch.stack(shifts, dim=3)  # (res, res, res, 8, F), x fastest
        out.append(b.reshape(res**3, 8 * layout.F))
    return out


def _full_brick_table(corners, bricks, layout: BrickGridLayout):
    """The flat ``(n_rows, 8F)`` gather target, in level order."""
    dense_bricks = iter(_materialize_dense_bricks(corners, layout))
    parts = []
    hoff = 0
    for lv in range(layout.levels):
        if layout.dense[lv]:
            parts.append(next(dense_bricks))
        else:
            parts.append(bricks[hoff : hoff + layout.rows[lv]])
            hoff += layout.rows[lv]
    return torch.cat(parts, dim=0)


def _corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """(..., 3) in-cell fractions -> (..., 8) trilinear weights, corner
    c = cx + 2 cy + 4 cz, each the product (wz * wy) * wx."""
    wx = torch.stack([1.0 - frac[..., 0], frac[..., 0]], dim=-1)
    wy = torch.stack([1.0 - frac[..., 1], frac[..., 1]], dim=-1)
    wz = torch.stack([1.0 - frac[..., 2], frac[..., 2]], dim=-1)
    w = (wz[..., :, None, None] * wy[..., None, :, None]
         * wx[..., None, None, :])
    return w.reshape(*frac.shape[:-1], 8)


def _cell_and_weights(xyz: torch.Tensor, layout: BrickGridLayout):
    """(M, L, 3) int32 cell coords and (M, L, 8) weights; ``pos = x *
    (base * e^(l log_b) - 1) + 0.5``."""
    scales = level_scales(layout, xyz.device)
    pos = xyz[:, None, :] * scales[None, :, None] + 0.5
    g = torch.floor(pos)
    return g.to(torch.int32), _corner_weights(pos - g)


@functools.lru_cache(maxsize=32)
def _level_columns(layout: BrickGridLayout, device=None):
    """Per level, on ``device``: resolution, hashed rows, first row and
    whether the level is dense, each (L,) to broadcast over (M, L)."""

    def col(vals, dtype=torch.int64):
        return torch.tensor(vals, dtype=dtype, device=device)

    return (col(layout.resolutions), col(layout.rows), col(layout.offsets),
            col(layout.dense, torch.bool))


def _row_indices(g: torch.Tensor, layout: BrickGridLayout) -> torch.Tensor:
    """(M, L, 3) cell coords -> (M, L) int64 global brick rows: dense
    levels the cell's linear index, hashed ones its hash mod the rows, all
    levels at once."""
    res, rows, offsets, dense = _level_columns(layout, g.device)
    c = as_u32(g)
    lin = linear_index(c[..., 0], c[..., 1], c[..., 2], res)
    hashed = fast_hash(c[..., 0], c[..., 1], c[..., 2]) % rows
    return torch.where(dense, lin, hashed) + offsets


class _BrickEncode(torch.autograd.Function):
    """(corners, bricks, xyz in [0, 1]^3 (M, 3)) -> (M, L * F)."""

    @staticmethod
    def forward(ctx, corners, bricks, xyz, layout):
        M = xyz.shape[0]
        L, F = layout.levels, layout.F
        if layout.table_dtype == "bfloat16":
            corners, bricks = corners.bfloat16(), bricks.bfloat16()
        table = _full_brick_table(corners, bricks, layout)
        g, w8 = _cell_and_weights(xyz, layout)
        idx = _row_indices(g, layout)  # (M, L)
        rows = table[idx.reshape(-1)].reshape(M * L, 8, F)
        feats = torch.sum(rows * w8.reshape(M * L, 8, 1), dim=1)
        ctx.save_for_backward(idx, xyz)
        ctx.layout = layout
        return feats.reshape(M, L * F)

    @staticmethod
    def backward(ctx, dout):
        with profiling.span("ngp.encode"):
            idx, xyz = ctx.saved_tensors
            layout = ctx.layout
            M, L = xyz.shape[0], layout.levels
            F, W = layout.F, layout.row_width
            # the dense levels come first: resolutions grow with the level
            nd = sum(layout.dense)
            dev = dout.device
            dcorners = torch.zeros((layout.n_corner_params, F),
                                   dtype=torch.float32, device=dev)
            dbricks = torch.zeros((max(layout.hashed_rows, 1), W),
                                  dtype=torch.float32, device=dev)
            # the weights are recomputed from xyz, as the JAX backward does
            _, w8 = _cell_and_weights(xyz, layout)  # (M, L, 8)
            # rows are corner-major: d(row)[c*F + f] = dout[lv*F + f] w8[c]
            d4 = dout.reshape(M, L, 1, F)
            if nd < L:
                dbricks.index_add_(
                    0, (idx[:, nd:] - layout.offsets[nd]).reshape(-1),
                    (w8[:, nd:, :, None] * d4[:, nd:]).reshape(-1, W))
            for lv in range(nd):
                res = layout.resolutions[lv]
                cres = layout.corner_res[lv]
                coff = layout.corner_offsets[lv]
                d_lv = torch.zeros((layout.rows[lv], W), dtype=torch.float32,
                                   device=dev)
                dw = w8[:, lv, :, None] * d4[:, lv]
                d_lv.index_add_(0, idx[:, lv] - layout.offsets[lv],
                                dw.reshape(-1, W))
                db = d_lv.reshape(res, res, res, 8, F)
                dc = dcorners[coff : coff + cres**3].view(cres, cres, cres, F)
                ci = 0
                for cz in (0, 1):
                    for cy in (0, 1):
                        for cx in (0, 1):
                            dc[cz : cz + res, cy : cy + res,
                               cx : cx + res] += db[:, :, :, ci]
                            ci += 1
            return dcorners, dbricks, None, None


def brick_encode(params, xyz: torch.Tensor,
                 layout: BrickGridLayout) -> torch.Tensor:
    """Positions (..., 3) in [0, 1]^3 (clamped) -> (..., L * F)."""
    batch_shape = xyz.shape[:-1]
    flat = torch.clamp(xyz.reshape(-1, 3), 0.0, 1.0)
    out = _BrickEncode.apply(params["corners"], params["bricks"], flat,
                             layout)
    return out.reshape(*batch_shape, layout.out_dim)
