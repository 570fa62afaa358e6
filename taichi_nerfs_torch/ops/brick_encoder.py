"""Brick-layout multiresolution grid encoder (the flagship encoder).

Port of the JAX package's ``ops/brick_encoder.py``.  One flat table of
``(n_rows, 8F)`` rows, each the full 2x2x2xF corner block of one cell:

* dense levels (``res^3 <= 2**log2_rows``) keep a shared-corner grid
  ``(res+1)^3 x F`` as parameters;
* hashed levels keep brick rows as parameters, keyed by ``fast_hash(cell)
  % rows``.

The JAX ``custom_vjp`` becomes :class:`_BrickEncode`, whose backward returns
only the table gradient (positions come from the marcher and carry none).
With ``table_dtype="bfloat16"`` the table is read as bf16 (the products
widen to fp32) and the gradient stays fp32, as in the JAX code.

Two implementations of the one function:

* CUDA positions run the hand-written kernels of ``csrc/brick_encode.cu``
  (operators ``taichi_nerfs_torch::brick_encode_fwd`` / ``_bwd``): one
  gather a call, which reads the dense levels' corner grids and the hashed
  rows where they lie, and one scatter of the gradient straight back into
  them.  They take F in :data:`KERNEL_F` and up to :data:`MAX_LEVELS`
  levels, and raise on anything else: there is no fallback.
* CPU positions, and :func:`brick_encode_reference` on any device, run the
  plain version: the dense levels' bricks materialised by 8 shifted slices
  every call, the whole table gathered, and a backward of ``index_add_``
  scatters (one for all hashed levels, one a dense level) with the
  transposed 8-shift add into each corner grid.  Row indices and weights
  are computed for all levels at once; uint32 arithmetic (the hash
  multiplies wrap mod 2**32, the modulo is unsigned) is computed in int64
  with the hash encoder's
  :func:`~taichi_nerfs_torch.ops.hash_encoder.fast_hash`, bit-equal to JAX.
  The corner reduction is an fp32 sum over the corner axis, not a matmul.

Both compute the cells and weights in the same fp32 roundings; they differ
in the order of the 8-corner sum and of the gradient's sums.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from ..config import BrickGridConfig
from ..utils import profiling
from ._build import declare, on_cuda
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


def _plain_forward(corners, bricks, xyz, layout: BrickGridLayout):
    """The plain forward: (M, L F) features and the (M, L) int64 global
    rows they were gathered from."""
    M = xyz.shape[0]
    L, F = layout.levels, layout.F
    if layout.table_dtype == "bfloat16":
        corners, bricks = corners.bfloat16(), bricks.bfloat16()
    table = _full_brick_table(corners, bricks, layout)
    g, w8 = _cell_and_weights(xyz, layout)
    idx = _row_indices(g, layout)  # (M, L)
    rows = table[idx.reshape(-1)].reshape(M * L, 8, F)
    feats = torch.sum(rows * w8.reshape(M * L, 8, 1), dim=1)
    return feats.reshape(M, L * F), idx


def _plain_backward(idx, xyz, dout, layout: BrickGridLayout):
    """The plain table gradient ``(dcorners, dbricks)`` of the rows ``idx``
    that the forward gathered for positions ``xyz``."""
    M, L = xyz.shape[0], layout.levels
    F, W = layout.F, layout.row_width
    # the dense levels come first: resolutions grow with the level
    nd = sum(layout.dense)
    dev = dout.device
    dcorners = torch.zeros((layout.n_corner_params, F), dtype=torch.float32,
                           device=dev)
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
    return dcorners, dbricks


class _BrickEncodeReference(torch.autograd.Function):
    """The plain encoder on any device: (corners, bricks, xyz in [0, 1]^3
    (M, 3)) -> (M, L * F)."""

    @staticmethod
    def forward(ctx, corners, bricks, xyz, layout):
        feats, idx = _plain_forward(corners, bricks, xyz, layout)
        ctx.save_for_backward(idx, xyz)
        ctx.layout = layout
        return feats

    @staticmethod
    def backward(ctx, dout):
        idx, xyz = ctx.saved_tensors
        return (*_plain_backward(idx, xyz, dout, ctx.layout), None, None)


# ---- the kernels (csrc/brick_encode.cu) ----------------------------------

# the feature widths the kernels are built for, and the most levels a block
# holds (one warp a level)
KERNEL_F = (1, 2, 4, 8)
MAX_LEVELS = 16


@functools.lru_cache(maxsize=32)
def _kernel_levels(layout: BrickGridLayout):
    """The layout as the kernels take it: the fp32 scale of each level and,
    per level, (cells a side, hashed rows or 0 for a dense level, its first
    corner entry or brick row)."""
    info, hoff = [], 0
    for lv in range(layout.levels):
        if layout.dense[lv]:
            info += [layout.resolutions[lv], 0, layout.corner_offsets[lv]]
        else:
            info += [layout.resolutions[lv], layout.rows[lv], hoff]
            hoff += layout.rows[lv]
    return tuple(level_scales(layout).tolist()), tuple(info)


@functools.lru_cache(maxsize=32)
def _c_levels(scales, info):
    """The level table as C arrays (cached: a step passes the same one)."""
    return ((ctypes.c_float * len(scales))(*scales),
            (ctypes.c_longlong * len(info))(*info))


def _check_kernel_args(corners, bricks, xyz, feats, scales, info):
    """Raise unless the kernels take these: ``feats`` is the (M, L F)
    output (forward) or its cotangent (backward)."""
    L = len(scales)
    if not 1 <= L <= MAX_LEVELS or len(info) != 3 * L:
        raise ValueError(f"no brick-encode kernel for {L} levels (1 to "
                         f"{MAX_LEVELS}, 3 numbers each in info)")
    F = corners.shape[-1]
    if F not in KERNEL_F:
        raise ValueError(f"no brick-encode kernel for F={F} (built for "
                         f"{KERNEL_F})")
    M = xyz.shape[0]
    for name, t, shape in (("corners", corners, (corners.shape[0], F)),
                           ("bricks", bricks, (bricks.shape[0], 8 * F)),
                           ("xyz", xyz, (M, 3)),
                           ("features", feats, (M, L * F))):
        if t.dim() != 2 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != xyz.device:
            raise ValueError(f"{name} is on {t.device}, xyz on {xyz.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the brick-encode kernels "
                            "take float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for lv in range(L):
        res, rows, start = info[3 * lv : 3 * lv + 3]
        end, have = ((start + (res + 1) ** 3, corners.shape[0]) if rows == 0
                     else (start + rows, bricks.shape[0]))
        if res < 1 or rows < 0 or start < 0 or end > have:
            raise ValueError(f"level {lv} ({res}, {rows}, {start}) does not "
                             f"fit the tables")


def _fwd_fake(corners, bricks, xyz, scales, info, bf16):
    out = xyz.new_empty((xyz.shape[0], len(scales) * corners.shape[1]))
    _check_kernel_args(corners, bricks, xyz, out, scales, info)
    return out


def _fwd_op(launch, out, corners, bricks, xyz, scales, info, bf16):
    # the kernel reads the tables in 16-byte vectors
    if corners.data_ptr() % 16 or bricks.data_ptr() % 16:
        raise ValueError("the brick-encode kernel reads corners and bricks "
                         "16-byte aligned")
    if xyz.shape[0]:
        c_scales, c_info = _c_levels(tuple(scales), tuple(info))
        launch(xyz.device, xyz.data_ptr(), corners.data_ptr(),
               bricks.data_ptr(), out.data_ptr(), xyz.shape[0], len(scales),
               corners.shape[1], int(bf16), ctypes.addressof(c_scales),
               ctypes.addressof(c_info))


def _bwd_fake(dout, xyz, n_corners, n_bricks, scales, info):
    """The (n_corners, F) and (n_bricks, 8F) fp32 table gradients, zeroed
    (the kernel adds into them)."""
    F = dout.shape[1] // max(len(scales), 1)
    dcorners = torch.zeros((n_corners, F), dtype=torch.float32,
                           device=dout.device)
    dbricks = torch.zeros((n_bricks, 8 * F), dtype=torch.float32,
                          device=dout.device)
    _check_kernel_args(dcorners, dbricks, xyz, dout, scales, info)
    return dcorners, dbricks


def _bwd_op(launch, grads, dout, xyz, n_corners, n_bricks, scales, info):
    dcorners, dbricks = grads
    if xyz.shape[0]:
        c_scales, c_info = _c_levels(tuple(scales), tuple(info))
        launch(dout.device, dout.data_ptr(), xyz.data_ptr(),
               dcorners.data_ptr(), dbricks.data_ptr(), xyz.shape[0],
               len(scales), dcorners.shape[1], ctypes.addressof(c_scales),
               ctypes.addressof(c_info))


# C arguments: pointers (xyz, corners, bricks, out) / (dout, xyz, dcorners,
# dbricks), then M, L, F (and bf16, forward), then the level table
declare(
    "brick_encode_fwd(Tensor corners, Tensor bricks, Tensor xyz, "
    "float[] scales, int[] info, bool bf16) -> Tensor",
    "brick_encode", (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,)
    + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 2,
    _fwd_fake, _fwd_op, symbol="brick_encode_fwd")
declare(
    "brick_encode_bwd(Tensor dout, Tensor xyz, int n_corners, int n_bricks, "
    "float[] scales, int[] info) -> (Tensor, Tensor)",
    "brick_encode", (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,)
    + (ctypes.c_int,) * 2 + (ctypes.c_void_p,) * 2,
    _bwd_fake, _bwd_op, symbol="brick_encode_bwd")


class _BrickEncode(torch.autograd.Function):
    """(corners, bricks, xyz in [0, 1]^3 (M, 3)) -> (M, L * F): the kernels
    on CUDA tensors, the plain version on CPU tensors."""

    @staticmethod
    def forward(ctx, corners, bricks, xyz, layout):
        if not on_cuda(xyz, "brick-encode"):
            return _BrickEncodeReference.forward(ctx, corners, bricks, xyz,
                                                 layout)
        # the cells and weights are recomputed from xyz in the backward
        ctx.save_for_backward(xyz)
        ctx.layout = layout
        ctx.table_rows = (corners.shape[0], bricks.shape[0])
        return torch.ops.taichi_nerfs_torch.brick_encode_fwd(
            corners, bricks, xyz, *_kernel_levels(layout),
            layout.table_dtype == "bfloat16")

    @staticmethod
    def backward(ctx, dout):
        with profiling.span("ngp.encode"):
            if not on_cuda(dout, "brick-encode"):
                return _BrickEncodeReference.backward(ctx, dout)
            (xyz,) = ctx.saved_tensors
            dcorners, dbricks = torch.ops.taichi_nerfs_torch.brick_encode_bwd(
                dout.contiguous(), xyz, *ctx.table_rows,
                *_kernel_levels(ctx.layout))
            return dcorners, dbricks, None, None


def _flat_positions(xyz: torch.Tensor) -> torch.Tensor:
    return torch.clamp(xyz.reshape(-1, 3), 0.0, 1.0)


def brick_encode(params, xyz: torch.Tensor,
                 layout: BrickGridLayout) -> torch.Tensor:
    """Positions (..., 3) in [0, 1]^3 (clamped) -> (..., L * F).

    CUDA positions run ``csrc/brick_encode.cu`` (operators
    ``taichi_nerfs_torch::brick_encode_fwd`` / ``::brick_encode_bwd``, each
    launch counted in ``_build.LAUNCHES``) and raise where the kernels take
    no such layout or tensors; CPU positions run the plain version,
    :func:`brick_encode_reference`'s."""
    batch_shape = xyz.shape[:-1]
    out = _BrickEncode.apply(params["corners"], params["bricks"],
                             _flat_positions(xyz), layout)
    return out.reshape(*batch_shape, layout.out_dim)


def brick_encode_reference(params, xyz: torch.Tensor,
                           layout: BrickGridLayout) -> torch.Tensor:
    """:func:`brick_encode` in plain PyTorch on any device (the table
    materialised, a gather, an index-add backward)."""
    batch_shape = xyz.shape[:-1]
    out = _BrickEncodeReference.apply(params["corners"], params["bricks"],
                                      _flat_positions(xyz), layout)
    return out.reshape(*batch_shape, layout.out_dim)
