"""Multiresolution hash-grid encoder (the reference's Instant-NGP layout).

Port of the JAX package's ``ops/hash_encoder.py``: the same level sizing,
the same spatial hash (primes 1 / 2654435761 / 805459861) and linear index
for dense levels, and the same U[0, 1) table.  The table is ``(F,
n_entries)``, feature-major, as the JAX code uses it.

Two implementations of the one function, :func:`hash_encode`:

* CUDA positions run the hand-written kernels of ``csrc/hash_encode.cu``
  (operators ``taichi_nerfs_torch::hash_encode_fwd`` / ``_bwd``): one
  gather a call, which computes each position's cells, table entries and
  weights in registers and reads its corners where they lie in the table,
  and one scatter of the gradient, recomputed from the saved positions,
  into entry-major fp32 sums that the same C entry's second kernel
  transposes into the (F, n_entries) gradient (counted in
  ``_build.LAUNCHES`` as ``hash_encode_bwd_transpose``).
  They take F in :data:`KERNEL_F`, up to :data:`MAX_LEVELS` levels, a
  contiguous fp32 or bf16 table, and raise on anything else: there is no
  fallback.  Each call reads the layout's levels and the primes
  (:data:`_PRIMES`) it is given at call time.
* CPU positions, and :func:`hash_encode_reference` on any device, run the
  plain version below: int64 ``(M, L, 8)`` indices and fp32 weights from
  :func:`hash_indices`, a gather and an ``index_add_`` backward.

uint32 arithmetic.  Cell coordinates become uint32 (a negative int32
coordinate wraps), the hash multiplies wrap mod 2**32 and ``h % map_size``
is unsigned; the plain version computes all of it in int64 with
:func:`~taichi_nerfs_torch.ops.math.mul_u32`, bit-equal to JAX, and the
kernels in uint32.  Both compute the cells, entries and weights in the same
fp32 roundings; they differ in the order of the 8-corner sum and of the
gradient's sums.

The corner reduction is an fp32 sum over the corner axis (the JAX code
runs it as a selector matmul at HIGHEST precision, which TF32 would round).

Gradient.  The plain version's one autograd Function (:class:`_Gather`)
gathers fp32 and bf16 tables alike: the entries widened to fp32 (exactly),
and in the backward an fp32 ``index_add_`` of the 8 corners' cotangents,
cast once to the table's dtype; the kernels' backward adds in fp32 and
rounds once too.  Both backwards run inside the span ``ngp.encode`` on the
thread that runs them.  For an fp32 table that is autograd's scatter-add of
the gather with the sums in another order; for a bf16 table it is the
semantics of the JAX package's packed-pair gather ``_gather_pair_bf16``,
whose packing serves the TPU's instruction rate, which the port does not
need.  The port does this for every F (the JAX package only for F == 2; for
other F its bf16 scatter accumulates in bf16).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Tuple

import numpy as np
import torch

from ..config import HashGridConfig
from ..utils import profiling
from ._build import LAUNCHES, declare, on_cuda
from .math import U32, as_u32, mul_u32

_PRIMES = (1, 2654435761, 805459861)


def _align_to(x: int, y: int) -> int:
    return int((x + y - 1) // y) * y


def _res_in_level(level: int, base_res: float, log_b: float) -> int:
    return int(np.ceil(float(base_res) * np.exp(level * log_b) - 1.0)) + 1


@dataclasses.dataclass(frozen=True)
class HashGridLayout:
    """Static level geometry derived from a :class:`HashGridConfig`."""

    levels: int
    feature_per_level: int
    base_res: float
    log_b: float
    resolutions: Tuple[int, ...]
    map_sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    begin_fast_hash_level: int
    n_entries: int
    table_dtype: str = "float32"

    @property
    def out_dim(self) -> int:
        return self.levels * self.feature_per_level


def build_layout(cfg: HashGridConfig) -> HashGridLayout:
    """Per level: ``align_to(res^3, 8)`` entries, capped at ``2**log2_T``;
    levels from the first capped one on are hashed."""
    max_params = 2**cfg.log2_T
    offsets: List[int] = []
    map_sizes: List[int] = []
    resolutions: List[int] = []
    offset = 0
    begin_fast_hash_level = cfg.levels
    for i in range(cfg.levels):
        res = _res_in_level(i, cfg.base_res, cfg.log_b)
        full_size = res**3
        params_size = min(max_params, _align_to(full_size, 8))
        offsets.append(offset)
        map_sizes.append(params_size)
        resolutions.append(res)
        if full_size > params_size and begin_fast_hash_level == cfg.levels:
            begin_fast_hash_level = i
        offset += params_size
    return HashGridLayout(
        levels=cfg.levels,
        feature_per_level=cfg.feature_per_level,
        base_res=float(cfg.base_res),
        log_b=cfg.log_b,
        resolutions=tuple(resolutions),
        map_sizes=tuple(map_sizes),
        offsets=tuple(offsets),
        begin_fast_hash_level=begin_fast_hash_level,
        n_entries=offset,
        table_dtype=cfg.table_dtype,
    )


def init_hash_table(layout: HashGridLayout,
                    generator: torch.Generator | None = None,
                    device=None) -> torch.Tensor:
    """U[0, 1) table of shape (F, n_entries)."""
    return torch.rand((layout.feature_per_level, layout.n_entries),
                      generator=generator, dtype=torch.float32,
                      device=device)


class _Gather(torch.autograd.Function):
    """``table[:, idx]`` of an fp32 or bf16 table, as fp32.  Backward: the
    scatter-add accumulates in fp32, inside ``ngp.encode``; the sum is cast
    to the table's dtype once."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = table.shape[1], table.dtype
        return table[:, idx].float()

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        F = g.shape[0]
        with profiling.span("ngp.encode"):
            acc = torch.zeros((F, ctx.n), dtype=torch.float32,
                              device=g.device)
            acc.index_add_(1, idx.reshape(-1), g.reshape(F, -1))
            return acc.to(ctx.dtype), None


def fast_hash(cx: torch.Tensor, cy: torch.Tensor,
              cz: torch.Tensor) -> torch.Tensor:
    """The XOR-multiply spatial hash of uint32 cell coordinates (int64
    tensors holding uint32 values), mod 2**32."""
    return (mul_u32(cx, _PRIMES[0]) ^ mul_u32(cy, _PRIMES[1])
            ^ mul_u32(cz, _PRIMES[2]))


def linear_index(cx, cy, cz, res) -> torch.Tensor:
    """``cx + cy res + cz res^2`` in uint32 arithmetic (a wrapped negative
    coordinate wraps the index as in the JAX code)."""
    return (cx + cy * res + ((cz * res) & U32) * res) & U32


@functools.lru_cache(maxsize=32)
def level_scales(layout, device=None) -> torch.Tensor:
    """fp32 ``base_res * exp(l * log_b) - 1`` per level (host doubles
    rounded once, as the JAX code builds them).  Cached per layout and
    device, so a step makes no host-to-device copy."""
    return torch.tensor(
        [layout.base_res * math.exp(lv * layout.log_b) - 1.0
         for lv in range(layout.levels)],
        dtype=torch.float32, device=device,
    )


@functools.lru_cache(maxsize=32)
def _level_tables(layout: HashGridLayout, device=None):
    """Per-level constants on ``device``, shaped to broadcast over (M, L,
    8): resolution, hashed-or-linear, table size and offset; and the
    corner bits (8, 3)."""

    def col(vals, dtype=torch.int64):
        return torch.tensor(vals, dtype=dtype, device=device)[None, :, None]

    L = layout.levels
    bits = torch.tensor([[(c >> d) & 1 for d in range(3)] for c in range(8)],
                        dtype=torch.int64, device=device)
    return (col(layout.resolutions),
            col([lv < layout.begin_fast_hash_level for lv in range(L)],
                torch.bool),
            col(layout.map_sizes), col(layout.offsets), bits)


def hash_indices(xyz: torch.Tensor, layout: HashGridLayout):
    """(M, 3) positions in [0, 1] -> (M, L, 8) table indices (int64) and
    (M, L, 8) trilinear weights; corner c = cx + 2 cy + 4 cz."""
    dev = xyz.device
    res, use_under, sizes, offs, bits = _level_tables(layout, dev)
    pos = xyz[:, None, :] * level_scales(layout, dev)[None, :, None] + 0.5
    pg = torch.floor(pos)
    fr = pos - pg
    cell = as_u32(pg.to(torch.int32))  # (M, L, 3), uint32 values
    coords = [cell[:, :, None, d] + bits[:, d] for d in range(3)]  # (M, L, 8)
    w = None
    for d in range(3):
        f = fr[:, :, None, d]
        w_d = torch.where(bits[:, d].bool(), f, 1.0 - f)
        w = w_d if w is None else w * w_d
    h = torch.where(use_under, linear_index(*coords, res), fast_hash(*coords))
    return h % sizes + offs, w


def hash_encode_reference(table: torch.Tensor, xyz: torch.Tensor,
                          layout: HashGridLayout) -> torch.Tensor:
    """:func:`hash_encode` in plain PyTorch on any device: (..., 3)
    positions -> (..., L * F) features, level-major; ``table`` (F,
    n_entries), fp32 or bf16, gathered through :class:`_Gather`."""
    L, F = layout.levels, layout.feature_per_level
    batch_shape = xyz.shape[:-1]
    x = xyz.reshape(-1, 3)
    idx, w = hash_indices(x, layout)
    chans = _Gather.apply(table, idx)  # (F, M, L, 8) fp32
    out = torch.sum(w[None] * chans, dim=-1)  # (F, M, L)
    return out.permute(1, 2, 0).reshape(*batch_shape, L * F)


# How far the kernels may lie from the plain version.  Features: the
# 8-corner sum runs in another order than torch.sum, at most 7 roundings of
# a sum below 1 (weights sum to 1, table values < 1), ~4.2e-7, relative to
# the largest feature.  Gradient: its sums run in another order (by
# atomics), so each entry lies within GRAD_ULPS fp32 roundings (2^-24) of
# the sum of its terms' magnitudes, the bound of a sum's rounding that does
# not depend on its order (the CPU's index_add_ against autograd's takes 8:
# tests/test_torch_ngp_encoders.py); a bf16 gradient may round an entry to
# the neighbouring bf16 value besides (2^-7 of the entry).
FEATURE_REL_TOL = 1e-6
GRAD_ULPS = 16
BF16_ENTRY_TOL = 2.0**-7


def kernel_grad_room(xyz: torch.Tensor, dout: torch.Tensor,
                     layout: HashGridLayout,
                     want_g: torch.Tensor) -> torch.Tensor:
    """How far each entry of the kernels' (F, n_entries) table gradient may
    lie from the plain version's ``want_g`` for positions ``xyz`` and
    cotangent ``dout`` (M, L F): :data:`GRAD_ULPS` roundings of the sum of
    its terms' magnitudes, and for a bf16 gradient a bf16 rounding."""
    idx, w = hash_indices(xyz, layout)
    L, F = layout.levels, layout.feature_per_level
    terms = w[None] * dout.reshape(-1, L, F).permute(2, 0, 1)[..., None]
    mag = torch.zeros((F, layout.n_entries), device=xyz.device)
    mag.index_add_(1, idx.reshape(-1), terms.abs().reshape(F, -1))
    room = GRAD_ULPS * 2.0**-24 * mag
    if want_g.dtype == torch.bfloat16:
        room = room + BF16_ENTRY_TOL * want_g.float().abs()
    return room


# ---- the kernels (csrc/hash_encode.cu) -----------------------------------

# the feature widths the kernels are built for, and the most levels they take
KERNEL_F = (1, 2, 4, 8)
MAX_LEVELS = 16
_TABLE_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=32)
def _kernel_levels(layout: HashGridLayout):
    """The layout as the kernels take it: the fp32 scale of each level and,
    per level, (cells a side, table size, first entry, 1 if hashed)."""
    info = []
    for lv in range(layout.levels):
        info += [layout.resolutions[lv], layout.map_sizes[lv],
                 layout.offsets[lv], int(lv >= layout.begin_fast_hash_level)]
    return tuple(level_scales(layout).tolist()), tuple(info)


def _kernel_args(layout: HashGridLayout):
    """``(scales, info, primes)`` for the operators: the layout's levels and
    the primes :data:`_PRIMES` holds at the call."""
    return (*_kernel_levels(layout), tuple(_PRIMES))


@functools.lru_cache(maxsize=32)
def _c_levels(scales, info, primes):
    """The level table as C arrays (cached: a step passes the same one)."""
    return ((ctypes.c_float * len(scales))(*scales),
            (ctypes.c_longlong * len(info))(*info),
            (ctypes.c_longlong * len(primes))(*primes))


def _check_kernel_args(F, n, xyz, feats, scales, info, primes):
    """Raise unless the kernels take these: a table (F, ``n``), positions
    ``xyz`` and ``feats``, the (M, L F) output (forward) or its cotangent
    (backward)."""
    L = len(scales)
    if not 1 <= L <= MAX_LEVELS or len(info) != 4 * L:
        raise ValueError(f"no hash-encode kernel for {L} levels (1 to "
                         f"{MAX_LEVELS}, 4 numbers each in info)")
    if F not in KERNEL_F:
        raise ValueError(f"no hash-encode kernel for F={F} (built for "
                         f"{KERNEL_F})")
    if not 1 <= n < 2**32:
        raise ValueError(f"no hash-encode kernel for {n} table entries")
    M = xyz.shape[0]
    for name, t, shape in (("xyz", xyz, (M, 3)),
                           ("features", feats, (M, L * F))):
        if t.dim() != 2 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != xyz.device:
            raise ValueError(f"{name} is on {t.device}, xyz on {xyz.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the hash-encode kernels "
                            "take float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for lv in range(L):
        res, size, start, hashed = info[4 * lv : 4 * lv + 4]
        if (not 1 <= res < 2**32 or size < 1 or start < 0
                or start + size > n or hashed not in (0, 1)):
            raise ValueError(f"level {lv} ({res}, {size}, {start}, {hashed}) "
                             f"does not fit the table of {n} entries")
    if len(primes) != 3 or not all(0 <= p < 2**32 for p in primes):
        raise ValueError(f"the hash takes three uint32 primes, got {primes}")


def _fwd_fake(table, xyz, scales, info, primes):
    if table.dim() != 2:
        raise ValueError(f"table must be (F, n_entries), got "
                         f"{tuple(table.shape)}")
    if table.dtype not in _TABLE_DTYPES:
        raise TypeError(f"table is {table.dtype}; the hash-encode kernels "
                        "take float32 or bfloat16")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if table.device != xyz.device:
        raise ValueError(f"table is on {table.device}, xyz on {xyz.device}")
    F, n = table.shape
    out = xyz.new_empty((xyz.shape[0], len(scales) * F))
    _check_kernel_args(F, n, xyz, out, scales, info, primes)
    return out


def _fwd_op(launch, out, table, xyz, scales, info, primes):
    if xyz.shape[0]:
        F, n = table.shape
        c_levels = _c_levels(tuple(scales), tuple(info), tuple(primes))
        launch(xyz.device, xyz.data_ptr(), table.data_ptr(), out.data_ptr(),
               xyz.shape[0], n, len(scales), F,
               int(table.dtype == torch.bfloat16),
               *(ctypes.addressof(a) for a in c_levels))


def _bwd_fake(dout, xyz, n, dtype, scales, info, primes):
    """The (F, n) table gradient in ``dtype`` (the table's)."""
    if dtype not in _TABLE_DTYPES:
        raise TypeError(f"no hash-encode kernel for a {dtype} table")
    F = dout.shape[1] // max(len(scales), 1)
    grad = torch.empty((F, n), dtype=dtype, device=dout.device)
    _check_kernel_args(F, n, xyz, dout, scales, info, primes)
    return grad


def _bwd_op(launch, grad, dout, xyz, n, dtype, scales, info, primes):
    if not xyz.shape[0]:
        grad.zero_()
        return
    F = grad.shape[0]
    # the entry-major fp32 sums the scatter adds into (one vector a corner);
    # the C entry's second launch transposes them into ``grad``
    acc = torch.zeros((n, F), dtype=torch.float32, device=grad.device)
    c_levels = _c_levels(tuple(scales), tuple(info), tuple(primes))
    launch(dout.device, dout.data_ptr(), xyz.data_ptr(), acc.data_ptr(),
           grad.data_ptr(), xyz.shape[0], n, len(scales), F,
           int(dtype == torch.bfloat16),
           *(ctypes.addressof(a) for a in c_levels))
    LAUNCHES["hash_encode_bwd_transpose"] += 1  # the entry's second kernel


# C arguments: pointers (xyz, table, out) / (dout, xyz, acc, grad), then M,
# n, L, F and the bf16 flag, then the level table and the primes
declare(
    "hash_encode_fwd(Tensor table, Tensor xyz, float[] scales, int[] info, "
    "int[] primes) -> Tensor",
    "hash_encode", (ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) * 2
    + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 3,
    _fwd_fake, _fwd_op, symbol="hash_encode_fwd")
declare(
    "hash_encode_bwd(Tensor dout, Tensor xyz, int n, ScalarType dtype, "
    "float[] scales, int[] info, int[] primes) -> Tensor",
    "hash_encode", (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) * 2
    + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 3,
    _bwd_fake, _bwd_op, symbol="hash_encode_bwd")


class _HashEncode(torch.autograd.Function):
    """(table (F, n_entries), xyz (M, 3)) -> (M, L * F) through the
    kernels; the backward returns the table's gradient alone."""

    @staticmethod
    def forward(ctx, table, xyz, layout):
        args = _kernel_args(layout)
        # the entries and weights are recomputed from xyz in the backward,
        # with the levels and primes of the forward
        ctx.save_for_backward(xyz)
        ctx.args, ctx.n, ctx.dtype = args, table.shape[1], table.dtype
        return torch.ops.taichi_nerfs_torch.hash_encode_fwd(table, xyz, *args)

    @staticmethod
    def backward(ctx, dout):
        with profiling.span("ngp.encode"):
            (xyz,) = ctx.saved_tensors
            grad = torch.ops.taichi_nerfs_torch.hash_encode_bwd(
                dout.contiguous(), xyz, ctx.n, ctx.dtype, *ctx.args)
            return grad, None, None


def hash_encode(table: torch.Tensor, xyz: torch.Tensor,
                layout: HashGridLayout) -> torch.Tensor:
    """(..., 3) positions in [0, 1] -> (..., L * F) features, level-major.

    ``table``: (F, n_entries), fp32 or bf16.  CUDA positions run
    ``csrc/hash_encode.cu`` (operators ``taichi_nerfs_torch::
    hash_encode_fwd`` / ``::hash_encode_bwd``, each launch counted in
    ``_build.LAUNCHES``) and raise where the kernels take no such layout or
    tensors; CPU positions run the plain version,
    :func:`hash_encode_reference`'s."""
    if not on_cuda(xyz, "hash-encode"):
        return hash_encode_reference(table, xyz, layout)
    batch_shape = xyz.shape[:-1]
    out = _HashEncode.apply(table, xyz.reshape(-1, 3).contiguous(), layout)
    return out.reshape(*batch_shape, layout.out_dim)
