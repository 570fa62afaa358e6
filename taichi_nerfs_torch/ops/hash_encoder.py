"""Multiresolution hash-grid encoder (the reference's Instant-NGP layout).

Port of the JAX package's ``ops/hash_encoder.py``: the same level sizing,
the same spatial hash (primes 1 / 2654435761 / 805459861) and linear index
for dense levels, and the same U[0, 1) table.  The table is ``(F,
n_entries)``, feature-major, as the JAX code uses it.

uint32 arithmetic.  Cell coordinates become uint32 (a negative int32
coordinate wraps), the hash multiplies wrap mod 2**32 and ``h % map_size``
is unsigned; the port computes all of it in int64 with
:func:`~taichi_nerfs_torch.ops.math.mul_u32`, bit-equal to JAX.

The corner reduction is an fp32 sum over the corner axis (the JAX code
runs it as a selector matmul at HIGHEST precision, which TF32 would round).

Gradient.  One autograd Function (:class:`_Gather`) gathers fp32 and bf16
tables alike: the entries widened to fp32 (exactly), and in the backward
an fp32 ``index_add_`` of the 8 corners' cotangents, cast once to the
table's dtype, inside the span ``ngp.encode`` on the thread that runs it.
For an fp32 table that is autograd's scatter-add of the gather with the
sums in another order; for a bf16 table it is the semantics of the JAX
package's packed-pair gather ``_gather_pair_bf16``, whose packing is a TPU
issue-rate device the port does not need.  The port does this for every F
(the JAX package only for F == 2; for other F its bf16 scatter accumulates
in bf16).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Tuple

import numpy as np
import torch

from ..config import HashGridConfig
from ..utils import profiling
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


def hash_encode(table: torch.Tensor, xyz: torch.Tensor,
                layout: HashGridLayout) -> torch.Tensor:
    """(..., 3) positions in [0, 1] -> (..., L * F) features, level-major.

    ``table``: (F, n_entries), fp32 or bf16, gathered through
    :class:`_Gather`."""
    L, F = layout.levels, layout.feature_per_level
    batch_shape = xyz.shape[:-1]
    x = xyz.reshape(-1, 3)
    idx, w = hash_indices(x, layout)
    chans = _Gather.apply(table, idx)  # (F, M, L, 8) fp32
    out = torch.sum(w[None] * chans, dim=-1)  # (F, M, L)
    return out.permute(1, 2, 0).reshape(*batch_shape, L * F)
