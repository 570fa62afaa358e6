"""Plain reference of Instant-NGP (Mueller et al., SIGGRAPH 2022) on the
paper's multiresolution hash grid (section 3).

The step is ``reference/ngp.py``'s (the MLPs, SH, the march, the
composite, the loss, Adam and the sampled refresh); only the encoding
differs: :func:`benchmark.reference.ngp.hash_encode` on
:class:`~benchmark.reference.ngp.HashGeometry`.  A level of resolution
``res`` holds ``min(2^log2_T, align_to(res^3, 8))`` entries of F features;
a position is the trilinear sum of its cell's 8 corners, each corner an
entry of its own: ``x + y res + z res^2`` on a dense level (one whose
``res^3`` fits), the spatial hash ``x * 1 xor y * 2654435761 xor z *
805459861`` on a hashed level, either mod the level's size.  The table is
the leaf ``grid.table``, ``(F, entries)``, level after level.

Departures from the program, on purpose: those of ``reference/ngp.py``; the
corners are read one by one, and the table gradient is autograd's of those
plain gathers.  Nothing here imports the program; TF32 is off.
"""

from __future__ import annotations

from typing import List

import torch

from benchmark.reference.ngp import (CORNERS, HashGeometry, NGPReference,
                                     _cell, hash_encode, spatial_hash)


def hash_entries(x01: torch.Tensor, geo: HashGeometry) -> List[torch.Tensor]:
    """Per level, the (M, 8) entries of the level that positions (M, 3) in
    [0, 1]^3 read, corner (bx, by, bz) in ``CORNERS`` order: the indices
    :func:`~benchmark.reference.ngp.hash_encode` gathers, without the
    level's start."""
    out = []
    for lv, r in enumerate(geo.res):
        cell, _ = _cell(x01, geo.scale[lv])
        idx = []
        for bits in CORNERS:
            k = cell + torch.tensor(bits, device=cell.device)
            i = (spatial_hash(k) if geo.hashed[lv]
                 else k[:, 0] + k[:, 1] * r + k[:, 2] * r * r)
            idx.append(i % geo.size[lv])
        out.append(torch.stack(idx, dim=1))
    return out


class NGPHashReference(NGPReference):
    """The reference at a configuration whose ``model.grid`` is the hash
    grid.  Params are named leaves: ``grid.table``, ``xyz_mlp.w<i>``,
    ``rgb_mlp.w<i>``."""

    def __init__(self, config: dict, tf32: bool = False):
        super().__init__(config, tf32)
        self.geo = HashGeometry.of(self.m["grid"])

    def encode(self, params, x01):
        return hash_encode(params["grid.table"], x01, self.geo, self.tf32)
