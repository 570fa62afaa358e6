"""Bytes and operations of Instant-NGP on the hash grid: the hash encoder's
least time, and the terms of a training step and of a refresh for the
whole step's share of the peaks (``counts/ngp.py`` for the brick grid).

The encoder's bytes are the algorithm's, whatever an implementation reads
again: the positions read once (3 fp32 each), each distinct table entry
(F fp32) the positions touch read once and, in a training step, its
gradient written once.  The (M, L, 8) indices and weights and the features
are left out: a fused encoder computes the first in registers and never
writes the others.  Distinct entries are counted with the reference's own
index function (``reference/ngp_hash.py:hash_entries``).  Its operations
are the 8-corner multiply-adds (2 flops each, per feature and level), once
forward and once backward.  So no implementation can pass 100 % of this
bound.
"""

from __future__ import annotations

from typing import List

import torch

from benchmark.counts import ngp
from benchmark.counts.flops import Term, mlp_macs
from benchmark.counts.ngp import (COMPOSITE_FLOPS, GRID_FLOPS,  # noqa: F401
                                  POSITION_BYTES, PROBE_FLOPS, SH_FLOPS,
                                  add_terms)
from benchmark.counts.sweep import bound_ms
from benchmark.reference.ngp import HashGeometry
from benchmark.reference.ngp_hash import hash_entries

ENTRY_BYTES = 4  # one fp32 feature


def distinct_entries(x01: torch.Tensor, geo: HashGeometry) -> List[int]:
    """Per level, the table entries that positions (M, 3) in [0, 1]^3
    read."""
    return [int(torch.unique(idx).numel()) for idx in hash_entries(x01, geo)]


def encode_flops(n: int, geo: HashGeometry, backward: bool) -> float:
    """The 8-corner multiply-adds of ``n`` positions, per feature and
    level; twice with the backward (the table gradient's)."""
    return (2 if backward else 1) * 2.0 * 8 * geo.F * len(geo.res) * n


def encode_bound(x01: torch.Tensor, geo: HashGeometry, backward: bool):
    """The least time of one encoder call on positions ``x01`` (forward,
    and with ``backward`` the table gradient): ``(ms, by, bytes,
    flops)``."""
    table = ENTRY_BYTES * geo.F * sum(distinct_entries(x01, geo))
    nbytes = POSITION_BYTES * x01.shape[0] + table * (2 if backward else 1)
    flops = encode_flops(x01.shape[0], geo, backward)
    return (*bound_ms(nbytes, flops), nbytes, flops)


def mlp_dims(model: dict):
    """The xyz and rgb MLPs' layers ``(in, out)``, the brick model's on an
    encoding of the hash grid's L F."""
    return ngp.mlp_dims(dict(model, brick=model["grid"]))


def param_count(model: dict) -> int:
    geo = HashGeometry.of(model["grid"])
    xyz, rgb = mlp_dims(model)
    return geo.F * (geo.start[-1] + geo.size[-1]) + mlp_macs(xyz) + mlp_macs(
        rgb)


def step_terms(model: dict, samples: int, rays: int, probes: int
               ) -> List[Term]:
    """One training step: ``samples`` marched samples (each evaluated and
    composited), ``rays`` rays, ``probes`` march probes; Adam on every
    parameter (12 flops each)."""
    geo = HashGeometry.of(model["grid"])
    xyz, rgb = mlp_dims(model)
    macs = mlp_macs(xyz) + mlp_macs(rgb)
    return [
        ("encode", encode_flops(samples, geo, backward=True), "fp32"),
        # forward, the inputs' gradient and the weights' gradient
        ("mlp", 3 * 2.0 * macs * samples, "bf16"),
        ("sh", float(SH_FLOPS * samples), "fp32"),
        ("composite", float(COMPOSITE_FLOPS * samples), "fp32"),
        ("march", float(PROBE_FLOPS * probes), "fp32"),
        ("loss", 3.0 * 3 * rays, "fp32"),
        ("adam", 12.0 * param_count(model), "fp32"),
    ]


def refresh_terms(model: dict, points: int) -> List[Term]:
    """One refresh: the density of ``points`` probes (the encoding and the
    xyz MLP, forward) and the grid's update."""
    geo = HashGeometry.of(model["grid"])
    xyz, _ = mlp_dims(model)
    return [
        ("refresh_encode", encode_flops(points, geo, backward=False), "fp32"),
        ("refresh_mlp", 2.0 * mlp_macs(xyz) * points, "bf16"),
        ("refresh_grid", float(GRID_FLOPS * int(model["grid_size"]) ** 3),
         "fp32"),
    ]
