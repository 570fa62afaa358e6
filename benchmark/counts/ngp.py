"""Bytes and operations of Instant-NGP on the brick grid: the encoder's
least time, and the terms of a training step and of a refresh for the whole
step's share of the peaks.

The encoder's bytes are the algorithm's, whatever an implementation reads
again: the positions read once (3 fp32 each), each distinct table entry the
positions touch read once (a hashed level's row: 8F fp32; a dense level's
corner entry: F fp32) and, in a training step, its gradient written once.
The features and their cotangent are left out: a fused encoder and MLP
never writes them.  Distinct entries are counted with the reference's own
index function (``reference/ngp.py:brick_entries``).  Its operations are
the 8-corner multiply-adds (2 flops each, per feature and level), once
forward and once backward.  So no implementation, a fused one included,
can pass 100 % of this bound.

Each term of a step is ``(name, flops, precision)``; the precision names a
peak of ``counts/peaks.py`` (the MLPs run with bf16 operands, the rest in
fp32).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from benchmark.counts.flops import Term, mlp_macs
from benchmark.counts.sweep import bound_ms
from benchmark.reference.ngp import BrickGeometry, brick_entries

POSITION_BYTES = 12


def distinct_entries(x01: torch.Tensor, geo: BrickGeometry) -> List[int]:
    """Per level, the table entries that positions (M, 3) in [0, 1]^3
    read: a dense level's corner entries, a hashed level's rows."""
    x01 = torch.clamp(x01, 0.0, 1.0)
    return [int(torch.unique(idx).numel())
            for idx in brick_entries(x01, geo)]


def entry_bytes(geo: BrickGeometry) -> List[int]:
    return [4 * geo.F * (1 if dense else 8) for dense in geo.dense]


def encode_flops(n: int, geo: BrickGeometry, backward: bool) -> float:
    """The 8-corner multiply-adds of ``n`` positions, per feature and
    level; twice with the backward (the table gradient's)."""
    return (2 if backward else 1) * 2.0 * 8 * geo.F * len(geo.res) * n


def encode_bound(x01: torch.Tensor, geo: BrickGeometry, backward: bool):
    """The least time of one encoder call on positions ``x01`` (forward,
    and with ``backward`` the table gradient): ``(ms, by, bytes,
    flops)``."""
    table = sum(n * b for n, b in zip(distinct_entries(x01, geo),
                                      entry_bytes(geo)))
    nbytes = POSITION_BYTES * x01.shape[0] + table * (2 if backward else 1)
    flops = encode_flops(x01.shape[0], geo, backward)
    return (*bound_ms(nbytes, flops), nbytes, flops)


def mlp_dims(model: dict) -> Tuple[List[Tuple[int, int]],
                                   List[Tuple[int, int]]]:
    """The xyz and rgb MLPs' layers ``(in, out)``: the encoding (L F) into
    ``xyz_net_depth`` hidden layers of ``xyz_net_width`` and
    ``xyz_net_out_dim`` out; 16 SH terms and that feature into
    ``rgb_net_depth`` layers of ``rgb_net_width`` and 3 out."""
    b = model["brick"]
    xyz, fan = [], int(b["levels"]) * int(b["feature_per_level"])
    for _ in range(int(model["xyz_net_depth"])):
        xyz.append((fan, int(model["xyz_net_width"])))
        fan = int(model["xyz_net_width"])
    xyz.append((fan, int(model["xyz_net_out_dim"])))
    rgb, fan = [], int(model["sh_degree"]) ** 2 + int(model["xyz_net_out_dim"])
    for _ in range(int(model["rgb_net_depth"])):
        rgb.append((fan, int(model["rgb_net_width"])))
        fan = int(model["rgb_net_width"])
    return xyz, rgb + [(fan, 3)]


def param_count(model: dict) -> int:
    geo = BrickGeometry.of(model["brick"])
    corners = sum((r + 1) ** 3 for r, d in zip(geo.res, geo.dense) if d)
    rows = geo.rows * sum(1 for d in geo.dense if not d)
    xyz, rgb = mlp_dims(model)
    return geo.F * (corners + 8 * rows) + mlp_macs(xyz) + mlp_macs(rgb)


# per sample: the SH-16 of the normalised direction (forward only); the
# composite (optical depth, alpha, the running sum, transmittance, weight,
# colour, opacity and depth), forward and backward
SH_FLOPS = 60
COMPOSITE_FLOPS = 3 * 16
# per march probe: the position (3 multiply-adds) and its cell (4)
PROBE_FLOPS = 10
# per refreshed cell: decay, max-merge, keep, the mean and the bit
GRID_FLOPS = 5


def step_terms(model: dict, samples: int, rays: int, probes: int
               ) -> List[Term]:
    """One training step: ``samples`` marched samples (each evaluated and
    composited), ``rays`` rays, ``probes`` march probes; Adam on every
    parameter (12 flops each)."""
    geo = BrickGeometry.of(model["brick"])
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
    geo = BrickGeometry.of(model["brick"])
    xyz, _ = mlp_dims(model)
    return [
        ("refresh_encode", encode_flops(points, geo, backward=False), "fp32"),
        ("refresh_mlp", 2.0 * mlp_macs(xyz) * points, "bf16"),
        ("refresh_grid", float(GRID_FLOPS * int(model["grid_size"]) ** 3),
         "fp32"),
    ]


def add_terms(totals: Dict, terms: Sequence[Term]) -> None:
    for name, f, prec in terms:
        totals[(name, prec)] = totals.get((name, prec), 0.0) + f
