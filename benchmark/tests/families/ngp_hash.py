"""Instant-NGP on the hash grid on the CPU: its tiny sizes, the tiny limits
of its mix and the faults its cell can have."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.tests.families.ngp import (TINY_MODEL, TINY_SCENE,
                                          TINY_TRAIN)
from benchmark.tests.families.ngp import shrink_traffic  # noqa: F401
from benchmark.tests.tiny import patched

# four levels (two dense, two hashed), a 32^3 occupancy grid, the
# published MLP widths; the brick family's train, scene and mix sizes
TINY_GRID = {"levels": 4, "log2_T": 11, "base_res": 4, "max_res": 32}
# The CPU runs the program's plain ops and the reference on one device, so
# only rounding (and the bf16 roundings it flips) separates them; the TF32
# control and each fault read above at least one limit.
LIMITS = {
    # a step's loss: fp32 sums in another order, and a bf16 MLP operand
    # they flip (up to 3.3e-5 over four seeds; the control 1.3e-4)
    "loss_gap": 6e-5,
    # the first gradient's worst leaf, through the backward (1.5e-7; 1.7e-4)
    "grad_gap": 5e-6,
    # the change after the checked steps: Adam carries it along (5.2e-5;
    # 2.7e-4)
    "change_gap": 1.2e-4,
    # the median leaf's gradient difference (5.9e-7; 1.4e-3)
    "grad_diff_median": 3e-5,
    # the refreshed grid: its densities' norm gap, or its bits (0; 5.2e-4)
    "grid_gap": 1e-4,
    # the samples marched and composited: a sample on a cell boundary may
    # go either way (3.7e-5; 1.2e-2)
    "samples_gap": 6e-4,
}


def shrink_config(cfg: dict) -> dict:
    cfg["model"]["grid"].update(TINY_GRID)
    cfg["model"].update(TINY_MODEL)
    cfg["train"].update(TINY_TRAIN)
    cfg["scene"].update(TINY_SCENE)
    return cfg


def _bf16_table(encode):
    """The hash encoder given the table rounded to bf16 (the program's own
    bf16 gather, fp32 master weights): a precision below the
    configuration's."""

    def bf16(table, x, layout):
        return encode(table.to(torch.bfloat16), x, layout)

    return bf16


def _hashed_from(build, shift: int):
    """The layout with its first hashed level moved by ``shift``."""

    def moved(cfg):
        layout = build(cfg)
        return dataclasses.replace(
            layout, begin_fast_hash_level=layout.begin_fast_hash_level + shift)

    return moved


def planted():
    """Each fault the hash step can have, by name: a context that plants
    it in the program."""
    from taichi_nerfs_torch.models import ngp
    from taichi_nerfs_torch.ops import hash_encoder

    primes = hash_encoder._PRIMES
    return {
        "a bf16 table": patched(ngp, "hash_encode",
                                _bf16_table(ngp.hash_encode)),
        "a wrong hash prime": patched(hash_encoder, "_PRIMES",
                                      primes[:2] + (primes[2] + 2,)),
        "a dense level indexed as hashed": patched(
            ngp, "build_layout", _hashed_from(ngp.build_layout, -1)),
    }


def faults(spec, cell):
    """The faults this cell can have, each a context that plants it."""
    kind = spec.traffic(spec.cell(cell)["traffic"])["kind"]
    if kind != "train":
        raise ValueError(f"the NGP hash family serves no {kind!r} cell")
    return planted()
