"""Instant-NGP on the brick grid on the CPU: its tiny sizes, the tiny
limits of its mix and the faults its cell can have."""

from __future__ import annotations

import torch

from benchmark.tests.tiny import patched

# four levels (two dense, two hashed), a 32^3 occupancy grid, the
# published MLP widths; the refreshes of a 16-step warm-up every 8 steps
TINY_BRICK = {"levels": 4, "log2_rows": 10, "base_res": 4, "max_res": 32}
TINY_MODEL = {"grid_size": 32}
TINY_TRAIN = {"batch_size": 256, "warmup_steps": 16, "update_interval": 8}
TINY_SCENE = {"n_views": 4, "img_wh": [24, 24], "gt_steps": 24, "gt_ss": 1}
TINY_MIX = {"settle_steps": 24}
# The CPU runs the program's plain ops and the reference on one device, so
# only rounding (and the bf16 roundings it flips) separates them; the TF32
# control and each fault read above at least one limit.
LIMITS = {
    # a step's loss: fp32 sums in another order (the control: 7.1e-4)
    "loss_gap": 1e-5,
    # the first gradient's worst leaf, through the backward (1.4e-3)
    "grad_gap": 5e-4,
    # the change after the checked steps: Adam carries it along (3.2e-4)
    "change_gap": 1e-4,
    # the median leaf's gradient difference (3.1e-3)
    "grad_diff_median": 3e-4,
    # the refreshed grid: its densities' norm gap, or its bits (7.8e-3)
    "grid_gap": 3e-4,
    # the samples marched and composited: a sample on a cell boundary may
    # go either way, one in 25,000 a step here (1.6e-3)
    "samples_gap": 3e-4,
}


def shrink_config(cfg: dict) -> dict:
    cfg["model"]["brick"].update(TINY_BRICK)
    cfg["model"].update(TINY_MODEL)
    cfg["train"].update(TINY_TRAIN)
    cfg["scene"].update(TINY_SCENE)
    return cfg


def shrink_traffic(t: dict) -> dict:
    t.update(TINY_MIX)
    return t


def _half_rows(backward):
    """The brick backward scattering every other row of its input only."""

    def half(ctx, dout):
        dout = dout.clone()
        dout[1::2] = 0.0
        return backward(ctx, dout)

    return half


def _inclusive(optical_depth):
    """Each sample's own optical depth inside its transmittance."""
    return torch.exp(-torch.cumsum(optical_depth, dim=-1))


def _no_decay(update):
    """The refresh merging into the grid undecayed."""

    def undecayed(*a, **k):
        return update(*a, **dict(k, decay=1.0))

    return undecayed


def planted():
    """Each fault the NGP step can have, by name: a context that plants
    it in the program."""
    from taichi_nerfs_torch.ops import brick_encoder, composite
    from taichi_nerfs_torch.train import step

    cls = brick_encoder._BrickEncode
    return {
        "half the brick rows scattered": patched(
            cls, "backward", _half_rows(cls.backward)),
        "inclusive transmittance": patched(
            composite, "exclusive_transmittance", _inclusive),
        "a refresh without decay": patched(
            step, "update_density_grid", _no_decay(step.update_density_grid)),
    }


def faults(spec, cell):
    """The faults this cell can have, each a context that plants it."""
    kind = spec.traffic(spec.cell(cell)["traffic"])["kind"]
    if kind != "train":
        raise ValueError(f"the NGP family serves no {kind!r} cell")
    return planted()
