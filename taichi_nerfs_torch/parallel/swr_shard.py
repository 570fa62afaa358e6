"""Data-parallel training of the dense shear-warp path: one crop a rank.

Port of the JAX package's ``parallel/swr_shard.py``.  Params and Adam's
state are replicated; each rank renders its own training crop, the
gradients, the loss and the MSE are averaged over the ranks in one
collective, and Adam replays the same update on every rank.  Each rank
bakes the grid itself (no communication).

The sweep's axis, direction and warp are one choice for the whole step, so
the host draws a step's crops from poses that share them
(``train/swr_step.py:SwrTrainer``).  A rank's own random inputs (the random
background, the TV window starts) come from its caller, drawn from a
generator seeded from the seed and the rank (JAX folds the rank into the
key).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..models import pyramid as pyr
from ..train.swr_step import (
    SwrTrainConfig,
    SwrTrainState,
    apply_swr_grads,
    loss_and_grads,
    make_swr_loss,
)
from .mesh import Mesh


def make_swr_sharded_step(
    mcfg: pyr.PyramidConfig,
    tcfg: SwrTrainConfig,
    mesh: Mesh,
    axis: int,
    flip: bool,
    slab_window: int = 0,
    warp: str = "matmul",
    inside: bool = False,
    lat_size: int = 0,
    with_sigma_keep: bool = False,
    with_slope_bounds: bool = False,
):
    """The crop-parallel step for one sweep choice.

    It returns ``step(state, image, pose, K, crop_xy, *extra, bg=None,
    tv_starts=())``: this rank's image (H, W, 3 | 4), pose, intrinsics and
    crop offset; ``extra`` is the replicated (R, R, R) carving mask
    (``with_sigma_keep``), then this crop's (2, 2) slope bounds
    (``with_slope_bounds``), as ``make_swr_loss`` takes them; ``bg`` and
    ``tv_starts`` are this rank's draws.  ``inside`` trains a cubemap face
    of inside cameras, the loss masked to the face's pixels.  The step
    returns the new state (updated in place) and the metrics ``loss`` and
    ``psnr`` averaged over the ranks.
    """
    n_extra = int(with_sigma_keep) + int(with_slope_bounds)

    def step(state: SwrTrainState, image: torch.Tensor, pose, K, crop_xy,
             *extra, bg: torch.Tensor | None = None,
             tv_starts: Sequence[int] = ()):
        if len(extra) != n_extra:
            raise ValueError(f"the step takes {n_extra} extra operands "
                             f"(sigma_keep: {with_sigma_keep}, slope "
                             f"bounds: {with_slope_bounds}), got "
                             f"{len(extra)}")
        it = iter(extra)
        sigma_keep = next(it) if with_sigma_keep else None
        slope_bounds = next(it) if with_slope_bounds else None
        loss_fn = make_swr_loss(image, pose, K, crop_xy, mcfg, tcfg, axis,
                                flip, bg, tv_starts, lat_size, warp,
                                slab_window, inside, sigma_keep,
                                slope_bounds)
        loss, mse, grads = loss_and_grads(loss_fn, state.params)
        # one collective for the gradients, the loss and the MSE
        mesh.all_mean_(grads + [loss, mse])
        return apply_swr_grads(state, tcfg, loss, mse, grads)

    return step
