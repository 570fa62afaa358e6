"""One training step of the NGP path, and the scheduled grid refresh.

Port of the JAX package's ``train/step.py``.  The JAX step splits its
state's key into a batch key and a render key; the port's step takes the
draws as tensors instead (:class:`StepDraws`: image and pixel indices, the
t-start noise, the random background), which the trainer makes from its
generator (:func:`draw_step`), so a test can pass the JAX package's own
draws.  The step runs the render, the loss, autograd and :class:`Adam`
(``train/state.py``) with no host read: its metrics stay on the device.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..config import Config
from ..models.occupancy import (
    draw_grid_inputs,
    update_density_grid,
)
from ..models.registry import get_model
from ..ops.distortion import distortion_loss
from ..ops.rays import get_rays
from ..render.renderer import render_train
from .state import TrainState, make_optimizer, tree_leaves, tree_map

# profiler spans (with the renderer's ngp.march / field / composite)
_span = torch.profiler.record_function


class Batch(NamedTuple):
    """Device-resident training data."""

    rays: torch.Tensor  # (N_img, H*W, 3) rgb
    poses: torch.Tensor  # (N_img, 3, 4)
    directions: torch.Tensor  # (H*W, 3) camera-frame ray directions


class StepDraws(NamedTuple):
    """The random inputs of one step."""

    img_idxs: torch.Tensor  # (B,) int64
    pix_idxs: torch.Tensor  # (B,) int64
    t_noise: torch.Tensor  # (B,) U[0, 1)
    bg: Optional[torch.Tensor]  # (3,) U[0, 1) with random_bg, else None


def draw_step(cfg: Config, data: Batch,
              generator: torch.Generator | None = None) -> StepDraws:
    """One step's draws, on the data's device."""
    B = cfg.train.batch_size
    dev = data.rays.device
    n_img, n_pix = data.rays.shape[0], data.rays.shape[1]
    strategy = cfg.train.ray_sampling_strategy
    if strategy == "all_images":
        img = torch.randint(0, n_img, (B,), generator=generator, device=dev)
    elif strategy == "same_image":
        img = torch.randint(0, n_img, (1,), generator=generator,
                            device=dev).expand(B)
    else:
        raise ValueError(strategy)
    pix = torch.randint(0, n_pix, (B,), generator=generator, device=dev)
    noise = torch.rand((B,), generator=generator, device=dev)
    bg = (torch.rand((3,), generator=generator, device=dev)
          if cfg.render.random_bg else None)
    return StepDraws(img, pix, noise, bg)


def sample_batch(data: Batch, img_idxs: torch.Tensor,
                 pix_idxs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rgb, pose, direction) of the drawn (image, pixel) pairs."""
    return (data.rays[img_idxs, pix_idxs], data.poses[img_idxs],
            data.directions[pix_idxs])


def loss_and_grads(
    state: TrainState,
    data: Batch,
    cfg: Config,
    sample_cap: int,
    pack_cap: int | None,
    draws: StepDraws,
):
    """The step's ``(loss, mse, render results, gradient tree)`` on the
    drawn rays; loss and MSE detached."""
    rgb_gt, pose, direction = sample_batch(data, draws.img_idxs,
                                           draws.pix_idxs)
    rays_o, rays_d = get_rays(direction, pose)
    results = render_train(
        state.params, cfg.model, cfg.render, state.occupancy.bitfield,
        rays_o, rays_d, sample_cap, pack_cap, t_noise=draws.t_noise,
        bg=draws.bg,
    )
    mse = torch.mean((results["rgb"] - rgb_gt) ** 2)
    loss = mse
    if cfg.train.distortion_loss_w > 0:
        loss = loss + cfg.train.distortion_loss_w * torch.mean(
            distortion_loss(results["ws"], results["deltas"],
                            results["ts"], results["valid"])
        )
    with _span("ngp.backward"):
        grads = iter(torch.autograd.grad(loss, tree_leaves(state.params)))
        grad_tree = tree_map(lambda _: next(grads), state.params)
    return loss.detach(), mse.detach(), results, grad_tree


def apply_grads(state: TrainState, cfg: Config, grad_tree) -> TrainState:
    """Adam on ``grad_tree``; params and moments updated in place."""
    with _span("ngp.adam"):
        opt_state = make_optimizer(cfg).update(grad_tree, state.opt_state,
                                               state.params)
    return state._replace(opt_state=opt_state)


def train_step(
    state: TrainState,
    data: Batch,
    cfg: Config,
    sample_cap: int,
    pack_cap: int | None,
    draws: StepDraws,
) -> Tuple[TrainState, Dict[str, Any]]:
    """One Adam step on one ray batch; params and moments are updated in
    place.  Metrics are device tensors: loss, psnr, rm_samples, vr_samples
    and counts_max."""
    loss, mse, results, grad_tree = loss_and_grads(
        state, data, cfg, sample_cap, pack_cap, draws)
    metrics = {
        "loss": loss,
        "psnr": -10.0 * torch.log10(mse),
        "rm_samples": results["rm_samples"],
        "vr_samples": results["vr_samples"],
        "counts_max": torch.amax(results["counts"]),
    }
    return apply_grads(state, cfg, grad_tree), metrics


def density_grid_step(state: TrainState, cfg: Config, warmup: bool,
                      generator: torch.Generator | None = None,
                      cells=None, draws=None, cell_shard=None,
                      tmp_reduce=None) -> TrainState:
    """The scheduled occupancy refresh: ``draws`` (per cascade, from
    :func:`~taichi_nerfs_torch.models.occupancy.draw_grid_inputs` when
    None) and ``cells`` (the warmup's all-cells table, made when None);
    ``cell_shard`` and ``tmp_reduce`` as ``update_density_grid``'s."""
    dev = state.occupancy.density_grid.device
    with _span("ngp.grid"):
        if draws is None:
            draws = draw_grid_inputs(cfg.model, warmup, generator, dev)
        occupancy = update_density_grid(
            state.params, cfg.model, get_model(cfg.model.name).density,
            state.occupancy, draws, cfg.train.density_threshold(),
            warmup=warmup, decay=cfg.train.density_decay, cells=cells,
            cell_shard=cell_shard, tmp_reduce=tmp_reduce,
        )
    return state._replace(occupancy=occupancy)
