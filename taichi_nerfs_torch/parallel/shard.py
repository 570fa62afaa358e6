"""Data-parallel training of the NGP path: the ray-parallel step and the
cell-parallel grid refresh.

Port of the JAX package's ``parallel/shard.py``.  Params, Adam's state and
the occupancy grid are replicated: every rank holds them and applies the
same reduced update.  Every rank receives the same full :class:`StepDraws`
(its trainer's generator is seeded as every other rank's) and renders its
own disjoint ``batch_size / n`` slice of the rays, so the union of the
ranks' work is the one-device step's batch.  Loss, MSE and gradients are
per-shard means averaged over the ranks (equal shards: the global means);
``rm_samples`` / ``vr_samples`` are summed and ``counts_max`` is the max,
so the host's cap adaptation (``train/loop.py``) sees the one-device
values on every rank.

The refresh fans out the same way: each rank probes 1/n of the cells that
every rank draws, and the probe grids merge by their max.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..config import Config
from ..train.loop import _bucket
from ..train.state import TrainState, tree_leaves
from ..train.step import (
    Batch,
    StepDraws,
    apply_grads,
    density_grid_step,
    loss_and_grads,
)
from .mesh import Mesh


def shard_pack_cap(pack_cap: int | None, batch_size: int, n: int,
                   sample_cap: int) -> int | None:
    """A shard's packed-evaluation budget from the global one: 1.5 times
    its share (headroom for uneven rays), bucketed; ``None`` (a dense
    evaluation) when that is no smaller than the shard's dense size."""
    if pack_cap is None:
        return None
    local_dense = (batch_size // n) * sample_cap
    cap = min(_bucket(int(1.5 * pack_cap / n)), local_dense)
    return None if cap >= local_dense else cap


def _check_batch(cfg: Config, mesh: Mesh) -> int:
    b = cfg.train.batch_size
    if b % mesh.size:
        raise ValueError(f"batch_size {b} not divisible by {mesh.size} "
                         "ranks")
    return b // mesh.size


def sharded_train_step(
    state: TrainState,
    data: Batch,
    cfg: Config,
    mesh: Mesh,
    sample_cap: int,
    pack_cap: int | None,
    draws: StepDraws,
) -> Tuple[TrainState, Dict[str, Any]]:
    """The ranks' counterpart of ``train/step.py:train_step`` on the full
    ``draws`` (the same on every rank).  The metrics are the reduced ones,
    equal on every rank.  While no pack cap truncates, it is the one-device
    step to rounding; when one does, each shard drops its own last
    samples."""
    local = _check_batch(cfg, mesh)
    sl = slice(mesh.rank * local, (mesh.rank + 1) * local)
    mine = StepDraws(draws.img_idxs[sl], draws.pix_idxs[sl],
                     draws.t_noise[sl], draws.bg)
    loss, mse, results, grad_tree = loss_and_grads(
        state, data, cfg, sample_cap,
        shard_pack_cap(pack_cap, cfg.train.batch_size, mesh.size,
                       sample_cap), mine)
    # one collective for the gradients, the loss and the MSE
    mesh.all_mean_(tree_leaves(grad_tree) + [loss, mse])
    counts = mesh.all_sum(torch.stack([results["rm_samples"],
                                       results["vr_samples"]]))
    metrics = {
        "loss": loss,
        "psnr": -10.0 * torch.log10(mse),
        "rm_samples": counts[0],
        "vr_samples": counts[1],
        "counts_max": mesh.all_max(torch.amax(results["counts"])),
    }
    return apply_grads(state, cfg, grad_tree), metrics


def sharded_density_grid_step(state: TrainState, cfg: Config, mesh: Mesh,
                              warmup: bool,
                              generator: torch.Generator | None = None,
                              cells=None, draws=None) -> TrainState:
    """The ranks' counterpart of ``train/step.py:density_grid_step``: the
    draws (made from ``generator`` when None) are the same on every rank,
    each probes its 1/n of the cells, and the probe grids max-reduce."""
    _check_batch(cfg, mesh)
    return density_grid_step(state, cfg, warmup, generator, cells=cells,
                             draws=draws, cell_shard=(mesh.rank, mesh.size),
                             tmp_reduce=mesh.all_max)
