"""Training state of the NGP path and the Adam optimizer of both trainers.

Port of the JAX package's ``train/state.py``.  :class:`TrainState` holds
the params, the optimizer state and the occupancy grid; the random streams
belong to the trainer (``train/loop.py``), which passes every draw into the
step explicitly.

Adam.  The JAX optimizers are Adam (b1 0.9, b2 0.999) on a
cosine schedule from ``lr`` to ``lr * final_ratio`` over ``max_steps``.
The JAX optimizer keeps ONE step count for Adam's bias correction and one for the
schedule: after the shear-warp trainer grows its pyramid, a new level's
zero moments are bias-corrected with the carried count, and a light resume
restarts Adam's count but not the schedule's.  ``torch.optim.Adam`` counts
per parameter, so :class:`Adam` is written out here; it updates parameters
and moments in place, in fp32.  Both trainers use it: the NGP trainer with
``final_ratio = 1 / lr_final_div``, the shear-warp one
(``train/swr_step.py``) with its ``lr_final_ratio`` and, with
``adam_mu_bf16``, a bf16 first moment (the JAX optimizer's
``mu_dtype``).

Params are trees of dicts and lists; :func:`tree_leaves` orders them as
``jax.tree_util`` does (dict keys sorted).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..models.occupancy import OccupancyGrid, init_occupancy
from ..models.registry import get_model


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor of a tree of dicts and lists, in
    :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def trainable(params):
    """fp32 leaf tensors that require grad."""
    return tree_map(lambda p: p.detach().float().requires_grad_(True),
                    params)


@dataclasses.dataclass
class AdamState:
    """``count``: Adam's bias-correction count; ``sched_count``: the cosine
    schedule's count (the two differ after a light resume)."""

    count: int
    sched_count: int
    mu: Any
    nu: Any


class Adam:
    """Adam (b1 0.9, b2 0.999) on a cosine schedule from ``lr`` to ``lr *
    final_ratio`` over ``max_steps``, fp32, in place.

    ``mu_dtype=torch.bfloat16`` stores the first moment in bf16 as the JAX
    optimizer's Adam with ``mu_dtype=bf16`` does: the new moment is computed in
    fp32 from the stored one (``b1 * mu`` in bf16, as JAX multiplies a bf16
    array by a Python float), the update uses that fp32 moment, and only
    then is it stored, rounded to bf16.  The second moment stays fp32.
    """

    b1, b2 = 0.9, 0.999

    def __init__(self, lr: float, max_steps: int, final_ratio: float,
                 eps: float = 1e-15, mu_dtype: torch.dtype = torch.float32):
        self.base_lr = lr
        self.max_steps = max_steps
        self.final_ratio = final_ratio
        self.eps = eps
        self.mu_dtype = mu_dtype

    def lr(self, count: int) -> float:
        c = min(float(count), float(self.max_steps))
        cos = 0.5 * (1.0 + math.cos(math.pi * c / self.max_steps))
        a = self.final_ratio
        return self.base_lr * ((1.0 - a) * cos + a)

    def init(self, params, sched_count: int = 0) -> AdamState:
        def zeros(dtype):
            return lambda p: torch.zeros_like(p, dtype=dtype,
                                              requires_grad=False)

        return AdamState(0, sched_count,
                         tree_map(zeros(self.mu_dtype), params),
                         tree_map(zeros(torch.float32), params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params) -> AdamState:
        """One step; ``grads``, ``params`` and the moments share a tree
        structure."""
        count = state.count + 1
        # fp32 host scalars, as the JAX optimizer computes them
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        step = float(f32(-self.lr(state.sched_count)))
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            if m.dtype == torch.float32:
                m32 = m.copy_((1.0 - self.b1) * g + self.b1 * m)
            else:
                b1 = torch.tensor(self.b1, dtype=m.dtype, device=m.device)
                m32 = (1.0 - self.b1) * g + m * b1
            v.copy_((1.0 - self.b2) * (g * g) + self.b2 * v)
            p.add_(step * ((m32 / bc1) / (torch.sqrt(v / bc2) + self.eps)))
            if m32 is not m:
                m.copy_(m32)  # stored rounded, after the update used it
        return AdamState(count, state.sched_count + 1, state.mu, state.nu)


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState
    occupancy: OccupancyGrid


def make_optimizer(cfg: Config) -> Adam:
    t = cfg.train
    return Adam(t.lr, t.max_steps, 1.0 / t.lr_final_div, t.adam_eps)


def create_train_state(cfg: Config, seed: int | None = None,
                       device=None) -> TrainState:
    """Params from a ``torch.Generator`` seeded with ``seed`` (default
    ``cfg.train.seed``), zero moments, an empty occupancy grid."""
    seed = cfg.train.seed if seed is None else seed
    gen = torch.Generator().manual_seed(seed)
    params = get_model(cfg.model.name).init_params(cfg.model, gen)
    params = trainable(tree_map(lambda p: p.to(device), params))
    return TrainState(params, make_optimizer(cfg).init(params),
                      init_occupancy(cfg.model, device))


def param_count(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))
