"""Host-side training loop of the NGP path.

Port of the JAX package's ``train/loop.py:Trainer``: the one-time
camera-visibility marking, a density-grid refresh every
``update_interval`` steps (over all cells until ``warmup_steps``), the
adaptive per-ray sample cap ``S`` and packing cap, ``run_step`` and
``fit``.  Every random draw comes from one ``torch.Generator`` on the
training device, seeded with ``cfg.train.seed``.

With a ``mesh`` (``parallel/mesh.py``) the trainer is one rank of a
data-parallel run: the step and the refresh are ``parallel/shard.py``'s.
Every rank draws the same full batch from its identically seeded
generator, and every host decision (the caps, the refresh cadence) reads
the reduced metrics, which are equal on every rank, so the ranks stay in
step.  Only rank 0 logs.

Host reads.  A step reads nothing back.  The cap adaptation reads the last
step's ``counts_max`` and ``rm_samples`` once per refresh, as the JAX loop
does; logging reads the metrics every ``log_every`` steps.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..models.occupancy import all_cells, mark_invisible_cells
from ..utils import profiling
from ..utils.device import require_fp32_matmul
from .state import TrainState, create_train_state
from .step import Batch, density_grid_step, draw_step, train_step

MIN_CAP = 32


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def _bucket(x: int) -> int:
    """Round up to {2^k, 1.5 * 2^k}."""
    p = _next_pow2(x)
    if x <= (p // 4) * 3:
        return (p // 4) * 3
    return p


class Trainer:
    def __init__(
        self,
        cfg: Config,
        data: Batch,
        K: np.ndarray,
        img_wh,
        state: Optional[TrainState] = None,
        log_fn=print,
        mesh=None,
        device=None,
    ):
        """``data``: a :class:`Batch` on the training device; ``device``
        defaults to the data's.  ``mesh``: train as one rank of it, on its
        device."""
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's "
                                 f"{mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.device = torch.device(device or data.rays.device)
        self.cfg = cfg
        self.data = data
        self.log_fn = log_fn
        self.state = (state if state is not None
                      else create_train_state(cfg, device=self.device))
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.train.seed)
        # one-time camera-visibility marking
        occupancy = mark_invisible_cells(cfg.model, K, data.poses.cpu(),
                                         tuple(img_wh), device=self.device)
        self.state = self.state._replace(occupancy=occupancy)
        self._cells = None  # the warmup refresh's all-cells table
        # start small and grow on sustained overflow: during the warmup
        # every ray crosses mostly-occupied cells, so counts_max == S
        # whatever S is
        self.sample_cap = min(256, cfg.render.train_sample_cap)
        self.pack_cap = min(
            _bucket(cfg.train.batch_size * 192),
            cfg.train.batch_size * self.sample_cap,
            2 * 1024 * 1024,
        )
        self.step = 0
        self._pending_counts_max = None
        self._pending_rm_samples = None
        self._pack_shrink_votes = 0
        self._cap_grow_votes = 0

    def _adapt_sample_cap(self):
        """Resize the sample and packing caps from the last step's counts
        (one host read)."""
        if self._pending_counts_max is None:
            return
        counts_max = int(self._pending_counts_max)
        rm_samples = int(self._pending_rm_samples)
        self._pending_counts_max = None
        self._pending_rm_samples = None
        max_cap = self.cfg.render.train_sample_cap
        if counts_max >= self.sample_cap and self.sample_cap < max_cap:
            # grow only on sustained overflow, and never in the warmup,
            # whose mostly-dense grid overflows any S
            in_warmup = self.step <= self.cfg.train.warmup_steps
            self._cap_grow_votes += 0 if in_warmup else 1
            if self._cap_grow_votes >= 2:
                self.sample_cap = min(self.sample_cap * 2, max_cap)
                self._cap_grow_votes = 0
        else:
            self._cap_grow_votes = 0
            proposed = max(_next_pow2(counts_max + 1), MIN_CAP)
            if proposed < self.sample_cap:
                self.sample_cap = proposed
        # pack 1.25x the observed batch total; shrink only through a
        # persistently lower bucket, grow at once
        n_dense = self.cfg.train.batch_size * self.sample_cap
        proposed_pack = min(_bucket(max(int(1.25 * rm_samples), 1024)),
                            2 * 1024 * 1024)
        if proposed_pack > (self.pack_cap or 0):
            self.pack_cap = proposed_pack
        elif proposed_pack < (self.pack_cap or n_dense):
            self._pack_shrink_votes += 1
            if self._pack_shrink_votes >= 4:
                self.pack_cap = proposed_pack
                self._pack_shrink_votes = 0
        else:
            self._pack_shrink_votes = 0
        if self.pack_cap is not None and self.pack_cap >= n_dense:
            self.pack_cap = None

    def _grid_step(self, warmup: bool):
        if warmup and self._cells is None:
            self._cells = all_cells(self.cfg.model.grid_size, self.device)
        cells = self._cells if warmup else None
        if self.mesh is not None:
            from ..parallel.shard import sharded_density_grid_step

            return sharded_density_grid_step(self.state, self.cfg,
                                             self.mesh, warmup,
                                             self.generator, cells=cells)
        return density_grid_step(self.state, self.cfg, warmup,
                                  self.generator, cells=cells)

    def _train_step(self, draws):
        if self.mesh is not None:
            from ..parallel.shard import sharded_train_step

            return sharded_train_step(self.state, self.data, self.cfg,
                                      self.mesh, self.sample_cap,
                                      self.pack_cap, draws)
        return train_step(self.state, self.data, self.cfg, self.sample_cap,
                          self.pack_cap, draws)

    def run_step(self):
        """One step (opening with the scheduled refresh), inside the span
        ``ngp.step``."""
        with profiling.span("ngp.step"):
            require_fp32_matmul()
            cfg = self.cfg
            if self.step % cfg.train.update_interval == 0:
                warmup = self.step < cfg.train.warmup_steps
                self.state = self._grid_step(warmup)
                if not warmup:
                    self._cells = None
                self._adapt_sample_cap()
            draws = draw_step(cfg, self.data, self.generator)
            self.state, metrics = self._train_step(draws)
            self._pending_counts_max = metrics["counts_max"]
            self._pending_rm_samples = metrics["rm_samples"]
            self.step += 1
        return metrics

    def fit(self, max_steps: Optional[int] = None, log_every: int = 1000):
        """``max_steps + 1`` steps (as the JAX loop runs them), logging
        every ``log_every`` (rank 0 alone, with a mesh)."""
        max_steps = max_steps or self.cfg.train.max_steps
        tic = time.time()
        metrics = None
        n_rays = self.cfg.train.batch_size
        for _ in range(max_steps + 1):
            metrics = self.run_step()
            step = self.step - 1
            if step % log_every == 0 and (self.mesh is None
                                          or self.mesh.rank == 0):
                m = {k: float(v) for k, v in metrics.items()}
                self.log_fn(
                    f"elapsed_time={time.time() - tic:.2f}s | "
                    f"step={step} | psnr={m['psnr']:.2f} | "
                    f"loss={m['loss']:.6f} | rays={n_rays} | "
                    f"rm_s={m['rm_samples'] / n_rays:.1f} | "
                    f"vr_s={m['vr_samples'] / n_rays:.1f} | "
                    f"S={self.sample_cap}"
                )
        return metrics
