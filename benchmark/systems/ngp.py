"""Instant-NGP on the brick grid: what the NGP cell drives of the program
(``train/loop.py:Trainer.run_step``, the step of ``python -m
taichi_nerfs_torch.train`` with no flag), the inputs it gives it, and the
comparison with the plain reference (``benchmark/reference/ngp.py``).

Inputs are the benchmark's own, made from the run's seed: the lego scene's
ground truth (``benchmark/scene/lego.py``, 8 bits a channel), the weights
(made on the device in one call a leaf) and the seed of the trainer's
generator, from which the program draws every ray batch and refresh.  Set-up
settles the training to the mix's ``settle_steps``, keeps a snapshot of the
state, and runs the checked steps; the window continues the same training.
The reference follows the checked steps from the snapshot, on the same
draws, which the session recovers by replaying the trainer's generator
through the program's own draw functions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from benchmark.counts import ngp as counts
from benchmark.harness.device import seeds
from benchmark.reference.ngp import (B1, SQRT3, BrickGeometry, March,
                                     NGPReference)
from benchmark.scene import lego
from benchmark.systems.pyramid import TrainSession as PyramidSession


def program_config(config: dict, seed: int):
    """The program's ``Config`` of the configuration's ``model``,
    ``render`` and ``train``, its generator seeded with ``seed``."""
    from taichi_nerfs_torch.config import (BrickGridConfig, Config,
                                           HashGridConfig, ModelConfig,
                                           RenderConfig, TrainConfig,
                                           TriPlaneConfig)

    m = dict(config["model"])
    m.update(grid=HashGridConfig(**m["grid"]),
             brick=BrickGridConfig(**m["brick"]),
             triplane=TriPlaneConfig(**m["triplane"]))
    return Config(model=ModelConfig(**m),
                  render=RenderConfig(**config["render"]),
                  train=TrainConfig(**config["train"], seed=int(seed)))


def make_params(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights from ``seed``, as named leaves on ``device``: the brick
    grid's corner entries and rows U[0, 1), the MLPs Xavier-uniform (stored
    (in, out)), each leaf one call of a generator on the device."""
    model = config["model"]
    geo = BrickGeometry.of(model["brick"])
    corners = sum((r + 1) ** 3 for r, d in zip(geo.res, geo.dense) if d)
    rows = geo.rows * sum(1 for d in geo.dense if not d)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {"brick.bricks": torch.rand((rows, 8 * geo.F), generator=gen,
                                      device=device),
           "brick.corners": torch.rand((corners, geo.F), generator=gen,
                                       device=device)}
    for name, dims in zip(("xyz_mlp", "rgb_mlp"), counts.mlp_dims(model)):
        for i, (fi, fo) in enumerate(dims):
            u = torch.rand((fi, fo), generator=gen, device=device)
            out[f"{name}.w{i}"] = (2.0 * u - 1.0) * float(
                np.sqrt(6.0 / (fi + fo)))
    return out


def leaves(tree) -> Dict[str, torch.Tensor]:
    """The program's params (or a moment) as named leaves."""
    return {f"{group}.{k}": v for group in sorted(tree)
            for k, v in sorted(tree[group].items())}


def occupancy_bits(bitfield: torch.Tensor) -> torch.Tensor:
    """The program's int32 words as one bool a cell (bit i of word w is
    cell 32 w + i)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bitfield.device)
    return ((bitfield.long()[:, None] >> shifts) & 1).bool().reshape(-1)


class Snapshot(NamedTuple):
    """The settled state, before the first checked step."""

    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int
    sched: int
    density: torch.Tensor  # (G^3,) morton order
    generator: torch.Tensor  # the trainer's generator's state


@dataclasses.dataclass
class Readings:
    """What the program or the reference gives in the checked steps."""

    losses: List[float]
    grad: Dict[str, torch.Tensor]  # the first checked step's gradient
    change: Dict[str, float]  # each leaf's change's norm, after the last
    grid: torch.Tensor  # the first step's refreshed density grid
    bits: torch.Tensor  # its occupancy bits
    samples: List[tuple]  # (marched, composited) samples a step
    # the steps each check step's march kept, (N, K) a step (the
    # reference's also: its steps on a cell boundary, and the program's
    # steps, at which it takes its loss)
    kept: Optional[List[torch.Tensor]] = None
    tied: Optional[List[torch.Tensor]] = None
    theirs: Optional[List[torch.Tensor]] = None


class Traced(NamedTuple):
    """A profiled step: the trainer's generator before it, its occupancy
    before and after the step's refresh, its sample cap and its count of
    samples marched."""

    generator: torch.Tensor
    before: object
    after: object
    step: int
    sample_cap: int
    rm_samples: torch.Tensor


class TrainSession:
    """``Trainer`` at ``config_for_scene(0.5)`` (the configuration's keys)
    on the lego views, its weights and generator seed the benchmark's."""

    kernels = ()

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from taichi_nerfs_torch.ops.rays import get_ray_directions_np
        from taichi_nerfs_torch.train.loop import Trainer
        from taichi_nerfs_torch.train.step import Batch

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        s_weights, s_trainer = seeds(seed, 2)
        sc = config["scene"]
        w, h = sc["img_wh"]
        self.width = w
        self.K = lego.intrinsics(w, h)
        poses = lego.train_poses(sc["n_views"], sc["radius"])
        rgb, _ = lego.render_gt(poses, self.K, w, h, sc["gt_steps"],
                                sc["gt_ss"], device=self.device)
        self.gt_u8 = torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8)
        del rgb
        self.cfg = program_config(config, s_trainer)
        self.data = Batch(
            rays=self.gt_u8.float() / 255.0,
            poses=torch.as_tensor(poses, device=self.device),
            directions=torch.as_tensor(get_ray_directions_np(h, w, self.K),
                                       device=self.device))
        self.trainer = Trainer(self.cfg, self.data, self.K, (w, h),
                               device=self.device)
        with torch.no_grad():
            mine = make_params(config, s_weights, self.device)
            for k, p in leaves(self.trainer.state.params).items():
                p.copy_(mine[k])
        del mine
        self.rays_per_step = int(config["train"]["batch_size"])
        self.traced: List[Traced] = []
        for _ in range(int(traffic["settle_steps"])):
            self.trainer.run_step()
        self._checked_steps()

    def _checked_steps(self) -> None:
        """The snapshot, then the checked steps through the window's call:
        each loss and its samples, the first step's gradient (from Adam's
        first moment before and after it) and refreshed grid, each leaf's
        change after the last, and the sample caps the steps used."""
        st = self.trainer.state
        mu = leaves(st.opt_state.mu)
        self.snap = Snapshot(
            {k: v.detach().clone() for k, v in leaves(st.params).items()},
            {k: v.clone() for k, v in mu.items()},
            {k: v.clone() for k, v in leaves(st.opt_state.nu).items()},
            st.opt_state.count, st.opt_state.sched_count,
            st.occupancy.density_grid.reshape(-1).clone(),
            self.trainer.generator.get_state())
        losses, samples, self.caps = [], [], []
        for k in range(int(self.traffic["check_steps"])):
            m = self.trainer.run_step()
            losses.append(m["loss"])
            samples.append((m["rm_samples"], m["vr_samples"]))
            self.caps.append(self.trainer.sample_cap)
            if k == 0:
                grad = {n: (mu[n] - B1 * self.snap.mu[n]) / (1.0 - B1)
                        for n in mu}
                occ = self.trainer.state.occupancy
                grid = occ.density_grid.reshape(-1).clone()
                bits = occupancy_bits(occ.bitfield)
                self.bitfield = occ.bitfield
        change = {k: float(torch.linalg.vector_norm(p.detach()
                                                    - self.snap.params[k]))
                  for k, p in leaves(self.trainer.state.params).items()}
        self.prog = Readings([float(x) for x in losses], grad, change, grid,
                             bits, [(int(a), int(b)) for a, b in samples])

    def check_steps(self) -> None:
        """Nothing: set-up ran the checked steps (``control.py`` builds a
        session and compares without calling this)."""

    def warm_up(self) -> None:
        """Nothing: the checked steps ran every path the window runs (a
        sampled refresh and the step at the settled caps), and the program
        builds no kernel."""

    def step(self):
        t = self.trainer
        traced = torch.autograd._profiler_enabled()
        if traced:
            gen, before = t.generator.get_state(), t.state.occupancy
        m = t.run_step()
        if traced:
            self.traced.append(Traced(gen, before, t.state.occupancy,
                                      t.step - 1, t.sample_cap,
                                      m["rm_samples"]))
        return m["loss"]

    def release(self) -> None:
        self.trainer = None

    # ------------------------------------------------------------ reference

    def _draws(self, generator_state):
        """The trainer's draws from ``generator_state`` on: a refresh's
        and then each checked step's, from the program's own draw
        functions."""
        from taichi_nerfs_torch.models.occupancy import draw_grid_inputs
        from taichi_nerfs_torch.train.step import draw_step

        gen = torch.Generator(self.device)
        gen.set_state(generator_state)
        (grid,) = draw_grid_inputs(self.cfg.model, False, gen, self.device)
        steps = [draw_step(self.cfg, self.data, gen)
                 for _ in range(int(self.traffic["check_steps"]))]
        return grid, steps

    def _rays(self, ref: NGPReference, d):
        o, dirs = ref.rays(self.data.poses, self.K, self.width, d.img_idxs,
                           d.pix_idxs)
        gt = self.gt_u8[d.img_idxs, d.pix_idxs].float() / 255.0
        return o, dirs, gt

    def _program_march(self, d, bitfield, cap: int):
        """The program's march of a step's rays (its own functions on the
        step's draws, as ``render/renderer.py:render_train`` calls them), as
        the reference's ``March``; and the fixed steps the rays span inside
        the box."""
        from taichi_nerfs_torch.ops.marching import (march_rays,
                                                     perturb_t_start,
                                                     valid_mask)
        from taichi_nerfs_torch.ops.rays import get_rays, ray_aabb_intersect
        from taichi_nerfs_torch.train.step import sample_batch

        m, r = self.cfg.model, self.cfg.render
        _, pose, direction = sample_batch(self.data, d.img_idxs, d.pix_idxs)
        o, dirs = get_rays(direction, pose)
        hits = ray_aabb_intersect(o, dirs, m.scale)
        t0 = perturb_t_start(hits, d.t_noise, r.exp_step_factor, m.grid_size,
                             m.scale)
        out = march_rays(o, dirs, t0, hits[:, 1], bitfield,
                         cascades=m.cascades, scale=m.scale,
                         exp_step_factor=r.exp_step_factor,
                         grid_size=m.grid_size, sample_cap=cap)
        dt = SQRT3 / r.max_samples
        span = torch.where(t0 >= 0, torch.clamp(hits[:, 1] - t0, min=0.0),
                           0.0)
        return (March(out.ts, valid_mask(out.counts, cap), out.counts, dt),
                float(span.sum()) / dt)

    def reference(self, tf32: bool = False) -> Readings:
        """The reference from the snapshot: the first step's refresh, then
        each checked step and its Adam update.  Each step marches the
        program's refreshed bits at the program's sample cap (its samples
        counted against the program's); its loss is taken at the program's
        samples, so that a sample on a cell boundary, which either march
        may place in either cell, moves only ``samples_gap``."""
        ref = NGPReference(self.config, tf32=tf32)
        snap = self.snap
        params = {k: v.clone().requires_grad_(True)
                  for k, v in snap.params.items()}
        mu = {k: v.clone() for k, v in snap.mu.items()}
        nu = {k: v.clone() for k, v in snap.nu.items()}
        g, steps = self._draws(snap.generator)
        grid, bits = ref.refresh(params, snap.density, g.coords1, g.keys,
                                 g.noise)
        losses, samples, grad = [], [], None
        kept, tied, theirs_kept = [], [], []
        names = list(params)
        for k, d in enumerate(steps):
            o, dirs, gt = self._rays(ref, d)
            own = ref.march(o, dirs, d.t_noise, self.prog.bits, self.caps[k])
            theirs, _ = self._program_march(d, self.bitfield, self.caps[k])
            loss, vr = ref.loss(params, gt, o, dirs, theirs)
            grads = torch.autograd.grad(loss, [params[n_] for n_ in names])
            grads = dict(zip(names, grads))
            losses.append(float(loss.detach()))
            samples.append((int(own.counts.sum()), vr))
            kept.append(own.kept)
            tied.append(own.tied)
            theirs_kept.append(theirs.steps(own.t0, own.kept.shape[1]))
            if k == 0:
                grad = {n_: v.detach().clone() for n_, v in grads.items()}
            ref.adam(params, grads, mu, nu, snap.count + k, snap.sched + k)
            del grads, loss
        change = {k: float(torch.linalg.vector_norm(params[k].detach()
                                                    - snap.params[k]))
                  for k in names}
        return Readings(losses, grad, change, grid, bits, samples, kept,
                        tied, theirs_kept)

    @staticmethod
    def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
        """``loss_gap``, ``grad_gap``, ``change_gap`` and
        ``grad_diff_median`` as the pyramid's (``systems/pyramid.py``);
        ``grid_gap``: the larger of the refreshed density grid's gap (the
        norm of the difference over the cells any camera sees, over the
        reference's norm there) and the share of cells whose occupancy bit
        differs; ``samples_gap``: over the checked steps, the larger of the
        steps one march kept and the other did not (those the reference
        finds on a cell boundary left out) over the reference's, and the
        relative gap of the samples composited."""
        out = PyramidSession.compare((prog.losses, prog.grad, prog.change),
                                     (ref.losses, ref.grad, ref.change))
        seen = ref.grid >= 0
        diff = torch.linalg.vector_norm((prog.grid - ref.grid)[seen])
        out["grid_gap"] = max(
            float(diff / torch.linalg.vector_norm(ref.grid[seen])),
            float((prog.bits != ref.bits).float().mean()))
        marched = [float(((p ^ r) & ~t).sum()) / max(float(r.sum()), 1.0)
                   for p, r, t in zip(prog.kept, ref.kept, ref.tied)]
        composited = [abs(p[1] - r[1]) / max(r[1], 1)
                      for p, r in zip(prog.samples, ref.samples)]
        out["samples_gap"] = max(marched + composited)
        return out

    def check(self) -> Dict[str, float]:
        """The program's readings against the reference's; its march's
        steps are those the reference took its loss at."""
        ref = self.reference()
        prog = dataclasses.replace(self.prog, kept=ref.theirs)
        return self.compare(prog, ref)

    def control(self) -> Dict[str, float]:
        return self.compare(self.reference(tf32=True), self.reference())

    # -------------------------------------------------------------- counts

    def profiled(self, first: int, n: int):
        """The operations of the profiled steps and the encoder's least
        time at their own samples: each step's march replayed (the
        trainer's draws, the step's own bits and cap), each refresh's
        probes.  Also the program's counter: the samples marched a ray.
        Returns ``(flops, context)``."""
        from taichi_nerfs_torch.models.occupancy import draw_grid_inputs
        from taichi_nerfs_torch.train.step import draw_step

        model = self.config["model"]
        ref = NGPReference(self.config)
        geo, scale = ref.geo, ref.scale
        traced = self.traced[:n]
        totals, bound = {}, 0.0
        gen = torch.Generator(self.device)
        with torch.no_grad():
            for t in traced:
                gen.set_state(t.generator)
                if t.step % self.cfg.train.update_interval == 0:
                    # the window is past the warm-up: sampled refreshes
                    (g,) = draw_grid_inputs(self.cfg.model, False, gen,
                                            self.device)
                    _, xyz = ref.refresh_points(
                        t.before.density_grid.reshape(-1), g.coords1, g.keys,
                        g.noise)
                    bound += counts.encode_bound(
                        (xyz + scale) / (2 * scale), geo, backward=False)[0]
                    counts.add_terms(totals, counts.refresh_terms(
                        model, xyz.shape[0]))
                d = draw_step(self.cfg, self.data, gen)
                o, dirs, _ = self._rays(ref, d)
                m, probes = self._program_march(d, t.after.bitfield,
                                                t.sample_cap)
                ray, j = torch.nonzero(m.valid, as_tuple=True)
                xyz = o[ray] + m.ts[ray, j][:, None] * dirs[ray]
                bound += counts.encode_bound((xyz + scale) / (2 * scale), geo,
                                             backward=True)[0]
                counts.add_terms(totals, counts.step_terms(
                    model, xyz.shape[0], o.shape[0], probes))
        rm = sum(int(t.rm_samples) for t in traced)
        rays = max(len(traced) * self.rays_per_step, 1)
        flops = [(name, f, prec) for (name, prec), f in totals.items()]
        return flops, {"ngp_encode_bound_ms": bound,
                       "ngp_samples_per_ray": rm / rays}
