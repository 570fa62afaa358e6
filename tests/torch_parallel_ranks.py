"""Rank functions of the data-parallel tests and the set-ups they share
with their one-process references.

The ranks are spawned processes (``taichi_nerfs_torch.parallel.launch``)
that import this module by name, so it imports torch and the port only,
never JAX.  Each rank function takes the mesh first and the parent's torch
thread count next, so a rank computes with as many threads as the parent.
Every result comes back on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from taichi_nerfs_torch import config as tc
from taichi_nerfs_torch.data.cameras import look_at
from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.models.occupancy import draw_grid_inputs
from taichi_nerfs_torch.ops.math import (
    grid_coords_np,
    morton3d_np,
    packbits_u32,
)
from taichi_nerfs_torch.parallel import (
    make_swr_sharded_step,
    sharded_density_grid_step,
    sharded_train_step,
)
from taichi_nerfs_torch.render.swr import face_slope_bounds
from taichi_nerfs_torch.train import state as tstate
from taichi_nerfs_torch.train import step as tstep
from taichi_nerfs_torch.train import swr_step as tsw
from taichi_nerfs_torch.train.loop import Trainer

NGP_SAMPLE_CAP = 32


def host(tree):
    """A tree's leaves, detached copies on the host."""
    return [t.detach().cpu().clone() for t in tstate.tree_leaves(tree)]


def failing_rank(mesh, threads):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh.all_sum(torch.zeros(1))
    return mesh.rank


# ------------------------------------------------------------------ NGP


def tiny_ngp_config(cfg: tc.Config) -> tc.Config:
    """``cfg`` shrunk to a CPU size, its model family and encoder kept."""
    return cfg.replace(
        model=cfg.model.replace(
            grid_size=16, xyz_net_width=16, rgb_net_width=16,
            grid=dataclasses.replace(cfg.model.grid, log2_T=11),
            brick=dataclasses.replace(cfg.model.brick, levels=2,
                                      log2_rows=10, max_res=32),
            triplane=dataclasses.replace(cfg.model.triplane, levels=2,
                                         max_res=32)),
        render=dataclasses.replace(cfg.render, train_sample_cap=64,
                                   test_chunk_samples=16),
        train=dataclasses.replace(cfg.train, warmup_steps=4,
                                  update_interval=2),
    )


def tiny_ngp_rank_main(mesh, argv):
    """The train entry's rank with :func:`tiny_ngp_config`; it also writes
    its trainer's params to ``params_rank<r>.pt`` in the working
    directory, so a test can compare the ranks."""
    import taichi_nerfs_torch.train.__main__ as entry

    real = entry.config_from_opts
    entry.config_from_opts = lambda hp: tiny_ngp_config(real(hp))
    made = []
    for name in ("Trainer", "SwrTrainer"):
        def make(*a, _cls=getattr(entry, name), **kw):
            made.append(_cls(*a, **kw))
            return made[-1]

        setattr(entry, name, make)
    out = entry._rank_main(mesh, argv)
    torch.save(host(made[0].state.params), f"params_rank{mesh.rank}.pt")
    return out


def same_params_on_every_rank(path, n: int = 2) -> bool:
    """Whether the ``params_rank<r>.pt`` of :func:`tiny_ngp_rank_main` in
    ``path`` are bitwise equal."""
    ps = [torch.load(f"{path}/params_rank{r}.pt") for r in range(n)]
    return all(torch.equal(a, b) for p in ps[1:]
               for a, b in zip(ps[0], p, strict=True))


def ngp_setup(enc: str):
    """``tests/test_sharding.py``'s tiny configuration (grid 16, 2 levels,
    batch 64, distortion on) with encoder ``enc``, its data, a fresh state
    with a ball of occupied cells, and one step's draws."""
    cfg = tc.Config(
        model=tc.ModelConfig(
            scale=0.5, pos_encoder_type=enc,
            grid=tc.HashGridConfig(levels=2, feature_per_level=2, log2_T=9,
                                   base_res=4, max_res=16),
            brick=tc.BrickGridConfig(levels=2, feature_per_level=4,
                                     log2_rows=9, base_res=4, max_res=16),
            grid_size=16, xyz_net_width=16, rgb_net_width=16,
            mlp_dtype="float32"),
        render=tc.RenderConfig(train_sample_cap=NGP_SAMPLE_CAP),
        train=tc.TrainConfig(batch_size=64, distortion_loss_w=1e-3),
    )
    rng = np.random.RandomState(0)
    pose = np.concatenate([np.eye(3), [[0], [0], [-1.5]]], 1)
    data = tstep.Batch(
        rays=torch.tensor(rng.uniform(0, 1, (3, 64, 3)), dtype=torch.float32),
        poses=torch.tensor(np.stack([pose] * 3), dtype=torch.float32),
        directions=torch.tensor(rng.uniform(-0.3, 0.3, (64, 3)) + [0, 0, 1],
                                dtype=torch.float32),
    )
    state = tstate.create_train_state(cfg)
    state = state._replace(occupancy=state.occupancy._replace(
        bitfield=ball_bitfield(cfg.model.grid_size)))
    draws = tstep.draw_step(cfg, data, torch.Generator().manual_seed(1))
    return cfg, data, state, draws


def ball_bitfield(g: int) -> torch.Tensor:
    """The bitfield of a ball of radius 0.3 (the cells of centre within)."""
    c = grid_coords_np(g)
    centres = ((c + 0.5) / g * 2 - 1) * 0.5
    dens = np.zeros(g**3, np.float32)
    dens[morton3d_np(c)] = np.linalg.norm(centres, axis=1) < 0.3
    return packbits_u32(torch.tensor(dens), 0.5)


def grid_draws(cfg, warmup: bool):
    """A refresh's draws (every rank and the reference make the same)."""
    return draw_grid_inputs(cfg.model, warmup,
                            torch.Generator().manual_seed(5 + warmup))


def step_result(state, metrics):
    return {"metrics": {k: v.detach().cpu() for k, v in metrics.items()},
            "params": host(state.params), "mu": host(state.opt_state.mu),
            "nu": host(state.opt_state.nu)}


def ngp_rank_cases(mesh, threads, pack_cap):
    """The sharded NGP step for the hash and brick encoders, the hash step
    with the global ``pack_cap``, and the warm-up and steady refreshes."""
    torch.set_num_threads(threads)
    out = {}
    for name, enc, cap in (("hash", "hash", None), ("brick", "brick", None),
                           ("packed", "hash", pack_cap)):
        cfg, data, state, draws = ngp_setup(enc)
        out[name] = step_result(*sharded_train_step(
            state, data, cfg, mesh, NGP_SAMPLE_CAP, cap, draws))
    cfg, _, state, _ = ngp_setup("hash")
    grids = []
    for warmup in (True, False):
        state = sharded_density_grid_step(state, cfg, mesh, warmup,
                                          draws=grid_draws(cfg, warmup))
        grids.append((state.occupancy.density_grid.clone(),
                      state.occupancy.bitfield.clone()))
    out["grids"] = grids
    return out


def ngp_step_rank(mesh, threads, cfg, data, params, bitfield, draws):
    """One sharded step from ``params`` (numpy-made, fresh Adam) and
    ``bitfield`` on the full ``draws``."""
    torch.set_num_threads(threads)
    from taichi_nerfs_torch.models.occupancy import init_occupancy

    params = tstate.trainable(params)
    state = tstate.TrainState(
        params, tstate.make_optimizer(cfg).init(params),
        init_occupancy(cfg.model)._replace(bitfield=bitfield))
    return step_result(*sharded_train_step(state, data, cfg, mesh,
                                           NGP_SAMPLE_CAP, None, draws))


def ngp_trainer_config():
    """A tiny trainer configuration whose 6 steps take the warm-up and the
    steady refresh."""
    return tc.Config(
        model=tc.ModelConfig(
            scale=0.5, grid=tc.HashGridConfig(levels=2, feature_per_level=2,
                                              log2_T=9, base_res=4,
                                              max_res=16),
            grid_size=16, xyz_net_width=16, rgb_net_width=16,
            mlp_dtype="float32"),
        render=tc.RenderConfig(train_sample_cap=NGP_SAMPLE_CAP),
        train=tc.TrainConfig(batch_size=64, warmup_steps=2,
                             update_interval=2),
    )


def ngp_scene():
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset

    return SyntheticSphereDataset(n_images=3, img_wh=(16, 16), device="cpu")


def ngp_trainer_rank(mesh, threads, steps):
    """``Trainer(mesh=...)`` for ``steps`` steps: the losses, the caps and
    the params."""
    torch.set_num_threads(threads)
    scene = ngp_scene()
    tr = Trainer(ngp_trainer_config(), scene.as_batch("cpu"), scene.K,
                 scene.img_wh, mesh=mesh, log_fn=lambda s: None)
    losses, caps = [], []
    for _ in range(steps):
        losses.append(float(tr.run_step()["loss"]))
        caps.append((tr.sample_cap, tr.pack_cap))
    return {"losses": losses, "caps": caps, "params": host(tr.state.params),
            "bitfield": tr.state.occupancy.bitfield.clone()}


# -------------------------------------------------------------- pyramid

SWR_MCFG = tpyr.PyramidConfig(resolutions=(8, 16), features=4,
                              rgb_width=16, deferred=True)


class SwrCase(NamedTuple):
    """One crop-parallel configuration, with every rank's inputs for
    ``steps`` steps made from seeds."""

    tcfg: tsw.SwrTrainConfig
    axis: int
    flip: bool
    inside: bool
    sigma_keep: torch.Tensor | None
    images: torch.Tensor  # (n, H, W, 3)
    poses: list
    K: np.ndarray
    crops: np.ndarray  # (steps, n, 2)
    bounds: list | None  # per rank (2, 2)

    def state(self):
        return tsw.create_swr_state(SWR_MCFG, self.tcfg,
                                    torch.Generator().manual_seed(0), "cpu")

    def own_draws(self, s: int, r: int, params):
        """Rank ``r``'s background and TV window starts at step ``s``."""
        g = torch.Generator().manual_seed(1000 * s + r)
        return tsw.draw_bg_and_tv(self.tcfg, SWR_MCFG, params, g, g, "cpu")

    def loss_fn(self, s: int, r: int, params):
        """The loss of rank ``r``'s crop at step ``s``."""
        bg, starts = self.own_draws(s, r, params)
        return tsw.make_swr_loss(
            self.images[r], self.poses[r], self.K, tuple(self.crops[s, r]),
            SWR_MCFG, self.tcfg, self.axis, self.flip, bg, starts,
            inside=self.inside, sigma_keep=self.sigma_keep,
            slope_bounds=None if self.bounds is None else self.bounds[r])

    def run_rank(self, mesh, s: int, step, state):
        r = mesh.rank
        bg, starts = self.own_draws(s, r, state.params)
        extra = ([self.sigma_keep] if self.sigma_keep is not None else []) + (
            [self.bounds[r]] if self.bounds is not None else [])
        return step(state, self.images[r], self.poses[r], self.K,
                    tuple(self.crops[s, r]), *extra, bg=bg,
                    tv_starts=starts)


def swr_case(kind: str, n: int, steps: int = 2) -> SwrCase:
    """``tests/test_sharding.py``'s crop-parallel configurations: outside
    cameras sharing (axis 2, flip), here with random backgrounds; inside
    cameras on face +x with the carving mask and per-crop slope bounds."""
    rng = np.random.RandomState(0)
    images = torch.tensor(rng.uniform(0, 1, (n, 24, 24, 3)),
                          dtype=torch.float32)
    if kind == "outside":
        tcfg = tsw.SwrTrainConfig(crop=16, max_steps=10, n_chunks=4,
                                  tv_w=1e-3, random_bg=True)
        pose = np.eye(3, 4, dtype=np.float32)
        pose[:, :3] = np.diag([1.0, -1.0, -1.0])
        pose[2, 3] = 1.5
        K = np.array([[20.0, 0, 12], [0, 20.0, 12], [0, 0, 1]], np.float32)
        return SwrCase(tcfg, 2, True, False, None, images, [pose] * n, K,
                       rng.randint(0, 8, (steps, n, 2)), None)
    tcfg = tsw.SwrTrainConfig(crop=16, max_steps=10, n_chunks=4,
                              random_bg=True, cam_carve=0.1)
    K = np.array([[16.0, 0, 12], [0, 16.0, 12], [0, 0, 1]], np.float32)
    poses, bounds = [], []
    for i in range(n):
        eye = np.array([0.05, 0.02 * i - 0.07, 0.03])
        p = look_at(eye, eye + np.array([1.0, 0.0, 0.0]),
                    np.array([0.0, 0.0, 1.0])).astype(np.float32)
        poses.append(p)
        bounds.append(np.asarray(face_slope_bounds(p, K, (16, 16), 0, 1.0,
                                                   crop_xy=(4, 4)),
                                 np.float32))
    keep = torch.tensor(tsw.camera_keep_mask(np.stack(poses),
                                             SWR_MCFG.grid_res, 0.1,
                                             SWR_MCFG.scale))
    return SwrCase(tcfg, 0, False, True, keep, images, poses, K,
                   np.full((steps, n, 2), 4), bounds)


def swr_rank_cases(mesh, threads, steps=2):
    """Each :func:`swr_case` trained ``steps`` crop-parallel steps."""
    torch.set_num_threads(threads)
    out = {}
    for kind in ("outside", "inside"):
        case = swr_case(kind, mesh.size, steps)
        step = make_swr_sharded_step(
            SWR_MCFG, case.tcfg, mesh, case.axis, case.flip,
            inside=case.inside, with_sigma_keep=case.sigma_keep is not None,
            with_slope_bounds=case.bounds is not None)
        state, losses = case.state(), []
        for s in range(steps):
            state, m = case.run_rank(mesh, s, step, state)
            losses.append(float(m["loss"]))
        out[kind] = {"losses": losses, "params": host(state.params)}
    return out


def swr_rig(kind: str):
    """A small rig for ``SwrTrainer``: the sphere's 8 views at 32x32
    (``kind="inside"``: half of them moved inside the cube, random
    backgrounds and carving), levels (8, 16) grown after 2 steps."""
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset

    scene = SyntheticSphereDataset(n_images=8, img_wh=(32, 32), device="cpu")
    poses = np.array(scene.poses, np.float32)
    tkw = dict(crop=16, lr=5e-2, max_steps=40, n_chunks=4,
               resample_kind="cubic", prog_steps=(2,))
    if kind == "inside":
        poses[4:, :, 3] = [[0.05, 0.0, -0.2], [-0.1, 0.05, 0.1],
                           [0.0, -0.1, 0.05], [0.1, 0.1, 0.0]]
        tkw.update(random_bg=True, cam_carve=0.1)
    return dict(mcfg=SWR_MCFG, tcfg=tsw.SwrTrainConfig(**tkw),
                images=np.asarray(scene.rays), poses=poses, K=scene.K,
                img_wh=scene.img_wh,
                alphas=np.asarray(scene.alphas) if kind == "inside" else None)


def swr_trainer(rig, mesh=None):
    return tsw.SwrTrainer(rig["mcfg"], rig["tcfg"], rig["images"],
                          rig["poses"], rig["K"], rig["img_wh"],
                          alphas=rig["alphas"], seed=7, mesh=mesh,
                          device=None if mesh is not None else "cpu")


def swr_trainer_rank(mesh, threads, rig, steps):
    """``SwrTrainer(mesh=...)`` on ``rig`` (:func:`swr_rig`'s keys; a name
    means that rig) for ``steps`` steps: each step's draw, the losses, the
    params and (rank 0) a finite render."""
    torch.set_num_threads(threads)
    tr = swr_trainer(swr_rig(rig) if isinstance(rig, str) else rig, mesh)
    draws, losses = [], []
    for _ in range(steps):
        tr._advance_phases()
        d = tr.draw_sharded()
        losses.append(float(tr.run_step(d)["loss"]))
        draws.append(d)
    out = {"draws": draws, "losses": losses, "params": host(tr.state.params)}
    if mesh.rank == 0:
        out["render_finite"] = bool(torch.isfinite(
            tr.render(tr.poses_np[1])["rgb"]).all())
    return out
