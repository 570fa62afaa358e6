"""Entry points of the port: one flagship forward, and a data-parallel dry
run of the full training cadence.

The counterpart of the repository's ``__graft_entry__.py``.
:func:`entry` returns ``(fn, example_args)`` for the flagship NGP
``render_train`` (``config_for_scene(0.5)``, every cell occupied, 1024
rays, 128 samples a ray).  :func:`dryrun_multichip` runs the training
cadence on ``n`` ranks at a tiny size: a warm-up grid refresh, two
ray-parallel NGP steps and a steady refresh, then one crop-parallel
pyramid step with outside cameras and one with inside cameras (a cubemap
face, the carving mask, per-crop slope bounds).  Rank 0 prints one ``ok``
line for each of the three::

    python -m taichi_nerfs_torch.entry [--device cpu] [--num_devices N]

On the card the ranks are ``cuda:0`` .. ``cuda:N-1`` over NCCL (N defaults
to every visible card); ``--device cuda:0`` puts every rank on that card
over gloo; with ``--device cpu`` they are N gloo processes (N defaults to
2).
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from .config import (
    Config,
    HashGridConfig,
    ModelConfig,
    RenderConfig,
    TrainConfig,
    config_for_scene,
)
from .data.cameras import look_at
from .models.ngp import init_ngp_params
from .models.occupancy import init_occupancy
from .models.pyramid import PyramidConfig
from .ops.math import packbits_u32
from .parallel import (
    launch,
    make_swr_sharded_step,
    sharded_density_grid_step,
    sharded_train_step,
)
from .render.renderer import render_train
from .render.swr import face_slope_bounds
from .train.state import create_train_state, tree_leaves, tree_map
from .train.step import Batch, draw_step
from .train.swr_step import (
    SwrTrainConfig,
    camera_keep_mask,
    create_swr_state,
    draw_bg_and_tv,
)
from .utils.device import resolve_device

N_RAYS = 1024
SAMPLE_CAP = 128


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(params, bitfield, rays_o, rays_d,
    t_noise) -> (rgb, depth, opacity)``, the flagship NGP model's train-time
    render of 1024 random rays through a fully occupied grid, with its
    inputs made from fixed seeds on ``device``."""
    dev = resolve_device(device, 'device="cpu"')
    cfg = config_for_scene(0.5)
    # drawn on the host (the same params on every device), then moved
    params = tree_map(lambda p: p.to(dev), init_ngp_params(
        cfg.model, torch.Generator().manual_seed(0)))
    occ = init_occupancy(cfg.model, dev)
    # every cell occupied, so the march and the field see every sample
    bitfield = packbits_u32(torch.ones_like(occ.density_grid.reshape(-1)),
                            0.5)
    g = torch.Generator().manual_seed(1)
    rays_o = 2.0 * torch.rand((N_RAYS, 3), generator=g) - 1.0
    rays_d = torch.randn((N_RAYS, 3), generator=g)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    t_noise = torch.rand((N_RAYS,), generator=g)

    def fn(params, bitfield, rays_o, rays_d, t_noise):
        out = render_train(params, cfg.model, cfg.render, bitfield, rays_o,
                           rays_d, SAMPLE_CAP, t_noise=t_noise)
        return out["rgb"], out["depth"], out["opacity"]

    return fn, (params, bitfield, rays_o.to(dev), rays_d.to(dev),
                t_noise.to(dev))


def dryrun_config(n: int) -> Config:
    """``__graft_entry__.py``'s tiny dry-run configuration: 16 rays a
    rank."""
    return Config(
        model=ModelConfig(
            scale=0.5,
            grid=HashGridConfig(levels=4, feature_per_level=2, log2_T=10,
                                base_res=4, max_res=32),
            grid_size=32, xyz_net_width=16, rgb_net_width=16,
            mlp_dtype="float32",
        ),
        render=RenderConfig(train_sample_cap=32),
        train=TrainConfig(batch_size=16 * n),
    )


def dryrun_multichip(n: int, device="cuda") -> list:
    """The training cadence on ``n`` ranks (see the module docstring).

    ``device="cuda"`` puts rank r on ``cuda:r`` over NCCL; an indexed card
    (``"cuda:0"``) or ``"cpu"`` runs the ranks over gloo.  Returns each
    rank's ``{"loss", "occ_bits", "swr_loss", "swr_inside_loss",
    "params"}``, the params of the three trained states on the host."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" and dev.index is None else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        return launch(_dryrun_rank, n, device=device, backend=backend,
                      rendezvous_dir=tmp)


def _host(tree):
    return [t.detach().cpu() for t in tree_leaves(tree)]


def _dryrun_rank(mesh):
    n, dev = mesh.size, mesh.device
    cfg = dryrun_config(n)
    rng = np.random.RandomState(0)
    pose = np.concatenate([np.eye(3), [[0], [0], [-1.5]]], axis=1)
    data = Batch(
        rays=torch.tensor(rng.uniform(0, 1, (3, 64, 3)), dtype=torch.float32,
                          device=dev),
        poses=torch.tensor(np.stack([pose] * 3), dtype=torch.float32,
                           device=dev),
        directions=torch.tensor(rng.uniform(-0.3, 0.3, (64, 3)) + [0, 0, 1],
                                dtype=torch.float32, device=dev),
    )
    # the same stream on every rank: the full batch and the cells
    gen = torch.Generator(dev).manual_seed(cfg.train.seed)
    state = create_train_state(cfg, device=dev)
    state = sharded_density_grid_step(state, cfg, mesh, True, gen)
    for _ in range(2):
        state, metrics = sharded_train_step(state, data, cfg, mesh, 32, None,
                                            draw_step(cfg, data, gen))
    state = sharded_density_grid_step(state, cfg, mesh, False, gen)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss: {loss}")
    words = state.occupancy.bitfield.cpu().numpy()
    occ_bits = int(np.unpackbits(words.view(np.uint8)).sum())
    if mesh.rank == 0:
        print(f"dryrun_multichip({n}): ok, loss={loss:.4f}, "
              f"occ_bits={occ_bits}", flush=True)
    swr_loss, swr_params, in_loss, in_params = _dryrun_swr_rank(mesh)
    return {"loss": loss, "occ_bits": occ_bits, "swr_loss": swr_loss,
            "swr_inside_loss": in_loss,
            "params": _host(state.params) + swr_params + in_params}


def _own_draws(r, tcfg, mcfg, params, dev):
    """Rank ``r``'s background (or None) and TV window starts."""
    bg, starts = draw_bg_and_tv(tcfg, mcfg, params,
                                torch.Generator(dev).manual_seed(r),
                                torch.Generator().manual_seed(r), dev)
    return {"bg": bg, "tv_starts": starts}


def _dryrun_swr_rank(mesh):
    """The crop-parallel pyramid step, outside then inside cameras."""
    n, r, dev = mesh.size, mesh.rank, mesh.device
    mcfg = PyramidConfig(resolutions=(8, 16), features=4, rgb_width=16,
                         deferred=True)
    tcfg = SwrTrainConfig(crop=16, max_steps=10, n_chunks=4)
    state = create_swr_state(mcfg, tcfg, torch.Generator().manual_seed(0),
                             dev)
    rng = np.random.RandomState(0)
    pose = np.concatenate([np.diag([1.0, -1.0, -1.0]), [[0.0], [0.0], [1.5]]],
                          axis=1).astype(np.float32)
    K = np.array([[24.0, 0, 12.0], [0, 24.0, 12.0], [0, 0, 1.0]], np.float32)
    images = torch.tensor(rng.uniform(0, 1, (n, 24, 24, 3)),
                          dtype=torch.float32, device=dev)
    step = make_swr_sharded_step(mcfg, tcfg, mesh, axis=2, flip=True)
    state, metrics = step(state, images[r], pose, K, (0, 0),
                          **_own_draws(r, tcfg, mcfg, state.params, dev))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite swr loss: {loss}")
    if r == 0:
        print(f"dryrun_swr_multichip({n}): ok, loss={loss:.4f}", flush=True)

    # inside cameras: one cubemap face, the carving mask, per-crop bounds
    tcfg_in = dataclasses.replace(tcfg, random_bg=True, cam_carve=0.1)
    K_in = np.array([[16.0, 0, 12.0], [0, 16.0, 12.0], [0, 0, 1.0]],
                    np.float32)
    poses, bounds = [], []
    for i in range(n):
        eye = np.array([0.05, 0.02 * i - 0.07, 0.03])
        p = look_at(eye, eye + np.array([1.0, 0.0, 0.0]),
                    np.array([0.0, 0.0, 1.0])).astype(np.float32)
        b = face_slope_bounds(p, K_in, (16, 16), 0, 1.0, crop_xy=(4, 4))
        if b is None:
            raise AssertionError(f"camera {i} has no pixel on face +x")
        poses.append(p)
        bounds.append(np.asarray(b, np.float32))
    keep = torch.tensor(camera_keep_mask(np.stack(poses), mcfg.grid_res,
                                         0.1, mcfg.scale), device=dev)
    images = torch.tensor(rng.uniform(0, 1, (n, 24, 24, 3)),
                          dtype=torch.float32, device=dev)
    step_in = make_swr_sharded_step(mcfg, tcfg_in, mesh, axis=0, flip=False,
                                    inside=True, with_sigma_keep=True,
                                    with_slope_bounds=True)
    state_in = create_swr_state(mcfg, tcfg_in,
                                torch.Generator().manual_seed(3), dev)
    state_in, m_in = step_in(
        state_in, images[r], poses[r], K_in, (4, 4), keep, bounds[r],
        **_own_draws(n + r, tcfg_in, mcfg, state_in.params, dev))
    loss_in = float(m_in["loss"])
    if not np.isfinite(loss_in):
        raise AssertionError(f"non-finite inside swr loss: {loss_in}")
    if r == 0:
        print(f"dryrun_swr_multichip({n}) inside-camera: ok, "
              f"loss={loss_in:.4f}", flush=True)
    return loss, _host(state.params), loss_in, _host(state_in.params)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), cuda:<i> or cpu")
    ap.add_argument("--num_devices", type=int, default=0,
                    help="ranks of the dry run; 0: every visible card (2 on "
                         "the CPU)")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    with torch.no_grad():
        out = fn(*example)
    print("entry: ok", [tuple(o.shape) for o in out], flush=True)
    dev = torch.device(args.device)
    n = args.num_devices or (torch.cuda.device_count() if dev.type == "cuda"
                             else 2)
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
