#!/usr/bin/env python3
"""The sample-gather (NGP) train step of the PyTorch port, piece by piece.

Counterpart of ``scripts/profile_parity.py``: the flagship ``Config()``
(batch 8192) on 8 checker views at 256x256, settled for 40 steps (grid
refreshes and caps as in a real run), then ``march_rays`` alone, the
``render_train`` forward, its forward + backward (the loss gradient) on
one drawn batch, and ``Trainer.run_step`` over 40 steps with rays/s: the
cost profile of ``python -m taichi_nerfs_torch.train --model_name ngp``.
This path has no hand-written kernel.

Each call is timed with CUDA events behind ``torch.cuda.synchronize()``;
each piece prints its median and min-max over the repeats.  ``--reps N``
caps every piece's timed repeats and warm-ups at N (default:
``profile_parity.py``'s counts; the settling steps are not repeats).

    python3 scripts/torch_profile_parity.py [--reps 3] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises without
one.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX script's scene and settling steps; a test shrinks them
N_VIEWS, RES, SETTLE = 8, 256, 40


def config():
    """The profiled configuration: the flagship ``Config()``."""
    from taichi_nerfs_torch.config import Config

    return Config()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=0,
                    help="cap every piece's repeats and warm-ups at this "
                         "many (0: profile_parity.py's counts)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    import torch

    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.ops.marching import march_rays, perturb_t_start
    from taichi_nerfs_torch.ops.rays import get_rays, ray_aabb_intersect
    from taichi_nerfs_torch.ops._build import launch_counts
    from taichi_nerfs_torch.render.renderer import render_train
    from taichi_nerfs_torch.train.loop import Trainer
    from taichi_nerfs_torch.train.state import tree_leaves
    from taichi_nerfs_torch.train.step import draw_step, sample_batch
    from taichi_nerfs_torch.utils.device import card_line, resolve_device
    from taichi_nerfs_torch.utils.profiling import spread, time_calls

    device = resolve_device(args.device, "--device cpu")
    if device.type == "cuda":
        print(card_line(), flush=True)

    def reps(n, warm):
        return (min(n, args.reps), min(warm, args.reps)) if args.reps \
            else (n, warm)

    cfg = config()
    scene = SyntheticSphereDataset(n_images=N_VIEWS, img_wh=(RES, RES),
                                   variant="checker", n_steps=256,
                                   device=device)
    trainer = Trainer(cfg, scene.as_batch(device), scene.K, scene.img_wh,
                      log_fn=lambda *a, **k: None, device=device)
    # settle the grid and the caps as a real run does
    for _ in range(SETTLE):
        m = trainer.run_step()
    float(m["loss"])
    sample_cap, pack_cap = trainer.sample_cap, trainer.pack_cap
    print(f"settled: sample_cap={sample_cap} pack_cap={pack_cap}",
          flush=True)

    state, data = trainer.state, trainer.data
    draws = draw_step(cfg, data, torch.Generator(device).manual_seed(7))
    rgb_gt, pose, direction = sample_batch(data, draws.img_idxs,
                                           draws.pix_idxs)
    rays_o, rays_d = get_rays(direction, pose)
    bitfield = state.occupancy.bitfield
    mcfg, rcfg = cfg.model, cfg.render

    hits = ray_aabb_intersect(rays_o, rays_d, mcfg.scale)
    t_start = perturb_t_start(hits, draws.t_noise, rcfg.exp_step_factor,
                              mcfg.grid_size, mcfg.scale)

    def march():
        march_rays(rays_o, rays_d, t_start, hits[:, 1], bitfield,
                   cascades=mcfg.cascades, scale=mcfg.scale,
                   exp_step_factor=rcfg.exp_step_factor,
                   grid_size=mcfg.grid_size, sample_cap=sample_cap)

    def render(p):
        return render_train(p, mcfg, rcfg, bitfield, rays_o, rays_d,
                            sample_cap, pack_cap, t_noise=draws.t_noise,
                            bg=draws.bg)

    def fwd():
        with torch.no_grad():
            render(state.params)

    leaves = tree_leaves(state.params)

    def fwd_bwd():
        loss = torch.mean((render(state.params)["rgb"] - rgb_gt) ** 2)
        torch.autograd.grad(loss, leaves)

    for name, fn in (("march_rays", march), ("render_train fwd", fwd),
                     ("render_train fwd+bwd", fwd_bwd)):
        n, warm = reps(20, 3)
        print(f"{name:<22} {spread(time_calls(fn, n, warm, device))}",
              flush=True)

    # the whole step through the Trainer (optimizer, metrics, the grid
    # refresh every update_interval steps and its caps' host read)
    n, _ = reps(40, 0)
    ms = time_calls(trainer.run_step, n, 0, device)
    med_s = sorted(ms)[len(ms) // 2] / 1e3
    print(f"{'trainer.run_step':<22} {spread(ms)} "
          f"({cfg.train.batch_size / med_s / 1e3:.0f}K rays/s)", flush=True)
    print(launch_counts(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
