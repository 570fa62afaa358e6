#!/usr/bin/env python3
"""Quality A/B: deferred vs per-slab shading on the checker scene.

Counterpart of ``scripts/eval_deferred.py`` on the PyTorch port: for each
mode of ``--modes`` the SWR pyramid trains ``--steps`` on the procedural
high-frequency checker, then the held-out views are rendered with the
lattice capped and on the full lattice, and both mean PSNRs print.  The
``deferred`` mode trains and renders through the sweep kernels on the card
(forward and backward every step, forward on every eval frame); the
``normal`` mode (per-slab shading) trains through the slab scan, which
launches neither.  Each mode's line also gives its median step time.

    python3 scripts/torch_eval_deferred.py [--steps 3000] \\
        [--modes normal,deferred] [--crop 128] [--img 128] \\
        [--sigma_res 0] [--n_images 24] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises without
one.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX script's pyramid and chunks; a test shrinks them
LEVELS, N_CHUNKS = (32, 64, 128, 256), 16


def configs(deferred: bool, steps: int, crop: int = 128,
            sigma_res: int = 0):
    """The ``(PyramidConfig, SwrTrainConfig)`` that :func:`run` trains."""
    from taichi_nerfs_torch.models.pyramid import PyramidConfig
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig

    mcfg = PyramidConfig(resolutions=LEVELS, features=8, deferred=deferred,
                         sigma_res=sigma_res)
    tcfg = SwrTrainConfig(crop=crop, lr=2e-2, max_steps=steps,
                          n_chunks=N_CHUNKS)
    return mcfg, tcfg


def run(
    deferred: bool,
    steps: int,
    crop: int = 128,
    img: int = 128,
    sigma_res: int = 0,
    n_images: int = 24,
    device=None,
):
    """Train one mode and evaluate it: (mean full-lattice PSNR, train
    seconds, median step ms)."""
    import torch

    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.train.metrics import psnr as psnr_fn
    from taichi_nerfs_torch.train.swr_step import SwrTrainer

    train = SyntheticSphereDataset(
        n_images=n_images, img_wh=(img, img), variant="checker",
        n_steps=512, device=device,
    )
    test = SyntheticSphereDataset(
        n_images=4, img_wh=(img, img), variant="checker", n_steps=512,
        split="test", device=device,
    )
    mcfg, tcfg = configs(deferred, steps, crop, sigma_res)
    tr = SwrTrainer(mcfg, tcfg, train.rays, train.poses, train.K,
                    train.img_wh, device=device)
    # each step's wall time, ending in the host read of its loss
    step_ms, real_step = [], tr.run_step

    def timed_step(*a, **k):
        t = time.perf_counter()
        m = real_step(*a, **k)
        float(m["loss"])
        step_ms.append((time.perf_counter() - t) * 1e3)
        return m

    tr.run_step = timed_step
    t0 = time.time()
    tr.fit(steps, log_every=max(steps // 4, 1))
    dt = time.time() - t0
    w, h = test.img_wh
    ps, ps_full = [], []
    for i in range(len(test)):
        gt = torch.as_tensor(np.asarray(test.rays[i]).reshape(-1, 3),
                             device=tr.device)
        out = tr.render(test.poses[i], img_wh=(w, h))
        ps.append(float(psnr_fn(out["rgb"], gt)))
        # full-lattice render: no information loss from the lat cap
        out = tr.render(test.poses[i], img_wh=(w, h), lat_cap=None)
        ps_full.append(float(psnr_fn(out["rgb"], gt)))
    print(f"  lat-capped eval: {np.mean(ps):.2f}  "
          f"full-lattice eval: {np.mean(ps_full):.2f}", flush=True)
    return float(np.mean(ps_full)), dt, float(np.median(step_ms))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--modes", default="normal,deferred")
    ap.add_argument("--crop", type=int, default=128)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--sigma_res", type=int, default=0)
    ap.add_argument("--n_images", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    from taichi_nerfs_torch.ops._build import launch_counts
    from taichi_nerfs_torch.utils.device import card_line, resolve_device

    device = resolve_device(args.device, "--device cpu")
    if device.type == "cuda":
        print(card_line(), flush=True)
    for mode in args.modes.split(","):
        psnr, dt, step_ms = run(
            mode == "deferred", args.steps, crop=args.crop,
            img=args.img, sigma_res=args.sigma_res,
            n_images=args.n_images, device=device,
        )
        print(f"{mode}: eval_psnr={psnr:.2f} train_time={dt:.1f}s "
              f"({args.steps} steps, crop {args.crop}) "
              f"step_median={step_ms:.2f}ms", flush=True)
        print(launch_counts(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
