#!/usr/bin/env python3
"""Hyperparameter sweep for the SWR pyramid on the 800^2 checker proxy.

Counterpart of ``scripts/sweep_swr.py`` on the PyTorch port: each entry of
:data:`SWEEPS` (lr, tv_w, sigma_l1, features, steps, distortion, near over
the base) trains a fresh ``SwrTrainer`` back to back in one process on one
dataset built in :func:`main`, and prints its train time (``fit``, then
one more step read on the host), its last training PSNR and the mean
held-out PSNR of uncapped renders.  Both shipped entries set
``distortion_w > 0``, so they train through the slab scan; the eval frames
(deferred, unsplit) run the sweep forward kernel on the card.  An entry's
``steps`` overrides ``--steps``.

    python3 scripts/torch_sweep_swr.py [--img 800] [--n_images 100] \\
        [--steps 1900] [--variant checker] [--device cpu]

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
# the JAX script's pyramid; a test shrinks it
LEVELS = (32, 64, 128, 256)
# (name, overrides of the base); the JAX script's shipped list
SWEEPS = [
    ("f16 dist1e-2 near.1", {"features": 16, "steps": 3000,
                             "distortion_w": 1e-2, "near": 0.1}),
    ("f16 dist2e-3 near.1", {"features": 16, "steps": 3000,
                             "distortion_w": 2e-3, "near": 0.1}),
]


def base_config(steps: int) -> dict:
    """The base every entry of :data:`SWEEPS` overrides."""
    return dict(steps=steps, lr=2e-2, tv_w=3e-3, sigma_l1=1e-5, features=8)


def configs(*, steps, lr, tv_w, sigma_l1, features, sigma_res=0, crop=256,
            n_chunks=16, resample_dtype="float32", prog=(),
            distortion_w=0.0, near=0.0):
    """The ``(PyramidConfig, SwrTrainConfig)`` that :func:`run_cfg`
    trains."""
    from taichi_nerfs_torch.models.pyramid import PyramidConfig
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig

    mcfg = PyramidConfig(resolutions=LEVELS, features=features,
                         deferred=True, sigma_res=sigma_res)
    tcfg = SwrTrainConfig(
        crop=crop, lr=lr, max_steps=steps, n_chunks=n_chunks, tv_w=tv_w,
        sigma_l1=sigma_l1, resample_dtype=resample_dtype,
        prog_steps=tuple(prog), distortion_w=distortion_w, near=near,
    )
    return mcfg, tcfg


def run_cfg(train, test, *, device=None, **cfg):
    """Train one configuration (``cfg``: :func:`configs`'s keywords) on
    ``train`` and evaluate it on ``test``: (mean held-out PSNR, train
    seconds, last training PSNR)."""
    import torch

    from taichi_nerfs_torch.train.metrics import psnr as psnr_fn
    from taichi_nerfs_torch.train.swr_step import SwrTrainer

    mcfg, tcfg = configs(**cfg)
    tr = SwrTrainer(mcfg, tcfg, train.rays, train.poses, train.K,
                    train.img_wh, device=device)
    t0 = time.time()
    tr.fit(cfg["steps"], log_every=10**9, log_fn=lambda *_: None)
    tr_psnr = float(tr.run_step()["psnr"])  # waits for the device
    dt = time.time() - t0
    w, h = test.img_wh
    ps = []
    for i in range(len(test)):
        out = tr.render(test.poses[i], img_wh=(w, h), lat_cap=None)
        gt = torch.as_tensor(np.asarray(test.rays[i]).reshape(-1, 3),
                             device=out["rgb"].device)
        ps.append(float(psnr_fn(out["rgb"], gt)))
    return float(np.mean(ps)), dt, tr_psnr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--img", type=int, default=800)
    ap.add_argument("--n_images", type=int, default=100)
    ap.add_argument("--steps", type=int, default=1900)
    ap.add_argument("--variant", type=str, default="checker",
                    choices=["sphere", "checker", "shell"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.ops._build import launch_counts
    from taichi_nerfs_torch.utils.device import card_line, resolve_device

    device = resolve_device(args.device, "--device cpu")
    if device.type == "cuda":
        print(card_line(), flush=True)
    train = SyntheticSphereDataset(
        n_images=args.n_images, img_wh=(args.img, args.img),
        variant=args.variant, n_steps=512, device=device,
    )
    test = SyntheticSphereDataset(
        n_images=4, img_wh=(args.img, args.img), variant=args.variant,
        n_steps=512, split="test", device=device,
    )
    for name, over in SWEEPS:
        cfg = {**base_config(args.steps), **over}
        psnr, dt, tr_psnr = run_cfg(train, test, device=device, **cfg)
        print(
            f"{name}: eval={psnr:5.2f}  train_psnr={tr_psnr:5.2f}  "
            f"time={dt:6.1f}s  ({cfg})",
            flush=True,
        )
    print(launch_counts(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
