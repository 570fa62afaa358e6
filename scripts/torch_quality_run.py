#!/usr/bin/env python3
"""Chunked lego-proxy quality run on the PyTorch port, resumable across
invocations.

Counterpart of ``scripts/quality_run.py``, with its flags and defaults.
Each invocation resumes from ``--state`` (if it exists: the trainer's
light checkpoint, ``SwrTrainer.save_state``, plus ``<state>.meta.json``
with the train wall so far), trains until ``--total_steps`` or ``--wall``
seconds, checkpoints and prints ``PAUSED`` or ``TRAIN DONE``; when training
is complete it evaluates the held-out views, prints the ``RECORD:`` line
and writes ``results/model_pyramid.npz`` and
``results/model_pyramid.manifest.json`` (relative to the working
directory).  Drive it repeatedly under any per-process wall limit:

    python3 scripts/torch_quality_run.py --total_steps 4200 --wall 480 \\
        --pyramid_levels 32,64,128,256,512 --fine_features 4 \\
        --bake_dtype bfloat16 --state /path/to/q.pt [--device cpu]

``--state`` defaults to ``quality_run_state.pt`` in the working directory
(the JAX script's default is a file under ``/tmp``).

The wall clock is read after a host read of the loss every 25 steps and at
the end, so it is device time on the card (kernels run asynchronously).
Both sweep kernels run on the card: the forward in every step and eval
frame, the backward in every step.  It runs on the card unless ``--device
cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--total_steps", type=int, default=4200)
    ap.add_argument("--wall", type=float, default=480.0)
    ap.add_argument("--state", default="quality_run_state.pt")
    ap.add_argument("--pyramid_levels", default="32,64,128,256,512")
    ap.add_argument("--features", type=int, default=8)
    ap.add_argument("--fine_features", type=int, default=4)
    ap.add_argument("--level_features", default="",
                    help="explicit comma list (overrides fine_features)")
    ap.add_argument("--bake_dtype", default="bfloat16")
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--sigma_l1", type=float, default=1e-5)
    ap.add_argument("--tv_w", type=float, default=3e-3)
    ap.add_argument("--distortion_w", type=float, default=0.0)
    ap.add_argument("--cam_carve", type=float, default=0.0)
    ap.add_argument("--random_bg", action="store_true",
                    help="composite pred AND alpha-aware GT over random "
                         "backgrounds")
    ap.add_argument("--alpha_w", type=float, default=0.0,
                    help="direct opacity-vs-GT-alpha supervision weight")
    ap.add_argument("--resample_kind", default="linear",
                    choices=["linear", "cubic"],
                    help="sweep interpolation kernel")
    ap.add_argument("--prog", default="auto")
    ap.add_argument("--eval_views", type=int, default=0)
    ap.add_argument("--eval_now", action="store_true",
                    help="skip training; evaluate the resumed state")
    ap.add_argument("--views", type=int, default=100)
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--scene", default="lego")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    return ap


def configs(args):
    """``(spec, mcfg, tcfg)`` of the flags, as ``scripts/quality_run.py``
    builds them."""
    from taichi_nerfs_torch.models.pyramid import PyramidConfig
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig

    spec = f"synthetic://{args.scene}?views={args.views}&res={args.res}"
    levels = tuple(int(x) for x in args.pyramid_levels.split(","))
    if args.level_features:
        lf = tuple(int(x) for x in args.level_features.split(","))
    elif args.fine_features:
        lf = (args.features,) * (len(levels) - 1) + (args.fine_features,)
    else:
        lf = ()
    mcfg = PyramidConfig(resolutions=levels, features=args.features,
                         deferred=True, level_features=lf)
    T = args.total_steps
    if args.prog == "auto":
        prog = (max(T * 3 // 16, 1), max(T * 9 // 40, 1))
    elif args.prog:
        prog = tuple(int(x) for x in args.prog.split(",") if x)
    else:
        prog = ()
    tcfg = SwrTrainConfig(
        crop=256, lr=args.lr, max_steps=T, prog_steps=prog,
        bake_dtype=args.bake_dtype,
        adam_mu_bf16=args.bake_dtype == "bfloat16",
        sigma_l1=args.sigma_l1, tv_w=args.tv_w,
        distortion_w=args.distortion_w, cam_carve=args.cam_carve,
        random_bg=args.random_bg, alpha_w=args.alpha_w,
        resample_kind=args.resample_kind,
    )
    return spec, mcfg, tcfg


def config_blob(spec, mcfg, tcfg) -> str:
    """The manifest's ``config``: plain JSON of both configs (tuples as
    lists) and the scene spec, which ``torch_publish_record.py`` rebuilds
    with the constructors."""

    def _cfg_dict(c):
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(c).items()}

    return json.dumps({"mcfg": _cfg_dict(mcfg), "tcfg": _cfg_dict(tcfg),
                       "spec": spec}, sort_keys=True)


def _git_commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"],
                              capture_output=True, text=True,
                              cwd=_REPO).stdout.strip()
    except OSError:
        return ""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    sys.path.insert(0, _REPO)
    import torch

    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.ops._build import launch_counts
    from taichi_nerfs_torch.train.metrics import psnr as psnr_fn
    from taichi_nerfs_torch.train.metrics import ssim as ssim_fn
    from taichi_nerfs_torch.train.swr_step import SwrTrainer
    from taichi_nerfs_torch.utils.convert import save_pyramid_npz
    from taichi_nerfs_torch.utils.device import resolve_device

    device = resolve_device(args.device, "--device cpu")
    spec, mcfg, tcfg = configs(args)
    train_ds = SyntheticSphereDataset(spec, split="train", device=device)
    trainer = SwrTrainer(
        mcfg, tcfg, train_ds.rays, train_ds.poses, train_ds.K,
        train_ds.img_wh,
        alphas=(train_ds.alphas if (args.random_bg or args.alpha_w > 0)
                else None),
        device=device,
    )
    T = args.total_steps
    meta_path = args.state + ".meta.json"
    train_wall = 0.0
    if os.path.exists(args.state):
        trainer.load_state(args.state)
        with open(meta_path) as f:
            train_wall = json.load(f)["train_wall"]
        print(f"resumed at step {trainer.step} ({train_wall:.0f}s so far)",
              flush=True)

    if args.eval_now:  # held-out snapshot of the resumed state
        T = trainer.step
    t0 = time.time()
    m = None
    while trainer.step < T and time.time() - t0 < args.wall:
        m = trainer.run_step()
        if trainer.step % 25 == 0:
            # the steps are queued asynchronously: without a host read now
            # and then, the wall check lets queued steps run past the budget
            float(m["loss"])
        if (trainer.step - 1) % 500 == 0:
            print(f"step={trainer.step - 1} psnr={float(m['psnr']):.2f} "
                  f"loss={float(m['loss']):.5f} "
                  f"wall={time.time() - t0:.0f}s", flush=True)
    if m is not None:
        float(m["loss"])  # the wall clock is device time
    train_wall += time.time() - t0
    ts = time.time()
    trainer.save_state(args.state)
    with open(meta_path, "w") as f:
        json.dump({"train_wall": train_wall}, f)
    print(f"checkpoint saved in {time.time() - ts:.0f}s", flush=True)
    if trainer.step < T:
        print(f"PAUSED at step {trainer.step}/{T} "
              f"(train_wall={train_wall:.0f}s)", flush=True)
        print(launch_counts(), flush=True)
        return 0

    print(f"TRAIN DONE: {T} steps in {train_wall:.0f}s", flush=True)
    # the eval needs the params only: free the Adam moments (and the
    # allocator's cache) so the uncapped 800^2 frame fits beside the grid
    trainer.state = trainer.state._replace(opt_state=None)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    test_ds = SyntheticSphereDataset(spec, split="test", device=device)
    w, h = test_ds.img_wh
    n_eval = args.eval_views or len(test_ds)
    psnrs, ssims = [], []
    for i in range(min(len(test_ds), n_eval)):
        s = test_ds[i]
        out = trainer.render(s["pose"], K=None, img_wh=(w, h), lat_cap=None)
        rgb = out["rgb"]
        gt = torch.as_tensor(s["rgb"], device=rgb.device)
        psnrs.append(float(psnr_fn(rgb, gt)))
        ssims.append(float(ssim_fn(rgb.reshape(h, w, 3),
                                   gt.reshape(h, w, 3))))
        print(f"view {i}: psnr={psnrs[-1]:.2f}", flush=True)
    print(f"RECORD: eval_psnr={np.mean(psnrs):.2f} "
          f"ssim={np.mean(ssims):.3f} train_wall={train_wall:.0f}s "
          f"steps={T} views={len(psnrs)}", flush=True)
    os.makedirs("results", exist_ok=True)
    save_pyramid_npz(os.path.join("results", "model_pyramid.npz"),
                     trainer.state.params)
    blob = config_blob(spec, mcfg, tcfg)
    manifest = {
        "eval_psnr": round(float(np.mean(psnrs)), 3),
        "eval_ssim": round(float(np.mean(ssims)), 4),
        "per_view_psnr": [round(p, 2) for p in psnrs],
        "views_finite": int(np.sum(np.isfinite(psnrs))),
        "train_wall_s": round(train_wall, 1),
        "steps": T,
        "seed": trainer.seed,
        "argv": argv,
        "config_sha1": hashlib.sha1(blob.encode()).hexdigest()[:12],
        "config": blob,
        "git_commit": _git_commit(),
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    with open(os.path.join("results", "model_pyramid.manifest.json"),
              "w") as f:
        json.dump(manifest, f, indent=2)
    print("saved results/model_pyramid.npz (+ manifest)", flush=True)
    print(launch_counts(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
