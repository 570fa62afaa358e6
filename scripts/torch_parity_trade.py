#!/usr/bin/env python3
"""Parity-path layout-capacity trade: fewer brick rows per ray.

Counterpart of ``scripts/parity_trade.py`` on the PyTorch port.  The
flagship brick layout gathers one row per (sample, level): 8 levels x F=4.
The trade halves the rows per sample by folding the ladder to 4 levels x
F=8 (the same 32-dim encoder output, the same hashed capacity at
log2_rows=17), with bf16 rows to keep the 64-value row at 128 B.  Four
candidates (:func:`candidates`): both layouts, each with fp32 and bf16
tables.  For each, on the bench's checker scene (8 views at 256x256):

* steady rays/s of ``Trainer.run_step`` over 48 steps after settling to
  ``--steps`` (past the warm-up and a few refreshes), host clock, ending
  in a host read;
* the held-out PSNR after that step budget, 3 test views rendered by
  ``render/renderer.py:render_image``.

One JSON record per candidate, with the JAX script's keys.  The port's
bf16 table gradient accumulates in fp32 for every F, so the two bf16
candidates train differently from the JAX package's (its forward is the
same).  No sweep kernel runs.

    python3 scripts/torch_parity_trade.py [--steps 768] [--json out.json] \\
        [--only 8x4_fp32,4x8_bf16] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises without
one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX script's scenes and timed window; a test shrinks them
N_VIEWS, N_TEST, RES, N_TIMED = 8, 3, 256, 48


def base_config():
    """The bench's parity configuration, whose brick layout each candidate
    replaces."""
    from taichi_nerfs_torch.config import config_for_scene

    return config_for_scene(0.5)


def candidates():
    """The four configurations of the trade, by name."""
    from taichi_nerfs_torch.config import BrickGridConfig

    def cfg_with(brick):
        cfg = base_config()
        return dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, brick=brick))

    return {
        # the recorded layout (the baseline side of the trade)
        "8x4_fp32": cfg_with(BrickGridConfig()),
        # half the rows, same capacity, rows of 128 B
        "4x8_bf16": cfg_with(BrickGridConfig(
            levels=4, feature_per_level=8, log2_rows=17,
            table_dtype="bfloat16",
        )),
        # ablation: row-count cut alone (256 B fp32 rows)
        "4x8_fp32": cfg_with(BrickGridConfig(
            levels=4, feature_per_level=8, log2_rows=17,
        )),
        # ablation: dtype cut alone
        "8x4_bf16": cfg_with(BrickGridConfig(table_dtype="bfloat16")),
    }


def measure(name, cfg, scene, test_scene, steps, device):
    import torch

    from taichi_nerfs_torch.ops.rays import get_rays
    from taichi_nerfs_torch.render.renderer import render_image
    from taichi_nerfs_torch.train.loop import Trainer
    from taichi_nerfs_torch.train.metrics import psnr

    trainer = Trainer(cfg, scene.as_batch(device), scene.K, scene.img_wh,
                      log_fn=lambda *a, **k: None, device=device)
    m = trainer.run_step()
    float(m["loss"])
    # settle: past warmup + a few refreshes, like the bench's parity leg
    while trainer.step < steps:
        for _ in range(16):
            m = trainer.run_step()
        float(m["loss"])
    # timed window
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        m = trainer.run_step()
    float(m["loss"])
    dt = time.perf_counter() - t0
    rays_s = cfg.train.batch_size * N_TIMED / dt
    # held-out quality at the equal step budget
    directions = torch.as_tensor(test_scene.directions, device=device)
    ps = []
    for i in range(len(test_scene.poses)):
        rays_o, rays_d = get_rays(
            directions, torch.as_tensor(test_scene.poses[i], device=device))
        out = render_image(trainer.state.params, cfg,
                           trainer.state.occupancy.bitfield, rays_o, rays_d)
        gt = torch.as_tensor(np.asarray(test_scene.rays[i]), device=device)
        ps.append(float(psnr(out["rgb"], gt)))
    p = float(np.mean(ps))
    rec = {
        "name": name,
        "levels": cfg.model.brick.levels,
        "F": cfg.model.brick.feature_per_level,
        "table_dtype": cfg.model.brick.table_dtype,
        "rays_per_s": round(rays_s, 1),
        "step_ms": round(dt / N_TIMED * 1e3, 2),
        "steps": int(trainer.step),
        "eval_psnr": round(p, 2),
        "sample_cap": int(trainer.sample_cap),
        "pack_cap": int(trainer.pack_cap or 0),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=768,
                    help="settle budget before the timed window")
    ap.add_argument("--json", default="")
    ap.add_argument("--only", default="",
                    help="comma list of config names to run")
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
    # the bench's scene, plus a held-out rig for the quality side
    scene = SyntheticSphereDataset(
        n_images=N_VIEWS, img_wh=(RES, RES), variant="checker",
        n_steps=256, device=device,
    )
    test_scene = SyntheticSphereDataset(
        split="test", n_images=N_TEST, img_wh=(RES, RES), variant="checker",
        n_steps=256, device=device,
    )
    only = [s for s in args.only.split(",") if s]
    out = []
    for name, cfg in candidates().items():
        if only and name not in only:
            continue
        out.append(measure(name, cfg, scene, test_scene, args.steps,
                           device))
    print(launch_counts(), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
