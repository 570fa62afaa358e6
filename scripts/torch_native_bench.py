#!/usr/bin/env python3
"""Frame rate of the native C++ runner on the port's exports.

Counterpart of ``scripts/native_bench.py`` on the PyTorch port.  The
reference's mobile demos render 300x600 and 683x512 (its README and
demo sources); the runner (``native/``) is portable C++17 on the host CPU,
so the record is ms/frame and fps per model family at those resolutions on
the stated host.

It trains the small deployment-config hash NGP (4 levels, 16-wide MLPs,
the reference's mobile artifact) on the procedural checker with the port's
``Trainer``, exports it with ``utils/export.py:export_native`` (files
byte-equal to the JAX package's), builds ``native/`` with cmake into
``--build_dir`` (gitignored ``build/native_runner`` by default) and runs
``tnerf_runner --bench`` on each resolution; then the same for a pyramid
checkpoint (``export_pyramid_native``) if it exists.  A runner that fails
raises.

    python3 scripts/torch_native_bench.py \\
        [--pyramid_ckpt results/model_pyramid.npz] [--frames 16] \\
        [--res 300x600 --res 683x512] [--device cpu]

Training runs on the card unless ``--device cpu`` is given, and raises
without one.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's iPhone and iPad demo resolutions
RESOLUTIONS = ("300x600", "683x512")


def build_runner(build_dir: str) -> str:
    """``native/`` built (Release) into ``build_dir``; the runner's path."""
    subprocess.run(["cmake", "-S", os.path.join(_REPO, "native"), "-B",
                    build_dir, "-DCMAKE_BUILD_TYPE=Release"], check=True,
                   capture_output=True)
    subprocess.run(["cmake", "--build", build_dir, "-j"], check=True,
                   capture_output=True)
    return os.path.join(build_dir, "tnerf_runner")


def run_bench(runner: str, export_fn, family: str, frames: int,
              resolutions) -> list:
    """``export_fn(img_wh) -> dir`` (the resolution is part of the export's
    config: the runner takes none).  Returns (w, h, ms, fps) a
    resolution."""
    out = []
    for w, h in resolutions:
        export_dir = export_fn((w, h))
        r = subprocess.run(
            [runner, export_dir, os.path.join(export_dir, "out.ppm"),
             "--bench", str(frames)],
            capture_output=True, text=True, timeout=3600,
        )
        if r.returncode != 0:
            raise RuntimeError(f"{family} {w}x{h}: the runner failed "
                               f"(exit {r.returncode}): {r.stderr[-400:]}")
        m = re.search(r"bench \d+ frames: ([\d.]+) ms/frame \(([\d.]+) fps\)",
                      r.stderr)
        if m is None:
            raise RuntimeError(f"{family} {w}x{h}: no bench line in the "
                               f"runner's output: {r.stderr[-400:]}")
        ms, fps = float(m.group(1)), float(m.group(2))
        out.append((w, h, ms, fps))
        print(f"{family} {w}x{h}: {ms:.2f} ms/frame ({fps:.2f} fps)",
              flush=True)
    return out


def bench_ngp(runner, frames, steps, resolutions, device, tmp):
    from taichi_nerfs_torch.config import (
        Config,
        RenderConfig,
        TrainConfig,
        deployment_model_config,
    )
    from taichi_nerfs_torch.data.cameras import intrinsics
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.train.loop import Trainer
    from taichi_nerfs_torch.utils.export import export_native

    scene = SyntheticSphereDataset(n_images=6, img_wh=(128, 128),
                                   variant="checker", device=device)
    cfg = Config(
        model=deployment_model_config(0.5),
        render=RenderConfig(train_sample_cap=256),
        train=TrainConfig(batch_size=4096, max_steps=steps),
    )
    trainer = Trainer(cfg, scene.as_batch(device), scene.K, scene.img_wh,
                      log_fn=lambda *a, **k: None, device=device)
    trainer.fit(steps, log_every=10**9)

    def export_at(img_wh):
        d = tempfile.mkdtemp(prefix="ngp_", dir=tmp)
        export_native(trainer.state.params, cfg.model,
                      trainer.state.occupancy.bitfield,
                      np.asarray(scene.poses), intrinsics(*img_wh), img_wh, d,
                      render_cfg=cfg.render)
        return d

    return run_bench(runner, export_at, "ngp(deployment-config)", frames,
                     resolutions)


def bench_pyramid(runner, ckpt, frames, resolutions, device, tmp):
    from taichi_nerfs_torch.data.cameras import intrinsics
    from taichi_nerfs_torch.render.serve import (
        config_for_params,
        record_config,
    )
    from taichi_nerfs_torch.utils.convert import load_pyramid_npz
    from taichi_nerfs_torch.utils.export import export_pyramid_native

    params = load_pyramid_npz(ckpt, device)
    cfg = config_for_params(params, record_config())
    pose = np.concatenate(
        [np.diag([1.0, -1.0, -1.0]), [[0.0], [0.0], [1.6]]], axis=1
    ).astype(np.float32)

    def export_at(img_wh):
        d = tempfile.mkdtemp(prefix="pyramid_", dir=tmp)
        export_pyramid_native(params, cfg, pose, K=intrinsics(*img_wh),
                              img_wh=img_wh, out_dir=d)
        return d

    return run_bench(runner, export_at, f"pyramid(R={cfg.grid_res})",
                     frames, resolutions)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pyramid_ckpt", default="results/model_pyramid.npz")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--ngp_steps", type=int, default=400)
    ap.add_argument("--res", action="append", default=None, metavar="WxH",
                    help="a resolution to bench (repeatable; default "
                         f"{' and '.join(RESOLUTIONS)})")
    ap.add_argument("--build_dir",
                    default=os.path.join(_REPO, "build", "native_runner"))
    ap.add_argument("--device", default="cuda",
                    help="the training device: 'cuda' (the default; raises "
                         "without a card) or 'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    from taichi_nerfs_torch.utils.device import resolve_device

    device = resolve_device(args.device, "--device cpu")
    resolutions = [tuple(int(n) for n in r.lower().split("x"))
                   for r in (args.res or RESOLUTIONS)]
    runner = build_runner(args.build_dir)
    print(f"host: {multiprocessing.cpu_count()} CPU core(s); reference "
          "baseline 13.5-22.4 fps on iPhone 14 / iPad Pro mobile GPUs; "
          f"training on {device}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        bench_ngp(runner, args.frames, args.ngp_steps, resolutions, device,
                  tmp)
        if os.path.exists(args.pyramid_ckpt):
            bench_pyramid(runner, args.pyramid_ckpt, args.frames,
                          resolutions, device, tmp)
        else:
            print(f"pyramid ckpt {args.pyramid_ckpt} missing: skipped",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
