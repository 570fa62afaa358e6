#!/usr/bin/env python3
"""Frame rate of a trained pyramid checkpoint, capped and uncapped.

Counterpart of ``scripts/eval_fps.py`` on the PyTorch port: the
checkpoint's levels give the configuration, the grid is baked once in
bf16 (as the JAX script serves it), and 800x800 frames of a 90-degree
orbit are timed through ``render_swr`` with the lattice capped at
``int(1.25 R) + 16`` (the interactive setting) and uncapped (the quality
eval).  Four warm-up frames come first; the timed window ends in
``torch.cuda.synchronize`` on the card.  Target: >= 30 fps at 800x800
(``BASELINE.md``).

    python3 scripts/torch_eval_fps.py --ckpt results/model_pyramid.npz \\
        [--res 800] [--frames 8] [--resample_kind cubic] [--device cpu]

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


def pose_at(deg: float) -> np.ndarray:
    """The orbit's camera-to-world pose at ``deg`` degrees about y, radius
    1.6 (``scripts/eval_fps.py``)."""
    a = np.radians(deg)
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]], np.float32)
    base = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    t = rot @ np.array([0, 0, 1.6], np.float32)
    return np.concatenate([rot @ base, t[:, None]], axis=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="results/model_pyramid.npz")
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--sweep_impl", default="auto",
                    choices=("auto", "reference"),
                    help="'auto': the sweep kernel on the card; "
                         "'reference': the plain PyTorch sweep")
    ap.add_argument("--early_exit", type=float, default=0.0,
                    help="transmittance threshold for chunk-level early "
                         "termination (0 = the full sweep)")
    ap.add_argument("--resample_kind", default="linear",
                    choices=("linear", "cubic"),
                    help="must match the checkpoint's training kind (the "
                         "record trains cubic)")
    ap.add_argument("--resample_dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="resample operand dtype (fp32 accumulation)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    import torch

    from taichi_nerfs_torch.data.cameras import intrinsics
    from taichi_nerfs_torch.models import pyramid as pyr
    from taichi_nerfs_torch.render.serve import (
        config_for_params,
        record_config,
    )
    from taichi_nerfs_torch.render.swr import render_swr
    from taichi_nerfs_torch.utils.convert import load_pyramid_npz
    from taichi_nerfs_torch.utils.device import (
        card_line,
        require_fp32_matmul,
        resolve_device,
    )

    device = resolve_device(args.device, "--device cpu")
    cuda = device.type == "cuda"
    if cuda:
        print(card_line(), flush=True)
    require_fp32_matmul()
    params = load_pyramid_npz(args.ckpt, device)
    cfg = config_for_params(params, record_config())
    R = cfg.grid_res
    with torch.no_grad():
        grid = pyr.bake(params, cfg, torch.bfloat16)

    w = h = args.res
    K = intrinsics(w, h)

    def frame(f, cap):
        with torch.no_grad():
            return render_swr(
                params, grid, cfg, pose_at(90.0 * (f % 4)), K, (w, h),
                lat_cap=cap, skip_empty=False, sweep_impl=args.sweep_impl,
                early_exit=args.early_exit,
                resample_kind=args.resample_kind,
                resample_dtype=args.resample_dtype,
            )

    for name, cap in (("capped(1.25R)", int(1.25 * R) + 16),
                      ("uncapped", None)):
        for f in range(4):  # the four (axis, flip) sweeps of the orbit
            out = frame(f, cap)
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for f in range(args.frames):
            out = frame(f, cap)
        if cuda:
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) / args.frames * 1e3
        if not bool(torch.isfinite(out["rgb"]).all()):
            raise RuntimeError(f"{name}: the frame is not finite")
        print(f"R={R} {w}x{h} {name}: {ms:.3f} ms/frame "
              f"({1e3 / ms:.2f} fps) on {device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
