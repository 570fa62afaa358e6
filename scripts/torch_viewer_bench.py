#!/usr/bin/env python3
"""Frame rate of the viewer loop on a trained pyramid checkpoint.

Counterpart of ``scripts/viewer_bench.py`` on the PyTorch port: it drives
the headless viewer (``viewer/gui.py:NGPGUI.render``: the camera orbits
every frame, the frame is rendered and reaches the host), not an isolated
render.  The ``render_fn`` renders through ``render_swr`` with the lattice
cap as the interactive knob (``--lat_cap auto|none|<int>``), the
checkpoint's resample kind (``--kind``) and early exit, and quantizes rgb
to uint8 on the device, so 1.9 MB instead of 7.7 MB of an 800x800 frame
reach the host.  Six orbit steps warm up first (the orbit crosses sweep
axes); then ``--frames`` frames are timed.

    python3 scripts/torch_viewer_bench.py [--ckpt results/model_pyramid.npz]
        [--res 800] [--frames 24] [--lat_cap auto|none|<int>] [--kind cubic]
        [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises without
one.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="results/model_pyramid.npz")
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--lat_cap", default="auto",
                    help="'auto' (int(1.25 R) + 16), 'none' or an integer")
    ap.add_argument("--kind", default="cubic", choices=("linear", "cubic"),
                    help="resample kind the checkpoint was trained with")
    ap.add_argument("--early_exit", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    import torch

    from taichi_nerfs_torch.data.cameras import intrinsics, orbit_poses
    from taichi_nerfs_torch.models import pyramid as pyr
    from taichi_nerfs_torch.render.serve import (
        config_for_params,
        record_config,
    )
    from taichi_nerfs_torch.render.swr import render_swr
    from taichi_nerfs_torch.utils.convert import load_pyramid_npz
    from taichi_nerfs_torch.utils.device import (
        require_fp32_matmul,
        resolve_device,
    )
    from taichi_nerfs_torch.viewer.gui import NGPGUI

    device = resolve_device(args.device, "--device cpu")
    require_fp32_matmul()
    params = load_pyramid_npz(args.ckpt, device)
    cfg = config_for_params(params, record_config())
    with torch.no_grad():
        grid = pyr.bake(params, cfg)
    cap = args.lat_cap.lower()
    if cap == "auto":
        lat = int(1.25 * cfg.grid_res) + 16
    elif cap in ("none", "0"):
        lat = 0
    else:
        lat = int(cap)

    w = h = args.res
    K = intrinsics(w, h)

    def render_fn(pose, K_, wh):
        out = render_swr(
            params, grid, cfg, pose, K, (w, h), lat_cap=lat or None,
            early_exit=args.early_exit, resample_kind=args.kind,
        )
        # quantized on the device: the viewer displays this directly
        rgb8 = (torch.clamp(out["rgb"], 0.0, 1.0) * 255.0).to(torch.uint8)
        return {"rgb": rgb8, "depth": out["depth"]}

    gui = NGPGUI(None, params, None, K, (w, h), orbit_poses(4),
                 render_fn=render_fn)
    for _ in range(6):
        gui.cam.orbit(1.1, 0.35)
        gui.render_frame()
    t0 = time.perf_counter()
    frames = gui.render(max_frames=args.frames)
    wall = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"VIEWER: {len(frames)} frames in {wall:.3f}s = "
          f"{len(frames) / wall:.2f} fps (res {w}x{h}, lat_cap "
          f"{lat or 'uncapped'}, kind {args.kind}, device {device}: {name})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
