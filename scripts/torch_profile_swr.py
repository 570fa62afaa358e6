#!/usr/bin/env python3
"""The shear-warp train step of the PyTorch port, piece by piece.

Counterpart of ``scripts/profile_swr.py``, piece for piece, at its
configuration: ``PyramidConfig((32, 64, 128, 256), features=8)`` (shading
per sample; "defer" pieces deferred), ``SwrTrainConfig(crop=128, lr=2e-2,
n_chunks=16)``, a camera on +z at radius 1.5 with the 800x800 intrinsics,
the crop at (336, 336).  Pieces: the full step, deferred and not, deferred
at crops 192 and 256 (with rays/s); the bake forward and backward; the
crop's render forward and forward + backward from a baked grid, each
without and with the slab window; the full step without TV and sigma-L1;
Adam alone on ones-gradients; 400^2 and 800^2 frames in four variants
(capped fp32, capped deferred, capped deferred with bf16 operands, the
same with ``skip_empty`` on a grid whose density fills the central 40 % of
slabs).

Each call is timed with CUDA events behind ``torch.cuda.synchronize()``;
each piece prints its median and min-max over the repeats (host-bound
pieces vary from call to call) and the sweep kernels' launches a call.
Per-sample shading and a slab window take the slab scan (no kernel
launch; host-bound, ~10^5 launches a step): give them few repeats.
``--reps N`` caps every piece's timed repeats and warm-ups at N (default:
``profile_swr.py``'s counts).

    python3 scripts/torch_profile_swr.py [--reps 3] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises without
one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX script's configuration; a test shrinks it
LEVELS, FEATURES, CROP, N_CHUNKS, IMG = (32, 64, 128, 256), 8, 128, 16, 800
BIG_CROPS, FRAME_SIZES = (192, 256), (400, 800)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=0,
                    help="cap every piece's repeats and warm-ups at this "
                         "many (0: profile_swr.py's counts)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    import torch

    from taichi_nerfs_torch.models import pyramid as pyr
    from taichi_nerfs_torch.ops._build import LAUNCHES, launch_counts
    from taichi_nerfs_torch.render.swr import (
        render_swr_fixed_axis,
        slab_window_bound,
    )
    from taichi_nerfs_torch.train.state import tree_map
    from taichi_nerfs_torch.train.swr_step import (
        SwrTrainConfig,
        create_swr_state,
        draw_bg_and_tv,
        make_optimizer,
        swr_train_step,
    )
    from taichi_nerfs_torch.utils.device import (
        card_line,
        require_fp32_matmul,
        resolve_device,
    )
    from taichi_nerfs_torch.utils.profiling import spread, time_calls

    device = resolve_device(args.device, "--device cpu")
    if device.type == "cuda":
        print(card_line(), flush=True)
    require_fp32_matmul()

    def reps(n, warm):
        return (min(n, args.reps), min(warm, args.reps)) if args.reps \
            else (n, warm)

    def piece(name, fn, n, warm, rays=0):
        n, warm = reps(n, warm)
        f0, b0 = LAUNCHES["swr_sweep_fwd"], LAUNCHES["swr_sweep_bwd"]
        ms = time_calls(fn, n, warm, device)
        calls = n + warm
        fwd = (LAUNCHES["swr_sweep_fwd"] - f0) / calls
        bwd = (LAUNCHES["swr_sweep_bwd"] - b0) / calls
        extra = ""
        if rays:
            med_s = sorted(ms)[len(ms) // 2] / 1e3
            extra = f" {rays / med_s / 1e3:.1f}K rays/s"
        print(f"{name:<26} {spread(ms)}{extra}; launches a call: "
              f"swr_sweep_fwd {fwd:g}, swr_sweep_bwd {bwd:g}", flush=True)
        return ms

    mcfg = pyr.PyramidConfig(resolutions=LEVELS, features=FEATURES)
    mcfg_d = dataclasses.replace(mcfg, deferred=True)
    tcfg = SwrTrainConfig(crop=CROP, lr=2e-2, max_steps=20000,
                          n_chunks=N_CHUNKS)
    gen = torch.Generator().manual_seed(0)
    gen_dev = torch.Generator(device=device).manual_seed(0)

    # camera on +z looking at the origin, radius 1.5
    pose = np.eye(3, 4, dtype=np.float32)
    pose[:, :3] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    pose[2, 3] = 1.5
    f = 0.5 * IMG / np.tan(0.5 * 0.6911)
    K = np.asarray([[f, 0, IMG / 2], [0, f, IMG / 2], [0, 0, 1.0]],
                   np.float32)
    img = torch.zeros((IMG, IMG, 3), device=device)
    x0 = (IMG - CROP) // 2  # every crop's top-left, as profile_swr.py's
    axis, flip = 2, True
    win = slab_window_bound(pose[None], K, (IMG, IMG), mcfg, crop=CROP)
    print(f"slab window:      {win}", flush=True)

    def full_step(mc, tc, window=0):
        st = create_swr_state(mc, tc, torch.Generator().manual_seed(0),
                              device)

        def step():
            nonlocal st
            bg, tv = draw_bg_and_tv(tc, mc, st.params, gen_dev, gen, device)
            st, _ = swr_train_step(st, img, pose, K, (x0, x0), mc, tc, axis,
                                   flip, bg, tv, slab_window=window)
        return step

    piece("full step", full_step(mcfg, tcfg), 30, 5)
    piece("full step defer", full_step(mcfg_d, tcfg), 30, 5)
    for crop in BIG_CROPS:
        tc = dataclasses.replace(tcfg, crop=crop)
        piece(f"defer crop {crop}", full_step(mcfg_d, tc), 20, 5,
              rays=crop * crop)

    params = create_swr_state(mcfg, tcfg, torch.Generator().manual_seed(0),
                              device).params

    def bake_vjp():
        g = pyr.bake(params, mcfg)
        torch.autograd.grad(g, params["levels"], grad_outputs=g.detach())

    piece("bake fwd+bwd", bake_vjp, 30, 5)
    with torch.no_grad():
        grid = pyr.bake(params, mcfg)
    K_crop = K.copy()
    K_crop[0, 2] -= x0
    K_crop[1, 2] -= x0

    def sweep(g, window):
        return render_swr_fixed_axis(params, g, mcfg, pose, K_crop,
                                     (CROP, CROP), axis, flip,
                                     n_chunks=N_CHUNKS,
                                     slab_window=window)["rgb"]

    def sweep_fwd(window):
        def fn():
            with torch.no_grad():
                sweep(grid, window)
        return fn

    mlp = list(params["rgb_mlp"].values())

    def sweep_grad(window):
        g = grid.clone().requires_grad_(True)

        def fn():
            loss = torch.mean(sweep(g, window) ** 2)
            torch.autograd.grad(loss, mlp + [g])
        return fn

    piece(f"sweep fwd ({CROP})", sweep_fwd(0), 30, 5)
    piece("sweep fwd win", sweep_fwd(win), 30, 5)
    piece("sweep fwd+bwd", sweep_grad(0), 10, 5)
    piece("sweep fwd+bwd w", sweep_grad(win), 10, 5)

    tcfg0 = dataclasses.replace(tcfg, sigma_l1=0.0, tv_w=0.0)
    piece("full step no-reg", full_step(mcfg, tcfg0), 30, 5)

    opt = make_optimizer(tcfg)
    opt_state = opt.init(params)
    ones = tree_map(torch.ones_like, params)

    def adam():
        nonlocal opt_state
        opt_state = opt.update(ones, opt_state, params)

    piece("adam (dummy g)", adam, 30, 5)

    R = mcfg.grid_res
    lat = int(1.25 * R) + 16
    # a sparse grid: the object fills the central ~40 % of slabs (a
    # trained scene's occupancy), zero density elsewhere
    band = torch.zeros((R,), device=device)
    band[int(0.3 * R):int(0.7 * R)] = 1.0
    grid_sparse = grid.clone()
    grid_sparse[..., 0] *= band[None, None, :]
    for wh in FRAME_SIZES:
        Kw = np.asarray([[f * wh / IMG, 0, wh / 2.0],
                         [0, f * wh / IMG, wh / 2.0], [0, 0, 1.0]],
                        np.float32)
        cap = lat if wh + 16 > lat else 0

        def frame(mc, rdt, skip, g):
            def fn():
                with torch.no_grad():
                    render_swr_fixed_axis(
                        params, g, mc, pose, Kw, (wh, wh), axis, flip,
                        n_chunks=N_CHUNKS, lat_size=cap, resample_dtype=rdt,
                        skip_empty=skip)
            return fn

        for tag, mc, rdt, skip, g in (
                ("cap fp32", mcfg, "float32", False, grid),
                ("cap defer", mcfg_d, "float32", False, grid),
                ("capdef bf", mcfg_d, "bfloat16", False, grid),
                ("capdef bf skp", mcfg_d, "bfloat16", True, grid_sparse)):
            piece(f"render {wh}^2 {tag}", frame(mc, rdt, skip, g), 10, 5)
    print(launch_counts(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
