#!/usr/bin/env python3
"""Diagnose an R=512 quality regression against an R=256 checkpoint.

Counterpart of ``scripts/diag_r512.py`` on the PyTorch port: renders the
same held-out lego views from two ``model_pyramid.npz`` checkpoints (``--a``
the R=256 CLI record, ``--b`` the lean R=512 one), writes rgb and |error|
PNGs of each, and splits each view's MSE into a silhouette-edge band (GT
gradient > 0.05, dilated 2 px) and the interior: whether the fine level
loses on edges (reconstruction, ringing) or in the interior (noise, the
bf16 bake's quantization).  Each grid is baked in bf16 and rendered
uncapped, cubic, without empty-slab skipping, with early exit 1e-4: the
sweep forward kernel runs on the card with a bf16 volume.

    python3 scripts/torch_diag_r512.py [--a results/model_pyramid.npz] \\
        [--b results/lego_proxy_r512/model_pyramid.npz] [--views 2,13] \\
        [--out /tmp/diag_r512] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises without
one.  :func:`main` returns the rendered images, ``{(tag, view): (H, W,
3)}``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the held-out rig: 25 lego views at 800x800; a test shrinks it
SCENE = "synthetic://lego?views=100&res=800"


def load_ckpt(path, device=None):
    """A ``model_pyramid.npz``'s params and the ``PyramidConfig`` its levels
    give (``level_features`` when the levels' widths differ)."""
    from taichi_nerfs_torch.models.pyramid import PyramidConfig
    from taichi_nerfs_torch.utils.convert import load_pyramid_npz

    params = load_pyramid_npz(path, device)
    levels = params["levels"]
    feats = int(levels[0].shape[-1])
    lf = tuple(int(g.shape[-1]) for g in levels)
    cfg = PyramidConfig(
        resolutions=tuple(int(g.shape[0]) for g in levels),
        features=feats, deferred=True,
        level_features=lf if any(f != feats for f in lf) else (),
    )
    return params, cfg


def render_view(params, grid, cfg, pose, K, wh, **kw):
    """One held-out view as the diagnosis renders it: (H, W, 3) rgb on the
    host, clipped to [0, 1].  ``kw`` goes to ``render_swr`` (e.g.
    ``sweep_impl``)."""
    import torch

    from taichi_nerfs_torch.render.swr import render_swr

    w, h = wh
    with torch.no_grad():
        out = render_swr(params, grid, cfg, pose, K, (w, h), lat_cap=None,
                         skip_empty=False, resample_kind="cubic",
                         early_exit=1e-4, **kw)
    return np.clip(out["rgb"].float().cpu().numpy().reshape(h, w, 3), 0, 1)


def edge_split(rgb, gt):
    """(edge band mask, MSE, edge-band MSE, interior MSE) of an (H, W, 3)
    render against its GT: the band holds the pixels near a GT intensity
    gradient above 0.05, dilated by ~2 px."""
    gray = gt.mean(-1)
    gy, gx = np.gradient(gray)
    edge = np.hypot(gx, gy) > 0.05
    for _ in range(2):
        e = edge.copy()
        e[1:] |= edge[:-1]
        e[:-1] |= edge[1:]
        e[:, 1:] |= edge[:, :-1]
        e[:, :-1] |= edge[:, 1:]
        edge = e
    mse = float(((rgb - gt) ** 2).mean())
    mse_edge = float(((rgb - gt)[edge] ** 2).mean())
    mse_int = float(((rgb - gt)[~edge] ** 2).mean())
    return edge, mse, mse_edge, mse_int


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", default="results/model_pyramid.npz")
    ap.add_argument("--b",
                    default="results/lego_proxy_r512/model_pyramid.npz")
    ap.add_argument("--views", default="2,13")
    ap.add_argument("--out", default="/tmp/diag_r512")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    import torch

    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.models import pyramid as pyr
    from taichi_nerfs_torch.ops._build import launch_counts
    from taichi_nerfs_torch.train.metrics import psnr as psnr_fn
    from taichi_nerfs_torch.utils.device import card_line, resolve_device
    from taichi_nerfs_torch.utils.viz import write_png

    device = resolve_device(args.device, "--device cpu")
    if device.type == "cuda":
        print(card_line(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    test = SyntheticSphereDataset(SCENE, split="test", device=device)
    w, h = test.img_wh

    images = {}
    for tag, path in (("a", args.a), ("b", args.b)):
        params, cfg = load_ckpt(path, device)
        with torch.no_grad():
            grid = pyr.bake(params, cfg, dtype=torch.bfloat16)
        for vi in [int(x) for x in args.views.split(",")]:
            s = test[vi]
            rgb = render_view(params, grid, cfg, np.asarray(s["pose"]),
                              test.K, (w, h))
            gt = np.asarray(s["rgb"]).reshape(h, w, 3)
            err = np.abs(rgb - gt).mean(-1)
            edge, mse, mse_edge, mse_int = edge_split(rgb, gt)
            p = float(psnr_fn(torch.as_tensor(rgb.reshape(-1, 3)),
                              torch.as_tensor(gt.reshape(-1, 3))))
            print(
                f"{tag} view {vi}: psnr={p:.2f} mse={mse:.2e} "
                f"edge_mse={mse_edge:.2e} ({edge.mean():.0%} px) "
                f"interior_mse={mse_int:.2e}",
                flush=True,
            )
            write_png(os.path.join(args.out, f"{tag}_v{vi}_rgb.png"),
                      (rgb * 255).astype(np.uint8))
            # the error map as a gray RGB image (write_png takes RGB)
            gray = (np.clip(err * 8, 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(args.out, f"{tag}_v{vi}_err.png"),
                      np.repeat(gray[..., None], 3, axis=-1))
            images[(tag, vi)] = rgb
    print(launch_counts(), flush=True)
    return images


if __name__ == "__main__":
    main()
