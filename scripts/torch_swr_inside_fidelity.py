#!/usr/bin/env python3
"""Inside-camera shear-warp renderer fidelity oracle, on the PyTorch port.

Counterpart of ``scripts/swr_inside_fidelity.py``: the variant's analytic
field is baked into an ``(R, R, R, 4)`` grid (sigma, albedo) at the voxel
centres, deferred shading is replaced by the identity for the duration of
the render (the composited features are the albedo), the held-out views
are rendered through ``render_swr_inside`` at full resolution and compared
with the scene's GT.  This isolates the renderer's fidelity from the
model's capacity (``scripts/torch_voxel_ceiling.py`` measures that) and
from the optimizer.  Inside cameras take the slab scan: this oracle
launches no sweep kernel.

    python3 scripts/torch_swr_inside_fidelity.py --img 800 --n_views 1 \\
        [--variant shell] [--res 256] [--lat_cap 0] [--save out/fid] \\
        [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises without
one.  ``--save P`` writes ``P_swr_v<i>.png`` and ``P_gt_v<i>.png``.
:func:`main` returns each view's fp32 image (H*W, 3), clipped to [0, 1].
"""

from __future__ import annotations

import argparse
import os
import sys
import types

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def identity_shading(pyr):
    """A copy of the pyramid module whose ``rgb_from_features`` returns the
    features' first three channels, to stand in for ``swr.pyr``."""
    ident = types.ModuleType("pyr_identity")
    ident.__dict__.update({k: v for k, v in vars(pyr).items()
                           if not k.startswith("__")})
    ident.rgb_from_features = (
        lambda params, cfg, feats, dirs, compute_dtype=None: feats[..., :3])
    return ident


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="shell")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--img", type=int, default=800)
    ap.add_argument("--n_views", type=int, default=1)
    ap.add_argument("--n_chunks", type=int, default=16)
    ap.add_argument("--near", type=float, default=0.1)
    ap.add_argument("--lat_cap", type=int, default=0)
    ap.add_argument("--save", default="")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    import torch

    from taichi_nerfs_torch.data.synthetic import (
        SyntheticSphereDataset,
        field_grid,
    )
    from taichi_nerfs_torch.models import pyramid as pyr
    from taichi_nerfs_torch.ops._build import launch_counts
    from taichi_nerfs_torch.render import swr
    from taichi_nerfs_torch.utils.device import resolve_device
    from taichi_nerfs_torch.utils.viz import write_png

    device = resolve_device(args.device, "--device cpu")
    scene = SyntheticSphereDataset(
        n_images=args.n_views, img_wh=(args.img, args.img),
        variant=args.variant, n_steps=512, split="test", device=device,
    )
    R = args.res
    sigma, albedo = field_grid(args.variant, R, device)
    grid = torch.cat([sigma[..., None], albedo], dim=-1)
    del sigma, albedo
    cfg = pyr.PyramidConfig(resolutions=(R,), features=4, deferred=True,
                            sigma_bias=0.0)
    params = {"rgb_mlp": {}}
    kw = {"lat_size": args.lat_cap} if args.lat_cap else {}

    images = []
    real = swr.pyr
    swr.pyr = identity_shading(pyr)
    try:
        for v in range(args.n_views):
            with torch.no_grad():
                out = swr.render_swr_inside(
                    params, grid, cfg, scene.poses[v], scene.K,
                    (args.img, args.img), n_chunks=args.n_chunks,
                    near=args.near, **kw)
            img = np.clip(out["rgb"].cpu().numpy(), 0, 1)
            images.append(img)
            gt = np.asarray(scene.rays[v]).reshape(-1, 3)
            mse = float(np.mean((img - gt) ** 2))
            psnr = -10 * np.log10(mse + 1e-12)
            print(f"view {v}: swr-inside fidelity psnr = {psnr:.2f} "
                  f"(R={args.res})", flush=True)
            if args.save:
                for tag, im in (("swr", img), ("gt", gt)):
                    write_png(f"{args.save}_{tag}_v{v}.png", (im.reshape(
                        args.img, args.img, 3) * 255).astype(np.uint8))
    finally:
        swr.pyr = real
    print(launch_counts(), flush=True)
    return images


if __name__ == "__main__":
    main()
