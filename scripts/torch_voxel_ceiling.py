#!/usr/bin/env python3
"""Representational-ceiling oracle, on the PyTorch port.

Counterpart of ``scripts/voxel_ceiling.py``: the variant's analytic volume
field is voxelised at grid resolution R (:func:`field_grid`, the voxel
centres at ``i + 0.5``), each ray of the held-out views marches the
voxelised fields (trilinear, clamped indices, ``n_steps`` samples on
[0.1, 2.5]) in chunks of 32768 rays, and the image is compared with the
scene's GT.  The PSNR is the best any R-resolution grid model can reach on
that scene and rig; no training, no random numbers.  Plain PyTorch on the
card: no sweep kernel runs.

    python3 scripts/torch_voxel_ceiling.py --variant shell --res 256 \\
        --img 800 --n_views 3 [--save out/ceil] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises without
one.  ``--save P`` writes ``P_v<i>.png``.  :func:`main` returns each
view's fp32 image (H*W, 3).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 32768


def trilerp(grid, p, R: int, s: float):
    """Trilinear lookup of ``grid`` (R, R, R[, C]) at points ``p`` (..., 3)
    in ``[-s, s]^3`` (voxel centres at ``i + 0.5``, indices clamped)."""
    import torch

    q = (p / (2 * s) + 0.5) * R - 0.5
    q0 = torch.floor(q)
    f = q - q0
    i0 = torch.clamp(q0.to(torch.int64), 0, R - 1)
    i1 = torch.clamp(i0 + 1, 0, R - 1)
    out = 0.0
    for dx in (0, 1):
        wx = (1 - f[..., 0]) if dx == 0 else f[..., 0]
        ix = i0[..., 0] if dx == 0 else i1[..., 0]
        for dy in (0, 1):
            wy = (1 - f[..., 1]) if dy == 0 else f[..., 1]
            iy = i0[..., 1] if dy == 0 else i1[..., 1]
            for dz in (0, 1):
                wz = (1 - f[..., 2]) if dz == 0 else f[..., 2]
                iz = i0[..., 2] if dz == 0 else i1[..., 2]
                w = wx * wy * wz
                g = grid[ix, iy, iz]
                out = out + (w[..., None] * g if g.ndim > w.ndim else w * g)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="shell")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--img", type=int, default=800)
    ap.add_argument("--n_views", type=int, default=3)
    ap.add_argument("--n_steps", type=int, default=512)
    ap.add_argument("--save", default="")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    import torch

    from taichi_nerfs_torch.data.synthetic import (
        SyntheticSphereDataset,
        _gt_rays,
        field_grid,
    )
    from taichi_nerfs_torch.ops._build import launch_counts
    from taichi_nerfs_torch.utils.device import resolve_device
    from taichi_nerfs_torch.utils.viz import write_png

    device = resolve_device(args.device, "--device cpu")
    scene = SyntheticSphereDataset(
        n_images=args.n_views, img_wh=(args.img, args.img),
        variant=args.variant, n_steps=args.n_steps, split="test",
        device=device,
    )
    R, s = args.res, 0.5
    sigma_g, albedo_g = field_grid(args.variant, R, device)

    t0, t1 = 0.1, 2.5
    ts = torch.linspace(t0, t1, args.n_steps, dtype=torch.float32,
                        device=device)
    dt = float((t1 - t0) / (args.n_steps - 1))

    @torch.no_grad()
    def integrate(ro, rd):
        xyz = ro[:, None, :] + ts[None, :, None] * rd[:, None, :]
        inside = torch.all(torch.abs(xyz) <= s, dim=-1)
        sigma = trilerp(sigma_g, xyz, R, s) * inside
        alpha = 1.0 - torch.exp(-sigma * dt)
        trans = torch.cumprod(1.0 - alpha + 1e-12, dim=1) / (
            1.0 - alpha + 1e-12)
        wgt = alpha * trans
        out = torch.einsum("rs,rsc->rc", wgt, trilerp(albedo_g, xyz, R, s))
        return out + trans[:, -1:] * (1.0 - alpha[:, -1:])

    images = []
    for v in range(args.n_views):
        ro, rd = _gt_rays(scene.poses[v], scene.K, args.img, args.img)
        ro = torch.as_tensor(ro.astype(np.float32), device=device)
        rd = torch.as_tensor(rd.astype(np.float32), device=device)
        img = torch.cat([integrate(ro[i : i + CHUNK], rd[i : i + CHUNK])
                         for i in range(0, ro.shape[0], CHUNK)])
        img = img.cpu().numpy()
        images.append(img)
        gt = np.asarray(scene.rays[v]).reshape(-1, 3)
        mse = float(np.mean((img - gt) ** 2))
        psnr = -10 * np.log10(mse + 1e-12)
        print(f"view {v}: voxel-ceiling psnr = {psnr:.2f}  (R={args.res})",
              flush=True)
        if args.save:
            write_png(f"{args.save}_v{v}.png", (np.clip(
                img.reshape(args.img, args.img, 3), 0, 1) * 255).astype(
                    np.uint8))
    print(launch_counts(), flush=True)
    return images


if __name__ == "__main__":
    main()
