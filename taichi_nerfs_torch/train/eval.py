"""Evaluation of the NGP path: per-view PSNR / SSIM through the test-time
renderer, and the first view's rgb and depth PNGs.

Port of the JAX package's ``train/eval.py``; the PNGs are written by
``utils/viz.py:write_png``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..ops.rays import get_rays
from ..render.renderer import render_image
from ..utils.viz import depth2img, write_png
from .metrics import psnr, ssim


@torch.no_grad()
def evaluate(params, cfg: Config, bitfield, test_dataset,
             save_dir: Optional[str] = None,
             max_images: Optional[int] = None, log_fn=print):
    """Render every test view (or the first ``max_images``) on the
    bitfield's device; returns ``{"psnr": [...], "ssim": [...]}``."""
    dev = bitfield.device
    w, h = test_dataset.img_wh
    n = len(test_dataset)
    if max_images is not None:
        n = min(n, max_images)
    directions = torch.as_tensor(test_dataset.directions, device=dev)
    psnrs, ssims = [], []
    for i in range(n):
        sample = test_dataset[i]
        pose = torch.as_tensor(np.asarray(sample["pose"], np.float32),
                               device=dev)
        rays_o, rays_d = get_rays(directions, pose)
        out = render_image(params, cfg, bitfield, rays_o, rays_d)
        rgb = out["rgb"]
        if "rgb" in sample:
            gt = torch.as_tensor(np.asarray(sample["rgb"], np.float32),
                                 device=dev)
            psnrs.append(float(psnr(rgb, gt)))
            ssims.append(float(ssim(rgb.reshape(h, w, 3),
                                    gt.reshape(h, w, 3))))
        if i == 0 and save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            img = rgb.reshape(h, w, 3).clamp(0, 1).cpu().numpy()
            write_png(os.path.join(save_dir, f"rgb_{i:03d}.png"),
                      (img * 255).astype(np.uint8))
            write_png(os.path.join(save_dir, f"depth_{i:03d}.png"),
                      depth2img(out["depth"].reshape(h, w).cpu().numpy()))
    if psnrs:
        log_fn(f"evaluation: psnr_avg={np.mean(psnrs):.4f} | "
               f"ssim_avg={np.mean(ssims):.4f}")
    return {"psnr": psnrs, "ssim": ssims}
