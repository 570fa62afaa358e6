"""NeRF-synthetic (Blender) loader: ``transforms_{split}.json`` and PNGs.

Copy of the JAX package's ``data/nerf.py`` on the port's
:class:`~taichi_nerfs_torch.data.base.BaseDataset`: the focal from
``camera_angle_x`` at the 800x800 base resolution times ``downsample``, the
poses flipped from [right up back] to [right down front] and each camera
moved to radius 1.5.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_image


class NeRFDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, read_meta=True, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if read_meta:
            self.read_meta(split)

    def read_intrinsics(self):
        with open(os.path.join(self.root_dir, "transforms_train.json")) as f:
            meta = json.load(f)
        w = h = int(800 * self.downsample)
        fx = fy = (
            0.5 * 800 / np.tan(0.5 * meta["camera_angle_x"]) * self.downsample
        )
        self.K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
        self.img_wh = (w, h)
        self._set_directions()

    def read_meta(self, split):
        rays, poses = [], []
        if split == "trainval":
            with open(os.path.join(self.root_dir, "transforms_train.json")) as f:
                frames = json.load(f)["frames"]
            with open(os.path.join(self.root_dir, "transforms_val.json")) as f:
                frames += json.load(f)["frames"]
        else:
            with open(
                os.path.join(self.root_dir, f"transforms_{split}.json")
            ) as f:
                frames = json.load(f)["frames"]

        for frame in frames:
            c2w = np.array(frame["transform_matrix"], np.float64)[:3, :4]
            c2w[:, 1:3] *= -1  # [right up back] -> [right down front]
            pose_radius_scale = 1.5
            c2w[:, 3] /= np.linalg.norm(c2w[:, 3]) / pose_radius_scale
            poses.append(c2w)
            img_path = os.path.join(self.root_dir, f"{frame['file_path']}.png")
            if os.path.exists(img_path):
                rays.append(read_image(img_path, self.img_wh))
        if rays:
            self.rays = np.stack(rays).astype(np.float32)
        self.poses = np.stack(poses).astype(np.float32)
