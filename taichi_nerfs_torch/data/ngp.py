"""instant-ngp loader: one ``transforms.json`` (``fl_x``, ``fl_y``, ``w``,
``h``) and its image files.

Copy of the JAX package's ``data/ngp.py`` on the port's
:class:`~taichi_nerfs_torch.data.base.BaseDataset`: the poses are flipped
from [right up back] to [right down front] and otherwise kept; frames whose
image file is missing are skipped.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_image


class NGPDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, read_meta=True, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if read_meta:
            self.read_meta(split)

    def read_intrinsics(self):
        with open(os.path.join(self.root_dir, "transforms.json")) as f:
            meta = json.load(f)
        w = int(meta["w"] * self.downsample)
        h = int(meta["h"] * self.downsample)
        fx = meta["fl_x"] * self.downsample
        fy = meta["fl_y"] * self.downsample
        self.K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
        self.img_wh = (w, h)
        self._set_directions()

    def read_meta(self, split):
        rays, poses = [], []
        with open(os.path.join(self.root_dir, "transforms.json")) as f:
            frames = json.load(f)["frames"]
        for frame in frames:
            img_path = os.path.join(self.root_dir, f"{frame['file_path']}")
            if not os.path.exists(img_path):
                continue
            rays.append(read_image(img_path, self.img_wh))
            c2w = np.array(frame["transform_matrix"], np.float64)[:3, :4]
            c2w[:, 1:3] *= -1
            poses.append(c2w)
        if rays:
            self.rays = np.stack(rays).astype(np.float32)
        self.poses = np.stack(poses).astype(np.float32)
