"""NSVF-format loader (Synthetic-NeRF, BlendedMVS, TanksAndTemples layouts).

Copy of the JAX package's ``data/nsvf.py`` on the port's
:class:`~taichi_nerfs_torch.data.base.BaseDataset`: per-scene
``intrinsics.txt`` / ``bbox.txt``, splits by file-name prefix (``0_`` /
``1_`` / ``2_``), poses shifted and scaled from the bounding box into
[-0.5, 0.5]^3 with the per-scene factors the NSVF captures need.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_image


class NSVFDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            bbox = np.loadtxt(os.path.join(root_dir, "bbox.txt"))[:6].reshape(
                2, 3
            )
            xyz_min, xyz_max = bbox[0], bbox[1]
            self.shift = (xyz_max + xyz_min) / 2
            self.scale = (xyz_max - xyz_min).max() / 2 * 1.05
            # per-scene bound fixes
            if "Mic" in self.root_dir:
                self.scale *= 1.2
            elif "Lego" in self.root_dir:
                self.scale *= 1.1
            self.read_meta(split)

    def read_intrinsics(self):
        if "Synthetic" in self.root_dir or "Ignatius" in self.root_dir:
            with open(os.path.join(self.root_dir, "intrinsics.txt")) as f:
                fx = fy = float(f.readline().split()[0]) * self.downsample
            if "Synthetic" in self.root_dir:
                w = h = int(800 * self.downsample)
            else:
                w, h = int(1920 * self.downsample), int(1080 * self.downsample)
            K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
        else:
            K = np.loadtxt(
                os.path.join(self.root_dir, "intrinsics.txt"),
                dtype=np.float32,
            )[:3, :3]
            if "BlendedMVS" in self.root_dir:
                w, h = int(768 * self.downsample), int(576 * self.downsample)
            elif "Tanks" in self.root_dir:
                w, h = int(1920 * self.downsample), int(1080 * self.downsample)
            K[:2] *= self.downsample
        self.K = np.asarray(K, np.float32)
        self.img_wh = (w, h)
        self._set_directions()

    def read_meta(self, split):
        rays, poses = [], []
        if split == "test_traj":  # BlendedMVS / TanksAndTemples
            if "Ignatius" in self.root_dir:
                poses_path = sorted(
                    glob.glob(os.path.join(self.root_dir, "test_pose/*.txt"))
                )
                traj = [np.loadtxt(p) for p in poses_path]
            else:
                traj = np.loadtxt(
                    os.path.join(self.root_dir, "test_traj.txt")
                ).reshape(-1, 4, 4)
            for pose in traj:
                c2w = np.array(pose[:3], np.float64)
                c2w[:, 0] *= -1  # [left down front] -> [right down front]
                c2w[:, 3] -= self.shift
                c2w[:, 3] /= 2 * self.scale
                poses.append(c2w)
        else:
            # filename-prefix splits
            if split == "train":
                prefix = "0_"
            elif split == "trainval":
                prefix = "[0-1]_"
            elif split == "trainvaltest":
                prefix = "[0-2]_"
            elif split == "val":
                prefix = "1_"
            elif "Synthetic" in self.root_dir:
                prefix = "2_"
            elif split == "test":
                prefix = "1_"
            else:
                raise ValueError(f"{split} split not recognized!")
            img_paths = sorted(
                glob.glob(os.path.join(self.root_dir, "rgb", prefix + "*.png"))
            )
            pose_paths = sorted(
                glob.glob(os.path.join(self.root_dir, "pose", prefix + "*.txt"))
            )
            for img_path, pose in zip(img_paths, pose_paths):
                c2w = np.loadtxt(pose)[:3]
                c2w[:, 3] -= self.shift
                c2w[:, 3] /= 2 * self.scale
                poses.append(c2w)
                img = read_image(img_path, self.img_wh)
                if "Jade" in self.root_dir or "Fountain" in self.root_dir:
                    # black background -> white
                    img[np.all(img <= 0.1, axis=-1)] = 1.0
                rays.append(img)
            if rays:
                self.rays = np.stack(rays).astype(np.float32)
        self.poses = np.stack(poses).astype(np.float32)
