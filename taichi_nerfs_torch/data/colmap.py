"""COLMAP loader: ``sparse/0/{cameras,images,points3D}.bin`` and images.

Copy of the JAX package's ``data/colmap.py`` on the port's
:class:`~taichi_nerfs_torch.data.base.BaseDataset`: the poses are recentred
about the point cloud's average pose and scaled by the nearest camera's
distance, every 8th image is a test image, mip-NeRF-360's ``images_{n}``
folders serve a ``downsample``, ``test_traj`` gives a spheric path, and
HDR-NeRF scenes carry each image's exposure.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .base import BaseDataset
from .colmap_utils import (
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
)
from .color_utils import read_image
from ..ops.rays import center_poses, create_spheric_poses


class ColmapDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, read_meta=True, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if read_meta:
            self.read_meta(split)

    def read_intrinsics(self):
        camdata = read_cameras_binary(
            os.path.join(self.root_dir, "sparse/0/cameras.bin")
        )
        h = int(camdata[1].height * self.downsample)
        w = int(camdata[1].width * self.downsample)
        self.img_wh = (w, h)

        if camdata[1].model == "SIMPLE_RADIAL":
            fx = fy = camdata[1].params[0] * self.downsample
            cx = camdata[1].params[1] * self.downsample
            cy = camdata[1].params[2] * self.downsample
        elif camdata[1].model in ["PINHOLE", "OPENCV"]:
            fx = camdata[1].params[0] * self.downsample
            fy = camdata[1].params[1] * self.downsample
            cx = camdata[1].params[2] * self.downsample
            cy = camdata[1].params[3] * self.downsample
        else:
            raise ValueError(
                f"Please parse the intrinsics for camera model "
                f"{camdata[1].model}!"
            )
        self.K = np.float32([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        self._set_directions()

    def read_meta(self, split):
        imdata = read_images_binary(
            os.path.join(self.root_dir, "sparse/0/images.bin")
        )
        img_names = [imdata[k].name for k in imdata]
        perm = np.argsort(img_names)
        if "360_v2" in self.root_dir and self.downsample < 1:
            folder = f"images_{int(1 / self.downsample)}"
        else:
            folder = "images"
        img_paths = [
            os.path.join(self.root_dir, folder, name)
            for name in sorted(img_names)
        ]
        bottom = np.array([[0, 0, 0, 1.0]])
        w2c_mats = []
        for k in imdata:
            im = imdata[k]
            R = im.qvec2rotmat()
            t = im.tvec.reshape(3, 1)
            w2c_mats.append(
                np.concatenate([np.concatenate([R, t], 1), bottom], 0)
            )
        w2c_mats = np.stack(w2c_mats, 0)
        poses = np.linalg.inv(w2c_mats)[perm, :3]

        pts3d = read_points3d_binary(
            os.path.join(self.root_dir, "sparse/0/points3D.bin")
        )
        pts3d = np.array([pts3d[k].xyz for k in pts3d])

        self.poses, self.pts3d = center_poses(poses, pts3d)
        scale = np.linalg.norm(self.poses[..., 3], axis=-1).min()
        self.poses[..., 3] /= scale
        self.pts3d /= scale

        if split == "test_traj":
            self.poses = np.array(
                [x for i, x in enumerate(self.poses) if i % 8 == 0]
            )
            self.poses = create_spheric_poses(
                1.2, self.poses[:, 1, 3].mean()
            ).astype(np.float32)
            return

        exposures = None
        if "HDR-NeRF" in self.root_dir:
            img_paths, exposures = self._hdr_nerf_split(split, img_paths)
        else:
            # every 8th image is test
            if split == "train":
                img_paths = [x for i, x in enumerate(img_paths) if i % 8 != 0]
                self.poses = np.array(
                    [x for i, x in enumerate(self.poses) if i % 8 != 0]
                )
            elif split == "test":
                img_paths = [x for i, x in enumerate(img_paths) if i % 8 == 0]
                self.poses = np.array(
                    [x for i, x in enumerate(self.poses) if i % 8 == 0]
                )

        rays = []
        for i, img_path in enumerate(img_paths):
            buf = [read_image(img_path, self.img_wh, blend_a=False)]
            if exposures is not None:
                buf.append(
                    np.full_like(buf[0][:, :1], exposures[i], np.float32)
                )
            rays.append(np.concatenate(buf, axis=1))
        if rays:
            self.rays = np.stack(rays).astype(np.float32)
        self.poses = np.asarray(self.poses, np.float32)

    def _hdr_nerf_split(self, split, img_paths):
        """HDR-NeRF splits + per-image exposure."""
        root = self.root_dir
        if "syndata" in root:
            self.unit_exposure_rgb = 0.73
            if split == "train":
                img_paths = sorted(
                    glob.glob(os.path.join(root, "train/*[024].png"))
                )
                self.poses = np.repeat(self.poses[-18:], 3, 0)
            elif split == "test":
                img_paths = sorted(
                    glob.glob(os.path.join(root, "test/*[13].png"))
                )
                self.poses = np.repeat(self.poses[:17], 2, 0)
            else:
                raise ValueError(f"split {split} is invalid for HDR-NeRF!")
        else:
            self.unit_exposure_rgb = 0.5
            if split == "train":
                img_paths = sorted(
                    glob.glob(os.path.join(root, "input_images/*0.jpg"))
                )[::2]
                img_paths += sorted(
                    glob.glob(os.path.join(root, "input_images/*2.jpg"))
                )[::2]
                img_paths += sorted(
                    glob.glob(os.path.join(root, "input_images/*4.jpg"))
                )[::2]
                self.poses = np.tile(self.poses[::2], (3, 1, 1))
            elif split == "test":
                img_paths = sorted(
                    glob.glob(os.path.join(root, "input_images/*1.jpg"))
                )[1::2]
                img_paths += sorted(
                    glob.glob(os.path.join(root, "input_images/*3.jpg"))
                )[1::2]
                self.poses = np.tile(self.poses[1::2], (2, 1, 1))
            else:
                raise ValueError(f"split {split} is invalid for HDR-NeRF!")

        scene = os.path.basename(os.path.normpath(root))
        e_dicts = {
            **{s: {e: 1 / 8 * 4**e for e in range(5)}
               for s in ["bathroom", "bear", "chair", "desk"]},
            **{s: {e: 1 / 16 * 4**e for e in range(5)}
               for s in ["diningroom", "dog"]},
            "sofa": {0: 0.25, 1: 1, 2: 2, 3: 4, 4: 16},
            "sponza": {0: 0.5, 1: 2, 2: 4, 3: 8, 4: 32},
            "box": {0: 2 / 3, 1: 1 / 3, 2: 1 / 6, 3: 0.1, 4: 0.05},
            "computer": {0: 1 / 3, 1: 1 / 8, 2: 1 / 15, 3: 1 / 30, 4: 1 / 60},
            "flower": {0: 1 / 3, 1: 1 / 6, 2: 0.1, 3: 0.05, 4: 1 / 45},
            "luckycat": {0: 2, 1: 1, 2: 0.5, 3: 0.25, 4: 0.125},
        }
        e_dict = e_dicts.get(scene, {e: 1.0 for e in range(5)})
        exposures = [
            e_dict[int(p.split(".")[0][-1])] for p in img_paths
        ]
        return img_paths, exposures
