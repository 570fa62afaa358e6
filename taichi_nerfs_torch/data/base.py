"""Dataset base: host-side numpy arrays, a device-side :class:`Batch`.

Port of the JAX package's ``data/base.py``.  A loader fills ``rays``
(N_images, H*W, C), ``poses`` (N_images, 3, 4), ``K`` and ``img_wh`` as
numpy and calls :meth:`BaseDataset._set_directions`; :meth:`as_batch`
moves them to a device once, and the trainer draws (image, pixel) pairs
there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rays import get_ray_directions_np
from ..train.step import Batch


class BaseDataset:
    def __init__(self, root_dir: str = "", split: str = "train",
                 downsample: float = 1.0):
        self.root_dir = root_dir
        self.split = split
        self.downsample = downsample
        self.rays: np.ndarray = np.zeros((0, 0, 3), np.float32)
        self.poses: np.ndarray = np.zeros((0, 3, 4), np.float32)
        self.K: np.ndarray = np.eye(3, dtype=np.float32)
        self.img_wh = (0, 0)
        self.directions: np.ndarray = np.zeros((0, 3), np.float32)

    def _set_directions(self):
        w, h = self.img_wh
        self.directions = get_ray_directions_np(h, w, self.K)

    def __len__(self) -> int:
        return len(self.poses)

    def as_batch(self, device=None):
        """The training arrays as a ``train/step.py:Batch`` on
        ``device``."""

        def on(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return Batch(rays=on(self.rays[..., :3]), poses=on(self.poses),
                     directions=on(self.directions))

    def __getitem__(self, idx: int):
        """Full-image item for eval loops."""
        sample = {"pose": self.poses[idx], "img_idxs": idx}
        if len(self.rays) > 0:
            sample["rgb"] = self.rays[idx][:, :3]
        return sample
