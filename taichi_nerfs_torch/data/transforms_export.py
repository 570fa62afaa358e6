"""Write in-memory datasets in the Blender and instant-ngp layouts.

Copy of the JAX package's ``data/transforms_export.py``; the PNGs go
through the port's own writer (``utils/viz.py:write_png``).  With these and
``nsvf_export.py`` the file loaders run end to end on procedural scenes:

* Blender: ``transforms_{split}.json`` and ``r_{split}_{i}.png`` per frame,
  read back by ``NeRFDataset`` (intrinsics from the field of view at the
  800x800 base resolution, the axis flip, each camera at radius 1.5);
* instant-ngp: one ``transforms.json`` with ``fl_x``, ``fl_y``, ``w``,
  ``h`` and the image files, read back by ``NGPDataset`` (the axis flip
  only; poses kept).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from ..utils.viz import write_png


def _write_images(root: str, ds, names) -> None:
    w, h = ds.img_wh
    imgs = np.asarray(ds.rays, np.float32).reshape(-1, h, w, 3)
    for img, name in zip(imgs, names):
        write_png(
            os.path.join(root, name),
            np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8),
        )


def _flip_pose(pose: np.ndarray) -> np.ndarray:
    """[right down front] -> [right up back] (the loaders' inverse)."""
    c2w = np.concatenate(
        [np.asarray(pose, np.float64), [[0, 0, 0, 1]]], axis=0
    )
    c2w[:3, 1:3] *= -1
    return c2w


def export_blender_dataset(root: str, datasets: dict) -> None:
    """Write ``datasets`` (split -> BaseDataset-like) as a blender scene.

    ``NeRFDataset`` renormalizes every camera to radius 1.5, so sources must sit at radius 1.5 for an exact pose
    round-trip; the focal is stored 800-based so loading with
    ``downsample = w/800`` round-trips K.
    """
    os.makedirs(root, exist_ok=True)
    for split, ds in datasets.items():
        w, h = ds.img_wh
        assert w == h, "loader assumes square 800-based images"
        fx800 = float(ds.K[0, 0]) * (800.0 / w)
        frames = []
        names = [f"r_{split}_{i}" for i in range(len(ds.poses))]
        for pose, name in zip(ds.poses, names):
            frames.append(
                {
                    "file_path": f"./{name}",
                    "transform_matrix": _flip_pose(pose).tolist(),
                }
            )
        meta = {
            "camera_angle_x": 2.0 * math.atan(0.5 * 800.0 / fx800),
            "frames": frames,
        }
        with open(
            os.path.join(root, f"transforms_{split}.json"), "w"
        ) as f:
            json.dump(meta, f)
        _write_images(root, ds, [n + ".png" for n in names])


def export_ngp_dataset(root: str, ds) -> None:
    """Write one split as an instant-ngp scene (``transforms.json``).

    ``NGPDataset`` applies only the axis flip, so poses
    and K round-trip exactly at ``downsample=1``.
    """
    os.makedirs(root, exist_ok=True)
    w, h = ds.img_wh
    names = [f"{i:04d}.png" for i in range(len(ds.poses))]
    frames = [
        {"file_path": name, "transform_matrix": _flip_pose(pose).tolist()}
        for pose, name in zip(ds.poses, names)
    ]
    meta = {
        "w": w,
        "h": h,
        "fl_x": float(ds.K[0, 0]),
        "fl_y": float(ds.K[1, 1]),
        "frames": frames,
    }
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump(meta, f)
    _write_images(root, ds, names)
