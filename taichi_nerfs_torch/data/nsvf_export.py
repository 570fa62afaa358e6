"""Write an in-memory dataset in the NSVF layout.

Copy of the JAX package's ``data/nsvf_export.py``; the PNGs go through the
port's own writer (``utils/viz.py:write_png``).  It writes what
``NSVFDataset`` reads back::

    <root>/
      intrinsics.txt      # first token = focal (Synthetic branch)
      bbox.txt            # xyz_min xyz_max (6 floats)
      rgb/<p>_%04d.png    # 8-bit images, split prefix p in {0,1,2}
      pose/<p>_%04d.txt   # 4x4 camera-to-world, world units

The loader maps poses into the unit scene box (``t_norm = (t_disk - shift)
/ (2 * scale)`` with ``shift`` the bbox centre and ``scale`` its
half-extent times 1.05); this writer applies the exact inverse, so a load
gives back the source dataset's poses.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.viz import write_png

_SPLIT_PREFIX = {"train": 0, "val": 1, "test": 2}


def export_nsvf_dataset(root: str, datasets: dict) -> None:
    """Write ``datasets`` (split name -> BaseDataset-like) as NSVF layout.

    All splits must share K / img_wh.  The root path must contain
    ``Synthetic`` (selects the loader's fx-only intrinsics branch and its
    800^2 resolution assumption) and must not contain the per-scene fudge
    substrings (``Lego``, ``Mic``, ``Jade``, ``Fountain``).
    """
    assert "Synthetic" in root, "loader branch requires 'Synthetic' in path"
    for bad in ("Lego", "Mic", "Jade", "Fountain"):
        assert bad not in root, f"'{bad}' triggers a per-scene fudge"
    first = next(iter(datasets.values()))
    w, h = first.img_wh
    # the loader's Synthetic branch fixes the base resolution at 800^2 and
    # scales by --downsample; store the 800-equivalent focal so a load at
    # downsample = w/800 round-trips K exactly
    assert w == h, "loader's Synthetic branch assumes square images"

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "pose"), exist_ok=True)

    fx800 = float(first.K[0, 0]) * (800.0 / w)
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write(f"{fx800} 0.0 400.0 0.0\n")

    # bbox half-extent b: the loader computes scale = b * 1.05 and divides
    # translations by 2*scale; b = 0.5/1.05 makes that divisor exactly 1,
    # so on-disk poses ARE the normalized poses
    b = 0.5 / 1.05
    with open(os.path.join(root, "bbox.txt"), "w") as f:
        f.write(f"{-b} {-b} {-b} {b} {b} {b} 0.01\n")

    for split, ds in datasets.items():
        p = _SPLIT_PREFIX[split]
        imgs = ds.rays.reshape(len(ds.poses), h, w, 3)
        for i in range(len(ds.poses)):
            img8 = np.clip(
                np.round(imgs[i] * 255.0), 0, 255
            ).astype(np.uint8)
            write_png(os.path.join(root, "rgb", f"{p}_{i:04d}.png"), img8)
            c2w = np.eye(4, dtype=np.float64)
            c2w[:3] = ds.poses[i]
            np.savetxt(
                os.path.join(root, "pose", f"{p}_{i:04d}.txt"), c2w
            )
