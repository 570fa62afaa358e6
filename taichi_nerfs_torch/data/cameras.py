"""Camera rig helpers (numpy), copied from the JAX package's synthetic rig.

``look_at`` is the JAX package's ``data/synthetic.py:look_at``; the
intrinsics and the orbit radius are the synthetic rig's (``focal = 0.9 *
w``, ``cam_radius = 1.2``).  Copied, not imported: importing anything of
the JAX package imports JAX.
"""

from __future__ import annotations

import numpy as np


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Camera-to-world with [right down front] axes (OpenCV convention)."""
    front = target - eye
    front = front / np.linalg.norm(front)
    right = np.cross(front, up)
    right = right / np.linalg.norm(right)
    down = np.cross(front, right)
    return np.stack([right, down, front, eye], axis=1).astype(np.float32)


def intrinsics(w: int, h: int) -> np.ndarray:
    """The synthetic rig's pinhole K: focal 0.9 * w, centred."""
    focal = 0.9 * w
    return np.array(
        [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32
    )


def orbit_poses(
    n: int,
    radius: float = 1.2,
    elevation: float = 0.5,
    target=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """(n, 3, 4) camera-to-world poses evenly spaced on a circle around
    the z axis at ``elevation`` radians, looking at ``target`` with +z up."""
    poses = []
    for i in range(n):
        theta = 2.0 * np.pi * i / n
        eye = radius * np.array(
            [
                np.cos(theta) * np.cos(elevation),
                np.sin(theta) * np.cos(elevation),
                np.sin(elevation),
            ]
        )
        poses.append(
            look_at(eye, np.asarray(target, np.float64),
                    np.array([0.0, 0.0, 1.0]))
        )
    return np.stack(poses)
