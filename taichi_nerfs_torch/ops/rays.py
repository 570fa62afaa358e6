"""Ray generation, ray / AABB intersection and the host-side pose helpers.

Port of the JAX package's ``ops/rays.py``.  The ray math is fp32 and
written as elementwise products and sums over the 3-axis, so no TF32 matmul
can round a ray on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import NEAR_DISTANCE


def get_ray_directions(
    H: int,
    W: int,
    K,
    random: bool = False,
    generator: torch.Generator | None = None,
    flatten: bool = True,
    return_uv: bool = False,
    device=None,
):
    """Per-pixel ray directions in the camera frame [right down front],
    through pixel centres, or at uniform offsets inside each pixel
    (``random``, drawn from ``generator``)."""
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)
    u = torch.arange(W, dtype=torch.float32, device=device)
    v = torch.arange(H, dtype=torch.float32, device=device)
    v, u = torch.meshgrid(v, u, indexing="ij")  # (H, W)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if random:
        du = torch.rand(u.shape, generator=generator, device=device)
        dv = torch.rand(v.shape, generator=generator, device=device)
    else:
        du = dv = 0.5
    directions = torch.stack(
        [(u - cx + du) / fx, (v - cy + dv) / fy, torch.ones_like(u)], dim=-1
    )
    uv = torch.stack([u, v], dim=-1)
    if flatten:
        directions = directions.reshape(-1, 3)
        uv = uv.reshape(-1, 2)
    if return_uv:
        return directions, uv
    return directions


def get_ray_directions_np(H: int, W: int, K) -> np.ndarray:
    """Numpy twin of :func:`get_ray_directions` (pixel centres,
    flattened) for host-side dataset preparation."""
    K = np.asarray(K, np.float32)
    u, v = np.meshgrid(
        np.arange(W, dtype=np.float32),
        np.arange(H, dtype=np.float32),
        indexing="xy",
    )
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    directions = np.stack(
        [(u - cx + 0.5) / fx, (v - cy + 0.5) / fy, np.ones_like(u)], axis=-1
    )
    return directions.reshape(-1, 3).astype(np.float32)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """Camera-frame directions (N, 3) and a pose (3, 4) or per-ray poses
    (N, 3, 4) -> world origins and (unnormalised) directions, (N, 3) each."""
    directions = directions.to(torch.float32)
    c2w = c2w.to(torch.float32)
    rot = c2w[..., :3]
    if c2w.ndim == 2:
        rays_d = torch.sum(directions[:, None, :] * rot[None], dim=-1)
        rays_o = c2w[:, 3].expand(rays_d.shape)
    else:
        rays_d = torch.sum(directions[:, None, :] * rot, dim=-1)
        rays_o = c2w[..., 3]
    return rays_o, rays_d


def axisangle_to_R(v: torch.Tensor) -> torch.Tensor:
    """Axis-angle (3,) or (N, 3) -> rotation matrix (Rodrigues)."""
    single = v.ndim == 1
    v = torch.atleast_2d(v)
    zero = torch.zeros_like(v[:, :1])
    skew_v0 = torch.cat([zero, -v[:, 2:3], v[:, 1:2]], 1)
    skew_v1 = torch.cat([v[:, 2:3], zero, -v[:, 0:1]], 1)
    skew_v2 = torch.cat([-v[:, 1:2], v[:, 0:1], zero], 1)
    skew_v = torch.stack([skew_v0, skew_v1, skew_v2], dim=1)
    norm_v = (torch.linalg.norm(v, dim=1) + 1e-7)[:, None, None]
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    sq = torch.sum(skew_v[:, :, :, None] * skew_v[:, None, :, :], dim=2)
    R = (
        eye
        + (torch.sin(norm_v) / norm_v) * skew_v
        + ((1 - torch.cos(norm_v)) / norm_v**2) * sq
    )
    return R[0] if single else R


def ray_aabb_intersect(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """Slab test against [-scale, scale]^3: (N, 2) ``(max(t1, NEAR), t2)``
    on a hit, ``(-1, -1)`` on a miss."""
    inv_d = 1.0 / rays_d
    t_min = (-scale - rays_o) * inv_d
    t_max = (scale - rays_o) * inv_d
    t1 = torch.amax(torch.minimum(t_min, t_max), dim=-1)
    t2 = torch.amin(torch.maximum(t_min, t_max), dim=-1)
    hit = t2 > 0.0
    near = torch.clamp(t1, min=NEAR_DISTANCE)
    return torch.where(
        hit[:, None],
        torch.stack([near, t2], dim=-1),
        torch.full_like(rays_o[:, :2], -1.0),
    )


# ------------------------------------------- pose preprocessing (numpy)


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray, pts3d: np.ndarray | None = None):
    """Average pose used for centring."""
    center = pts3d.mean(0) if pts3d is not None else poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray, pts3d: np.ndarray | None = None):
    """Recentre poses (and points) about the average pose."""
    pose_avg = average_poses(poses, pts3d)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    pose_avg_inv = np.linalg.inv(pose_avg_homo)
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = (pose_avg_inv @ poses_homo)[:, :3]
    if pts3d is not None:
        pts3d_centered = pts3d @ pose_avg_inv[:3, :3].T + pose_avg_inv[:3, 3]
        return poses_centered, pts3d_centered
    return poses_centered


def create_spheric_poses(radius: float, mean_h: float, n_poses: int = 120):
    """Circular test trajectory."""

    def spheric_pose(theta, phi, radius):
        trans_t = np.array(
            [[1, 0, 0, 0], [0, 1, 0, 2 * mean_h], [0, 0, 1, -radius]],
            dtype=float,
        )
        rot_phi = np.array(
            [[1, 0, 0], [0, np.cos(phi), -np.sin(phi)],
             [0, np.sin(phi), np.cos(phi)]]
        )
        rot_theta = np.array(
            [[np.cos(theta), 0, -np.sin(theta)], [0, 1, 0],
             [np.sin(theta), 0, np.cos(theta)]]
        )
        c2w = rot_theta @ rot_phi @ trans_t
        return np.array([[-1, 0, 0], [0, 0, 1], [0, 1, 0]], dtype=float) @ c2w

    return np.stack(
        [
            spheric_pose(th, -np.pi / 12, radius)
            for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]
        ],
        0,
    )
