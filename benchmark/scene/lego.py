"""The procedural Lego scene every cell trains on or serves, frozen here.

A copy of the lego proxy of the program's ``data/synthetic.py`` (the build's
boxes, cylinders and stud fields, its signed distance, the density field
and the surface-rendered ground truth) and of its camera rig
(``data/cameras.py:look_at``, the synthetic rig's intrinsics and orbit).
It is a copy so that the benchmark's inputs never change with the program.
Everything runs in torch on the device it is given.
"""

from __future__ import annotations

import numpy as np
import torch

# boxes (cx, cy, cz, hx, hy, hz, rot_deg, r, g, b)
BOXES = np.array(
    [
        (0.00, 0.00, -0.400, 0.420, 0.420, 0.022, 0.0, 0.45, 0.55, 0.44),
        (-0.15, -0.10, -0.315, 0.180, 0.095, 0.060, 0.0, 0.80, 0.13, 0.12),
        (0.13, 0.06, -0.315, 0.100, 0.165, 0.060, 0.0, 0.95, 0.75, 0.10),
        (-0.09, 0.09, -0.195, 0.125, 0.100, 0.058, 25.0, 0.12, 0.30, 0.75),
        (0.17, -0.15, -0.195, 0.080, 0.080, 0.058, 0.0, 0.15, 0.60, 0.20),
        (-0.05, 0.24, -0.355, 0.240, 0.042, 0.040, -10.0, 0.90, 0.45, 0.10),
        (0.00, -0.02, 0.165, 0.105, 0.105, 0.030, 45.0, 0.80, 0.13, 0.12),
        (-0.26, -0.26, -0.330, 0.060, 0.060, 0.045, 0.0, 0.90, 0.90, 0.88),
    ],
    np.float32,
)
# cylinders (cx, cy, z_lo, z_hi, radius, r, g, b)
CYLS = np.array(
    [
        (0.00, -0.02, -0.135, 0.135, 0.075, 0.93, 0.93, 0.90),
        (-0.26, -0.26, -0.285, -0.225, 0.038, 0.90, 0.90, 0.88),
    ],
    np.float32,
)
# stud fields (cx, cy, ext_x, ext_y, z_top, r, g, b)
STUDS = np.array(
    [
        (0.00, 0.00, 0.40, 0.40, -0.378, 0.45, 0.55, 0.44),
        (-0.15, -0.10, 0.16, 0.075, -0.255, 0.80, 0.13, 0.12),
        (0.13, 0.06, 0.08, 0.145, -0.255, 0.95, 0.75, 0.10),
        (0.17, -0.15, 0.06, 0.06, -0.137, 0.15, 0.60, 0.20),
    ],
    np.float32,
)
STUD_R, STUD_H, STUD_P = 0.026, 0.016, 0.084
LIGHT = np.array([0.42, 0.25, 0.87], np.float32)
LIGHT /= np.linalg.norm(LIGHT)
COLORS = np.concatenate(
    [BOXES[:, 7:10], CYLS[:, 5:8], STUDS[:, 5:8]]).astype(np.float32)
# the lego rig looks at the build's centre, a little below the origin
TARGET = (0.0, 0.0, -0.12)


def _on(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def sdf_parts(xyz):
    """Signed distance of every part of the build: a list of (...) fields."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    sdfs = []
    for cx, cy, cz, hx, hy, hz, rot, *_ in BOXES:
        qx, qy = x - cx, y - cy
        if rot != 0.0:
            c = float(np.cos(np.radians(rot)))
            s = float(np.sin(np.radians(rot)))
            qx, qy = c * qx + s * qy, -s * qx + c * qy
        sdfs.append(torch.maximum(
            torch.maximum(torch.abs(qx) - hx, torch.abs(qy) - hy),
            torch.abs(z - cz) - hz))
    for cx, cy, zlo, zhi, r, *_ in CYLS:
        dr = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2) - r
        sdfs.append(torch.maximum(dr, torch.maximum(zlo - z, z - zhi)))
    for cx, cy, ex, ey, zt, *_ in STUDS:
        qx, qy = x - cx, y - cy
        # fold onto the stud lattice; clamp centres inside the face
        bx = float(np.floor((ex - STUD_R) / STUD_P))
        by = float(np.floor((ey - STUD_R) / STUD_P))
        nx = torch.clamp(torch.round(qx / STUD_P), -bx, bx)
        ny = torch.clamp(torch.round(qy / STUD_P), -by, by)
        mx = qx - nx * STUD_P
        my = qy - ny * STUD_P
        dr = torch.sqrt(mx * mx + my * my) - STUD_R
        sdfs.append(torch.maximum(dr, torch.maximum(zt - z, z - (zt + STUD_H))))
    return sdfs


def sdf(xyz):
    parts = sdf_parts(xyz)
    out = parts[0]
    for d in parts[1:]:
        out = torch.minimum(out, d)
    return out


def density(xyz):
    """Solid plastic: a sharp sigmoid of the union SDF (edge ~2 voxels at
    256^3)."""
    return 60.0 / (1.0 + torch.exp(torch.clamp(220.0 * sdf(xyz), max=80.0)))


def density_grid(res: int, device=None) -> torch.Tensor:
    """:func:`density` at the centres of a ``res``^3 grid over the scene
    cube [-0.5, 0.5]^3, indexed [x, y, z]; 16 x-slabs at a time."""
    c = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    c = c - 0.5
    out = torch.empty((res,) * 3, dtype=torch.float32, device=device)
    for i in range(0, res, 16):
        xyz = torch.stack(torch.meshgrid(c[i:i + 16], c, c, indexing="ij"),
                          dim=-1)
        out[i:i + 16] = density(xyz)
    return out


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-to-world (3, 4) with [right down front] axes (OpenCV)."""
    eye = np.asarray(eye, np.float64)
    front = np.asarray(target, np.float64) - eye
    front = front / np.linalg.norm(front)
    right = np.cross(front, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(front, right)
    return np.stack([right, down, front, eye], axis=1).astype(np.float32)


def intrinsics(w: int, h: int) -> np.ndarray:
    """The synthetic rig's pinhole K: focal 0.9 w, centred."""
    f = 0.9 * w
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def orbit_pose(theta: float, phi: float, radius: float = 1.2) -> np.ndarray:
    """A camera on the sphere of ``radius`` at azimuth ``theta`` and
    elevation ``phi`` (radians), looking at the build."""
    eye = radius * np.array([np.cos(theta) * np.cos(phi),
                             np.sin(theta) * np.cos(phi), np.sin(phi)])
    return look_at(eye, TARGET)


def rig_poses(n: int, radius: float = 1.2, rig_seed: int = 0,
              elevation=(0.06, 1.15), jitter: float = 0.3) -> np.ndarray:
    """(n, 3, 4) cameras of the lego rig: azimuths spread evenly with a
    jitter of up to ``jitter`` rad, elevations uniform over ``elevation``
    rad (the upper hemisphere: the build sits on a base plate), drawn from
    ``RandomState(rig_seed)`` in the rig's order; seed 0 gives the training
    views, 1 the test views."""
    rng = np.random.RandomState(rig_seed)
    out = []
    for i in range(n):
        theta = 2 * np.pi * i / n + rng.uniform(0, jitter)
        phi = rng.uniform(*elevation)
        out.append(orbit_pose(theta, phi, radius))
    return np.stack(out)


def train_poses(n: int, radius: float = 1.2) -> np.ndarray:
    """(n, 3, 4) the lego training rig (the same views for every seed)."""
    return rig_poses(n, radius, rig_seed=0)


def render_gt(poses, K, w: int, h: int, n_steps: int = 128, ss: int = 2,
              scale: float = 0.5, chunk: int = 1 << 23, device=None):
    """Surface render of the build for every pose: sphere-trace the SDF for
    ``n_steps``, shade the hit once (Lambert plus 2-tap ambient occlusion)
    over a white background, supersample ``ss`` x and box-filter.  Returns
    fp32 ``(rgb (N, h*w, 3), alpha (N, h*w))`` on ``device``; the rays of
    all views are traced together, ``chunk`` at a time."""
    poses = np.asarray(poses, np.float64).reshape(-1, 3, 4)
    ws, hs = w * ss, h * ss
    Ks = np.asarray(K, np.float64) * float(ss)
    Ks[2, 2] = 1.0
    u, v = np.meshgrid(np.arange(ws), np.arange(hs))
    cam = np.stack([(u - Ks[0, 2] + 0.5) / Ks[0, 0],
                    (v - Ks[1, 2] + 0.5) / Ks[1, 1],
                    np.ones_like(u, dtype=np.float64)], -1).reshape(-1, 3)
    cam_t = _on(cam, device)
    colors, light = _on(COLORS, device), _on(LIGHT, device)
    rot = _on(poses[:, :, :3], device)  # (N, 3, 3)
    eyes = _on(poses[:, :, 3], device)  # (N, 3)
    n_pix = cam.shape[0]

    def trace(ro, rd):
        t = torch.full(ro.shape[:1], 0.2, dtype=torch.float32, device=device)
        for _ in range(n_steps):
            t = t + torch.clamp(sdf(ro + t[:, None] * rd), min=1e-4) * 0.95
        p = ro + t[:, None] * rd
        hit = (sdf(p) < 3e-3) & torch.all(torch.abs(p) <= scale, dim=-1)
        color = colors[torch.argmin(torch.stack(sdf_parts(p), 0), 0)]
        grads = []
        for ax in range(3):
            e = torch.zeros(3, dtype=torch.float32, device=device)
            e[ax] = 0.004
            grads.append(sdf(p + e) - sdf(p - e))
        nrm = torch.stack(grads, -1)
        nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1,
                                                         keepdim=True),
                                min=1e-6)
        lam = torch.clamp(torch.sum(nrm * light, -1), 0.0, 1.0)
        ao = 0.0
        for r_ao, w_ao in ((0.02, 0.55), (0.06, 0.45)):
            ao = ao + w_ao * torch.clamp(sdf(p + r_ao * nrm) / r_ao, 0.0, 1.0)
        shade = (0.35 + 0.65 * lam) * (0.6 + 0.4 * ao)
        rgb = torch.where(hit[:, None], color * shade[:, None], 1.0)
        return torch.cat([rgb, hit[:, None].float()], -1)

    total = poses.shape[0] * n_pix
    out = torch.empty((total, 4), dtype=torch.float32, device=device)
    for s in range(0, total, chunk):
        idx = torch.arange(s, min(s + chunk, total), device=device)
        view, pix = idx // n_pix, idx % n_pix
        d = torch.einsum("rij,rj->ri", rot[view], cam_t[pix])
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        out[s:s + idx.numel()] = trace(eyes[view], d)
    img = out.reshape(-1, h, ss, w, ss, 4).mean(dim=(2, 4))
    img = img.reshape(-1, h * w, 4)
    return img[..., :3].contiguous(), img[..., 3].contiguous()
