"""Procedural synthetic scenes and their ground-truth renders, in torch.

Port of the JAX package's ``data/synthetic.py``: the soft ``sphere``, the
bumpy ``checker`` and the ``lego`` proxy build, seen from outside the scene
cube, and the hollow ``shell``, seen from cameras in its empty core looking
outward (radius at most 0.15, each looking at 4x its own position).  The
ground truth shares no code with the shear-warp renderer:

* :func:`render_gt_image` is the dense volume integrator (the JAX
  package's numpy oracle and its device version in one: fp32 torch on
  whatever device it is given);
* :func:`render_gt_image_lego` sphere-traces the lego build's SDF, shades
  the hit once (Lambert plus 2-tap ambient occlusion) and box-filters an
  ``ss`` x supersampled image, with the hit coverage as GT alpha.

Rays are made on the host in float64 as the JAX package makes them, then
cast to fp32 on the render device.  :class:`SyntheticSphereDataset` builds
the same rig (poses from ``np.random.RandomState(0)`` for train and ``1``
for test, in the same draw order), so both packages train on the same
views.  Nothing is cached on disk.
"""

from __future__ import annotations

import urllib.parse

import numpy as np
import torch

from .base import BaseDataset
from .cameras import look_at

_VARIANTS = ("sphere", "checker", "shell", "lego")


def sphere_density(xyz, radius: float = 0.3, sharp: float = 40.0):
    r = torch.linalg.norm(xyz, dim=-1)
    arg = torch.clamp(sharp * (r - radius), max=80.0)
    return 20.0 / (1.0 + torch.exp(arg))


def sphere_albedo(xyz):
    return torch.clamp(xyz + 0.5, 0.0, 1.0)


def checker_density(xyz, radius: float = 0.32):
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    bump = 0.04 * torch.sin(17.0 * x) * torch.sin(19.0 * y) * torch.sin(
        23.0 * z
    )
    r = torch.sqrt(x * x + y * y + z * z)
    arg = torch.clamp(80.0 * (r - (radius + bump)), max=80.0)
    return 40.0 / (1.0 + torch.exp(arg))


def checker_albedo(xyz):
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = 0.5 + 0.5 * torch.sin(40.0 * x) * torch.sin(40.0 * y)
    g = 0.5 + 0.5 * torch.sin(40.0 * y) * torch.sin(40.0 * z)
    b = 0.5 + 0.5 * torch.sin(40.0 * z) * torch.sin(40.0 * x)
    return torch.stack([r, g, b], dim=-1)


def shell_density(xyz, r_mid: float = 0.39, half: float = 0.05):
    """Hollow spherical shell: the inside-camera scene (cameras sit in the
    empty core and look outward)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    bump = 0.02 * torch.sin(17.0 * x) * torch.sin(19.0 * y) * torch.sin(
        23.0 * z
    )
    r = torch.sqrt(x * x + y * y + z * z)
    arg = torch.clamp(80.0 * (torch.abs(r - r_mid) - (half + bump)),
                      max=80.0)
    return 40.0 / (1.0 + torch.exp(arg))


_FIELDS = {
    "sphere": (sphere_density, sphere_albedo),
    "checker": (checker_density, checker_albedo),
    "shell": (shell_density, checker_albedo),
}

# the lego-proxy build, as in the JAX package:
# boxes (cx, cy, cz, hx, hy, hz, rot_deg, r, g, b)
_LEGO_BOXES = np.array(
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
_LEGO_CYLS = np.array(
    [
        (0.00, -0.02, -0.135, 0.135, 0.075, 0.93, 0.93, 0.90),
        (-0.26, -0.26, -0.285, -0.225, 0.038, 0.90, 0.90, 0.88),
    ],
    np.float32,
)
# stud fields (cx, cy, ext_x, ext_y, z_top, r, g, b)
_LEGO_STUDS = np.array(
    [
        (0.00, 0.00, 0.40, 0.40, -0.378, 0.45, 0.55, 0.44),
        (-0.15, -0.10, 0.16, 0.075, -0.255, 0.80, 0.13, 0.12),
        (0.13, 0.06, 0.08, 0.145, -0.255, 0.95, 0.75, 0.10),
        (0.17, -0.15, 0.06, 0.06, -0.137, 0.15, 0.60, 0.20),
    ],
    np.float32,
)
_STUD_R, _STUD_H, _STUD_P = 0.026, 0.016, 0.084
_LEGO_LIGHT = np.array([0.42, 0.25, 0.87], np.float32)
_LEGO_LIGHT /= np.linalg.norm(_LEGO_LIGHT)
_LEGO_COLORS = np.concatenate(
    [_LEGO_BOXES[:, 7:10], _LEGO_CYLS[:, 5:8], _LEGO_STUDS[:, 5:8]]
).astype(np.float32)


def _lego_sdf_parts(xyz):
    """SDF of every part of the build: a list of (...) fields."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    sdfs = []
    for cx, cy, cz, hx, hy, hz, rot, *_ in _LEGO_BOXES:
        qx, qy = x - cx, y - cy
        if rot != 0.0:
            c = float(np.cos(np.radians(rot)))
            s = float(np.sin(np.radians(rot)))
            qx, qy = c * qx + s * qy, -s * qx + c * qy
        d = torch.maximum(
            torch.maximum(torch.abs(qx) - hx, torch.abs(qy) - hy),
            torch.abs(z - cz) - hz,
        )
        sdfs.append(d)
    for cx, cy, zlo, zhi, r, *_ in _LEGO_CYLS:
        dr = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2) - r
        dz = torch.maximum(zlo - z, z - zhi)
        sdfs.append(torch.maximum(dr, dz))
    for cx, cy, ex, ey, zt, *_ in _LEGO_STUDS:
        qx, qy = x - cx, y - cy
        # fold onto the stud lattice; clamp centres inside the face
        bx = float(np.floor((ex - _STUD_R) / _STUD_P))
        by = float(np.floor((ey - _STUD_R) / _STUD_P))
        nx = torch.clamp(torch.round(qx / _STUD_P), -bx, bx)
        ny = torch.clamp(torch.round(qy / _STUD_P), -by, by)
        mx = qx - nx * _STUD_P
        my = qy - ny * _STUD_P
        dr = torch.sqrt(mx * mx + my * my) - _STUD_R
        dz = torch.maximum(zt - z, z - (zt + _STUD_H))
        sdfs.append(torch.maximum(dr, dz))
    return sdfs


def _lego_sdf(xyz):
    sdfs = _lego_sdf_parts(xyz)
    out = sdfs[0]
    for d in sdfs[1:]:
        out = torch.minimum(out, d)
    return out


def _gt_rays(c2w: np.ndarray, K: np.ndarray, w: int, h: int):
    """Host rays in float64, as the JAX package makes them."""
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    dirs_cam = np.stack(
        [
            (u - K[0, 2] + 0.5) / K[0, 0],
            (v - K[1, 2] + 0.5) / K[1, 1],
            np.ones_like(u, dtype=np.float64),
        ],
        axis=-1,
    ).reshape(-1, 3)
    rays_d = dirs_cam @ c2w[:, :3].T
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return rays_o, rays_d


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def render_gt_image(
    c2w: np.ndarray,
    K: np.ndarray,
    w: int,
    h: int,
    n_steps: int = 256,
    scale: float = 0.5,
    white_bg: bool = True,
    variant: str = "sphere",
    want_alpha: bool = False,
    device=None,
):
    """Dense volume integration of the ``sphere``, ``checker`` or
    ``shell`` scene.

    Returns (h*w, 3) rgb and, with ``want_alpha``, (h*w,) opacity, as fp32
    numpy arrays; the integration runs on ``device`` (the CPU if None).
    """
    if variant not in _FIELDS:
        raise ValueError(f"no volume field for variant {variant!r}")
    density_fn, albedo_fn = _FIELDS[variant]
    rays_o, rays_d = _gt_rays(np.asarray(c2w), np.asarray(K), w, h)
    ts_np = np.linspace(0.1, 2.5, n_steps, dtype=np.float32)
    dt = float(ts_np[1] - ts_np[0])
    ts = _on(ts_np, device)
    n = rays_d.shape[0]
    rgb = torch.empty((n, 3), dtype=torch.float32, device=device)
    opac = torch.empty((n,), dtype=torch.float32, device=device)
    chunk = max(1, (1 << 22) // n_steps)
    for i in range(0, n, chunk):
        ro = _on(rays_o[i : i + chunk], device)
        rd = _on(rays_d[i : i + chunk], device)
        xyz = ro[:, None, :] + ts[None, :, None] * rd[:, None, :]
        inside = torch.all(torch.abs(xyz) <= scale, dim=-1)
        sigma = density_fn(xyz) * inside
        alpha = 1.0 - torch.exp(-sigma * dt)
        trans = torch.cumprod(1.0 - alpha + 1e-12, dim=1) / (
            1.0 - alpha + 1e-12
        )
        wgt = alpha * trans
        out = torch.einsum("rs,rsc->rc", wgt, albedo_fn(xyz))
        t_end = trans[:, -1] * (1.0 - alpha[:, -1])
        if white_bg:
            out = out + t_end[:, None]
        rgb[i : i + chunk] = out
        opac[i : i + chunk] = 1.0 - t_end
    rgb = rgb.cpu().numpy()
    if want_alpha:
        return rgb, opac.cpu().numpy()
    return rgb


def render_gt_image_lego(
    c2w: np.ndarray,
    K: np.ndarray,
    w: int,
    h: int,
    n_steps: int = 128,
    scale: float = 0.5,
    white_bg: bool = True,
    ss: int = 2,
    chunk: int = 1 << 22,
    want_alpha: bool = False,
    device=None,
):
    """Surface render of the lego build: sphere-trace the SDF for
    ``n_steps``, shade the hit once (Lambert + 2-tap ambient occlusion),
    supersample ``ss`` x and box-filter.  Returns fp32 numpy arrays as
    :func:`render_gt_image`; the hit coverage is the GT alpha."""
    ws, hs = w * ss, h * ss
    Ks = np.asarray(K, np.float64) * float(ss)
    Ks[2, 2] = 1.0
    rays_o, rays_d = _gt_rays(np.asarray(c2w, np.float64), Ks, ws, hs)
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    colors = _on(_LEGO_COLORS, device)
    light = _on(_LEGO_LIGHT, device)
    bg = 1.0 if white_bg else 0.0

    def trace(ro, rd):
        t = torch.full(ro.shape[:1], 0.2, dtype=torch.float32, device=device)
        for _ in range(n_steps):
            d = _lego_sdf(ro + t[:, None] * rd)
            t = t + torch.clamp(d, min=1e-4) * 0.95
        p = ro + t[:, None] * rd
        d = _lego_sdf(p)
        inside = torch.all(torch.abs(p) <= scale, dim=-1)
        hit = (d < 3e-3) & inside
        idx = torch.argmin(torch.stack(_lego_sdf_parts(p), dim=0), dim=0)
        color = colors[idx]
        eps = 0.004
        grads = []
        for ax in range(3):
            e = torch.zeros(3, dtype=torch.float32, device=device)
            e[ax] = eps
            grads.append(_lego_sdf(p + e) - _lego_sdf(p - e))
        nrm = torch.stack(grads, dim=-1)
        nrm = nrm / torch.clamp(
            torch.sqrt(torch.sum(nrm * nrm, dim=-1, keepdim=True)), min=1e-6
        )
        lam = torch.clamp(torch.sum(nrm * light, dim=-1), 0.0, 1.0)
        ao = 0.0
        for r_ao, w_ao in ((0.02, 0.55), (0.06, 0.45)):
            ao = ao + w_ao * torch.clamp(
                _lego_sdf(p + r_ao * nrm) / r_ao, 0.0, 1.0
            )
        shade = (0.35 + 0.65 * lam) * (0.6 + 0.4 * ao)
        rgb = torch.where(hit[:, None], color * shade[..., None], bg)
        return torch.cat([rgb, hit[:, None].float()], dim=-1)

    n = rays_d.shape[0]
    outs = [
        trace(_on(rays_o[i : i + chunk], device),
              _on(rays_d[i : i + chunk], device))
        for i in range(0, n, chunk)
    ]
    img = torch.cat(outs, dim=0).reshape(hs, ws, 4)
    img = img.reshape(h, ss, w, ss, 4).mean(dim=(1, 3)).cpu().numpy()
    rgb = img[..., :3].reshape(h * w, 3).astype(np.float32)
    if want_alpha:
        return rgb, img[..., 3].reshape(h * w).astype(np.float32)
    return rgb


def parse_synthetic_spec(root_dir: str):
    """Parse a ``--root_dir`` scene spec: a bare variant name (``lego``) or
    ``synthetic://lego?views=100&res=800&radius=1.15&steps=512``.  Returns
    a dict of overrides (empty when the spec names no scene)."""
    if not root_dir:
        return {}
    s = root_dir
    if s.startswith("synthetic://"):
        s = s[len("synthetic://"):]
    query = ""
    if "?" in s:
        s, query = s.split("?", 1)
    name = s.strip("/").split("/")[-1].lower()
    if name not in _VARIANTS:
        return {}
    out = {"variant": name}
    q = urllib.parse.parse_qs(query)
    if "views" in q:
        out["n_images"] = int(q["views"][0])
    if "res" in q:
        r = int(q["res"][0])
        out["img_wh"] = (r, r)
    if "radius" in q:
        out["cam_radius"] = float(q["radius"][0])
    if "steps" in q:
        out["n_steps"] = int(q["steps"][0])
    return out


class SyntheticSphereDataset(BaseDataset):
    """The procedural rig: ``poses`` (N, 3, 4), ``rays`` (N, H*W, 3) GT
    rgb, ``alphas`` (N, H*W) GT opacity, ``K``, ``img_wh`` and the camera
    ``directions`` (H*W, 3), as numpy arrays.  GT images are rendered on
    ``device``."""

    def __init__(
        self,
        root_dir: str = "",
        split: str = "train",
        downsample: float = 1.0,
        n_images: int = 12,
        img_wh=(64, 64),
        cam_radius: float = 1.2,
        variant: str = "sphere",
        n_steps: int = 256,
        device=None,
    ):
        spec = parse_synthetic_spec(root_dir)
        variant = spec.get("variant", variant)
        n_images = spec.get("n_images", n_images)
        img_wh = spec.get("img_wh", img_wh)
        cam_radius = spec.get("cam_radius", cam_radius)
        n_steps = spec.get("n_steps", n_steps)
        if variant not in _VARIANTS:
            raise ValueError(f"unknown synthetic variant {variant!r}")
        if spec and split != "train":
            # held-out rig: enough views for a stable eval average
            n_images = max(8, min(25, n_images // 4))
        if spec and downsample != 1.0:
            img_wh = (int(img_wh[0] * downsample), int(img_wh[1] * downsample))
        super().__init__(root_dir, split, downsample)
        self.variant = variant
        w, h = img_wh
        focal = 0.9 * w
        self.K = np.array(
            [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32
        )
        self.img_wh = (w, h)
        render = render_gt_image_lego if variant == "lego" else render_gt_image
        kw = {} if variant == "lego" else {"variant": variant}
        # the shell's rig puts the cameras in its hollow core, looking out
        inside_rig = variant == "shell"
        if inside_rig and cam_radius >= 0.25:
            cam_radius = 0.15

        rng = np.random.RandomState(0 if split == "train" else 1)
        poses, rays, alphas = [], [], []
        for i in range(n_images):
            theta = 2 * np.pi * i / n_images + rng.uniform(0, 0.3)
            if variant == "lego":
                # upper hemisphere: the build sits on a base plate
                phi = rng.uniform(0.06, 1.15)
            else:
                phi = rng.uniform(-0.9, 0.9)
            eye = cam_radius * np.array(
                [
                    np.cos(theta) * np.cos(phi),
                    np.sin(theta) * np.cos(phi),
                    np.sin(phi),
                ]
            )
            if inside_rig:
                target = 4.0 * eye
            elif variant == "lego":
                target = np.array([0.0, 0.0, -0.12])
            else:
                target = np.zeros(3)
            c2w = look_at(eye, target, np.array([0.0, 0.0, 1.0]))
            poses.append(c2w)
            rgb, a = render(c2w, self.K, w, h, n_steps=n_steps,
                            want_alpha=True, device=device, **kw)
            rays.append(rgb)
            alphas.append(a)
        self.poses = np.stack(poses)
        self.rays = np.stack(rays)
        self.alphas = np.stack(alphas)
        self._set_directions()
