"""Interactive viewer: an orbit camera over full-image renders.

Port of the JAX package's ``viewer/gui.py``.  Each frame renders the whole
image from the orbit camera's pose: an NGP-path model through
``ops/rays`` and ``render/renderer.render_image`` on the device of its
params, or any other model through ``render_fn`` (the train entry passes
``SwrTrainer.render`` for the pyramid, so its frames run the sweep
kernel).  Frames show in an OpenCV window when ``cv2`` imports and
``DISPLAY`` is set; otherwise :meth:`NGPGUI.render` runs headless,
orbiting a little each frame and handing each frame to
``frame_callback``.  ``cv2`` is imported only inside :meth:`NGPGUI.render`.

Controls (window): drag to orbit, ``w``/``s`` to dolly, ``a``/``d``/``e``/
``c`` to pan, ``t`` toggles rgb/depth, number keys jump to dataset poses,
ESC or ``q`` quits.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.rays import get_ray_directions, get_rays
from ..render.renderer import render_image
from ..utils.viz import depth2img


def _rotvec_to_matrix(v: np.ndarray) -> np.ndarray:
    """Rodrigues rotation."""
    theta = np.linalg.norm(v)
    if theta < 1e-12:
        return np.eye(3)
    k = v / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


class OrbitCamera:
    """Orbit / dolly / pan camera around ``center``."""

    def __init__(self, K, img_wh, poses, r: float):
        self.K = np.asarray(K, np.float32)
        self.W, self.H = img_wh
        self.radius = r
        self.center = np.zeros(3)
        self.rot = np.asarray(poses)[0][:3, :3].copy()
        self.rotate_speed = 0.8

    @property
    def pose(self) -> np.ndarray:
        res = np.eye(4)
        res[2, 3] -= self.radius
        rot = np.eye(4)
        rot[:3, :3] = self.rot
        res = rot @ res
        res[:3, 3] -= self.center
        return res[:3]

    def reset(self, pose: Optional[np.ndarray] = None):
        self.rot = np.eye(3)
        self.center = np.zeros(3)
        self.radius = 2.0
        if pose is not None:
            self.rot = np.asarray(pose)[:3, :3].copy()

    def orbit(self, dx: float, dy: float):
        rotvec_x = self.rot[:, 1] * np.radians(100 * self.rotate_speed * dx)
        rotvec_y = self.rot[:, 0] * np.radians(-100 * self.rotate_speed * dy)
        self.rot = (
            _rotvec_to_matrix(rotvec_y)
            @ _rotvec_to_matrix(rotvec_x)
            @ self.rot
        )

    def scale(self, delta: float):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0):
        self.center += 1e-4 * self.rot @ np.array([dx, dy, dz])


def _host(x) -> np.ndarray:
    """A frame channel on the host: uint8 as it is, anything else fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype != torch.uint8:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class NGPGUI:
    """The viewer of one trained model (NGP path, or ``render_fn``)."""

    def __init__(
        self,
        cfg: Config,
        params,
        bitfield,
        K,
        img_wh,
        poses,
        radius: float = 4.5,
        frame_callback: Optional[Callable[[np.ndarray], None]] = None,
        render_fn: Optional[Callable] = None,
    ):
        self.cfg = cfg
        self.params = params
        self.bitfield = bitfield
        self.poses = np.asarray(poses)
        self.cam = OrbitCamera(K, img_wh, poses, r=radius)
        self.W, self.H = img_wh
        self.img_mode = 0  # 0 rgb, 1 depth
        self.dt = 0.0
        self.mean_samples = 0.0
        self.frame_callback = frame_callback
        # pluggable frame renderer (e.g. the shear-warp pyramid):
        # (pose (3, 4), K, img_wh) -> {"rgb", "depth", ...}
        self.render_fn = render_fn

    @torch.no_grad()
    def render_frame(self) -> np.ndarray:
        """One full-image render from the current camera, as uint8 rgb or
        a colour-mapped depth.  ``dt`` runs from the start of the frame to
        the displayed channel on the host."""
        t0 = time.time()
        pose = self.cam.pose.astype(np.float32)
        if self.render_fn is not None:
            out = self.render_fn(pose, self.cam.K, (self.W, self.H))
        else:
            dev = self.bitfield.device
            directions = get_ray_directions(self.cam.H, self.cam.W,
                                            self.cam.K, device=dev)
            rays_o, rays_d = get_rays(directions,
                                      torch.as_tensor(pose, device=dev))
            out = render_image(self.params, self.cfg, self.bitfield,
                               rays_o, rays_d)
        # fetch only the displayed channel
        key = "rgb" if self.img_mode == 0 else "depth"
        img = _host(out[key])
        self.dt = time.time() - t0
        self.mean_samples = float(out.get("total_samples", 0)) / (
            self.W * self.H)
        if self.img_mode == 1:
            return depth2img(img.reshape(self.H, self.W))
        rgb = img.reshape(self.H, self.W, 3)
        if rgb.dtype == np.uint8:  # render_fn quantized on the device
            return rgb
        return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)

    def _handle_key(self, key: int) -> bool:
        step = 0.05
        if key in (27, ord("q")):
            return False
        if key == ord("t"):
            self.img_mode = 1 - self.img_mode
        elif key == ord("w"):
            self.cam.scale(step)
        elif key == ord("s"):
            self.cam.scale(-step)
        elif key == ord("a"):
            self.cam.pan(100, 0)
        elif key == ord("d"):
            self.cam.pan(-100, 0)
        elif key == ord("e"):
            self.cam.pan(0, -150)
        elif key == ord("c"):
            self.cam.pan(0, 150)
        elif ord("0") <= key <= ord("9"):
            idx = min(key - ord("0"), len(self.poses) - 1)
            self.cam.reset(self.poses[idx])
        return True

    def render(self, max_frames: Optional[int] = None):
        """The interactive loop; headless (``max_frames`` frames, 8 by
        default, returned as a list) without ``cv2`` or a display."""
        try:
            import cv2  # noqa: F401

            has_window = bool(os.environ.get("DISPLAY"))
        except ImportError:
            has_window = False

        if not has_window:
            n = max_frames or 8
            frames = []
            for i in range(n):
                self.cam.orbit(0.05, 0.0)
                frame = self.render_frame()
                frames.append(frame)
                if self.frame_callback:
                    self.frame_callback(frame)
                print(
                    f"frame {i}: {self.dt * 1000:.1f} ms "
                    f"({1.0 / max(self.dt, 1e-9):.1f} fps), "
                    f"samples/ray {self.mean_samples:.2f}"
                )
            return frames

        import cv2

        drag = {"on": False, "x": 0, "y": 0}

        def on_mouse(event, x, y, flags, _):
            if event == cv2.EVENT_LBUTTONDOWN:
                drag.update(on=True, x=x, y=y)
            elif event == cv2.EVENT_LBUTTONUP:
                drag["on"] = False
            elif event == cv2.EVENT_MOUSEMOVE and drag["on"]:
                self.cam.orbit(
                    (x - drag["x"]) / self.W, (y - drag["y"]) / self.H
                )
                drag.update(x=x, y=y)

        cv2.namedWindow("taichi-nerfs-torch")
        cv2.setMouseCallback("taichi-nerfs-torch", on_mouse)
        frames = 0
        while max_frames is None or frames < max_frames:
            frame = self.render_frame()
            label = (
                f"{1.0 / max(self.dt, 1e-9):5.1f} fps  "
                f"samples/ray {self.mean_samples:.2f}"
            )
            disp = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)
            cv2.putText(
                disp, label, (8, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                (255, 255, 255), 1,
            )
            cv2.imshow("taichi-nerfs-torch", disp)
            if not self._handle_key(cv2.waitKey(1) & 0xFF):
                break
            frames += 1
        cv2.destroyAllWindows()
