"""Serving a trained pyramid: one rendered frame per camera pose.

``PyramidRenderer`` is the counterpart of the JAX package's
``SwrTrainer.render`` (its ``train/swr_step.py``) as
``train.py``'s eval loop and ``scripts/eval_fps.py`` call it: it bakes the
pyramid once, caches the grid, and renders each pose through
:func:`taichi_nerfs_torch.render.swr.render_swr`, or a camera inside the
grid through :func:`~taichi_nerfs_torch.render.swr.render_swr_inside`.  A
model trained with ``cam_carve`` is served from a grid carved around the
same training poses (``carve_poses``), so it renders the frame the
trainer's ``render`` gives.

Precision: every fp32 matmul of the path (bake, sweep plain version, fold,
pixel warp) runs in full fp32 on CUDA because
``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default; the
renderer refuses to run with it switched on.  The rgb MLP rounds its
operands to bf16 and accumulates in fp32, as the JAX package does.  A
renderer may bake in bf16 (``bake_dtype``, as ``scripts/eval_fps.py``
serves every grid) and round the resample operands to bf16
(``resample_dtype``); both default to fp32.

Run as a module to render an orbit of a checkpoint written by the JAX
package's ``train.py`` (``results/model_pyramid.npz``)::

    python -m taichi_nerfs_torch.render.serve \\
        --ckpt_path results/model_pyramid.npz --img_wh 800 800 \\
        --n_views 4 --resample_kind cubic [--bake_dtype bfloat16]
        [--resample_dtype bfloat16]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..models import pyramid as pyr
from ..utils import profiling
from ..utils.device import require_fp32_matmul, resolve_device
from .swr import _RS_DTYPES, _host_f32, render_swr, render_swr_inside


class PyramidRenderer:
    """Render frames of one pyramid model on one device.

    Args:
        params: the port's pyramid params (``utils/convert.py``).
        cfg: its ``PyramidConfig`` (deferred or per-sample shading, split
            ``sigma_res`` or not).
        K, img_wh: default intrinsics and image size.
        resample_kind: "linear" or "cubic"; must match the checkpoint's
            training kind (the record model trains cubic).
        sweep_impl: "auto" (the CUDA kernel on the card) or "reference"
            (the plain PyTorch sweep).
        cam_carve: the training's ``SwrTrainConfig.cam_carve``: with > 0
            the baked sigma is zeroed within that radius of each of
            ``carve_poses`` (``train/swr_step.py:camera_keep_mask``).
        carve_poses: (N, 3, 4) the training poses (needed with
            ``cam_carve``).
        near: the training's ``SwrTrainConfig.near`` (inside cameras).
        bake_dtype: "float32" or "bfloat16", the baked grid's dtype.
        resample_dtype: "float32" or "bfloat16", the resample operands'.
    """

    def __init__(
        self,
        params,
        cfg: pyr.PyramidConfig,
        K=None,
        img_wh: Tuple[int, int] | None = None,
        *,
        resample_kind: str = "linear",
        sweep_impl: str = "auto",
        cam_carve: float = 0.0,
        carve_poses=None,
        near: float = 0.0,
        bake_dtype: str = "float32",
        resample_dtype: str = "float32",
    ):
        if cam_carve > 0 and carve_poses is None:
            raise ValueError("cam_carve needs the training poses "
                             "(carve_poses)")
        for name, v in (("bake_dtype", bake_dtype),
                        ("resample_dtype", resample_dtype)):
            if v not in _RS_DTYPES:
                raise ValueError(f"unknown {name} {v!r}")
        exp = [(r, r, r, cfg.feat_of(i)) for i, r in enumerate(cfg.resolutions)]
        got = [tuple(g.shape) for g in params["levels"]]
        if cfg.split:
            exp.append((cfg.sigma_res,) * 3)
            got.append(tuple(params["sigma_level"].shape)
                       if "sigma_level" in params else None)
        if exp != got:
            raise ValueError(f"level shapes {got} != config {exp}")
        self.params = params
        self.cfg = cfg
        self.K = K
        self.img_wh = img_wh
        self.resample_kind = resample_kind
        self.sweep_impl = sweep_impl
        self.bake_dtype = bake_dtype
        self.resample_dtype = resample_dtype
        self.cam_carve = cam_carve
        self.carve_poses = carve_poses
        self.near = near
        self._grid = None

    @property
    def grid(self):
        """The baked (R, R, R, F) grid, or for a split config the pair
        ``(sigma, feats)``, baked (and carved) on first use."""
        if self._grid is None:
            from ..train.swr_step import apply_sigma_keep, camera_keep_mask

            require_fp32_matmul()
            cfg = self.cfg
            with torch.no_grad():
                grid = pyr.bake(self.params, cfg, _RS_DTYPES[self.bake_dtype])
                if self.cam_carve > 0:
                    res = cfg.sigma_res if cfg.split else cfg.grid_res
                    keep = camera_keep_mask(self.carve_poses, res,
                                            self.cam_carve, cfg.scale)
                    dev = grid[0].device if cfg.split else grid.device
                    grid = apply_sigma_keep(grid, torch.as_tensor(
                        keep, device=dev))
                self._grid = grid
        return self._grid

    def render(
        self,
        pose,
        K=None,
        img_wh: Tuple[int, int] | None = None,
        lat_cap="auto",
        early_exit: float = 1e-4,
        skip_empty: bool = True,
    ) -> Dict[str, torch.Tensor]:
        """Render one (3, 4) camera-to-world pose.

        ``lat_cap="auto"`` caps the intermediate lattice at
        ``int(1.25 * R) + 16`` (the interactive setting); ``None`` renders
        uncapped (the quality-eval setting).  ``early_exit`` stops the
        sweep once every pixel's transmittance is below it (0 sweeps all
        chunks; a camera inside the grid renders its faces without it).
        ``skip_empty`` skips the slab scan's empty slabs; the kernel path
        composites every slab, as the JAX package's does.
        """
        from ..train.swr_step import is_inside

        require_fp32_matmul()
        cfg = self.cfg
        if lat_cap == "auto":
            lat_cap = int(1.25 * cfg.grid_res) + 16
        pose_np = _host_f32(pose).reshape(3, 4)
        inside = is_inside(pose_np, cfg.scale)
        kw = {} if inside else {"early_exit": float(early_exit)}
        K = self.K if K is None else K
        img_wh = img_wh or self.img_wh
        if K is None or img_wh is None:
            raise ValueError("K and img_wh are needed (no defaults given)")
        with torch.no_grad(), profiling.span("swr.frame"):
            return (render_swr_inside if inside else render_swr)(
                self.params,
                self.grid,
                cfg,
                pose_np,
                K,
                tuple(img_wh),
                lat_cap=lat_cap,
                n_chunks=min(16, cfg.grid_res),
                white_bg=True,
                skip_empty=skip_empty,
                near=self.near,
                resample_kind=self.resample_kind,
                resample_dtype=self.resample_dtype,
                sweep_impl=self.sweep_impl,
                **kw,
            )


def record_config() -> pyr.PyramidConfig:
    """The record model's configuration
    (``docs/records/lego_proxy_cli.manifest.json``)."""
    return pyr.PyramidConfig(
        resolutions=(32, 64, 128, 256),
        features=8,
        level_features=(8, 8, 8, 8),
        rgb_width=64,
        rgb_depth=2,
        scale=0.5,
        sigma_bias=-2.0,
        deferred=True,
    )


def config_for_params(params, base: pyr.PyramidConfig) -> pyr.PyramidConfig:
    """``base`` with the resolutions and channel widths of ``params``'s
    levels (as ``scripts/eval_fps.py`` derives them from a checkpoint), and
    the ``sigma_res`` of its ``sigma_level`` (0 without one)."""
    import dataclasses

    res = tuple(int(g.shape[0]) for g in params["levels"])
    lf = tuple(int(g.shape[-1]) for g in params["levels"])
    sigma = params.get("sigma_level")
    return dataclasses.replace(
        base, resolutions=res, features=lf[0], level_features=lf,
        sigma_res=0 if sigma is None else int(sigma.shape[0]),
    )


def main(argv=None):
    from ..data.cameras import intrinsics, orbit_poses
    from ..utils.convert import load_pyramid_npz
    from ..utils.viz import depth2img, write_png

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt_path", required=True,
                    help="model_pyramid.npz written by train.py")
    ap.add_argument("--img_wh", type=int, nargs=2, default=(800, 800))
    ap.add_argument("--n_views", type=int, default=4)
    ap.add_argument("--resample_kind", default="linear",
                    choices=("linear", "cubic"))
    ap.add_argument("--bake_dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the baked grid's dtype")
    ap.add_argument("--resample_dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the resample operands' dtype (fp32 accumulation)")
    ap.add_argument("--lat_cap", default="auto",
                    help="'auto' (int(1.25 R) + 16), 'none' or an integer")
    ap.add_argument("--out_dir", default="results/serve")
    ap.add_argument("--profile", action="store_true",
                    help="render the orbit once more under torch.profiler: "
                         "print the op/kernel table and the device busy "
                         "share, write trace.json to --out_dir")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "--device cpu")
    params = load_pyramid_npz(args.ckpt_path, device)
    cfg = config_for_params(params, record_config())
    w, h = args.img_wh
    lat_cap = {"auto": "auto", "none": None}.get(args.lat_cap.lower())
    if lat_cap is None and args.lat_cap.lower() != "none":
        lat_cap = int(args.lat_cap)
    rend = PyramidRenderer(
        params, cfg, intrinsics(w, h), (w, h),
        resample_kind=args.resample_kind, bake_dtype=args.bake_dtype,
        resample_dtype=args.resample_dtype,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    print(f"device={device} R={cfg.grid_res} F={cfg.features} {w}x{h} "
          f"lat_cap={args.lat_cap} kind={args.resample_kind} "
          f"bake={args.bake_dtype} resample={args.resample_dtype}",
          flush=True)
    rend.grid  # bake (and move to the device) outside the frame timings
    poses = orbit_poses(args.n_views)
    for i, pose in enumerate(poses):
        t0 = time.perf_counter()
        out = rend.render(pose, lat_cap=lat_cap)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"frame {i}: {ms:.2f} ms", flush=True)
        if i == 0:
            rgb = out["rgb"].reshape(h, w, 3).clamp(0, 1).cpu().numpy()
            write_png(os.path.join(args.out_dir, "rgb_000.png"),
                      (rgb * 255).astype(np.uint8))
            write_png(os.path.join(args.out_dir, "depth_000.png"),
                      depth2img(out["depth"].reshape(h, w).cpu().numpy()))

    if args.profile:
        _profile(rend, poses, lat_cap, device, args.out_dir)


def _profile(rend, poses, lat_cap, device, out_dir):
    """One pass over ``poses`` under torch.profiler: the op table sorted by
    self device time (self CPU time on the CPU), the device-busy share of
    the pass's wall time, and a Chrome trace in ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for pose in poses:
            rend.render(pose, lat_cap=lat_cap)
        if cuda:
            torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    profiling.report_profile(prof, wall_us, f"{len(poses)} frames", cuda,
                             out_dir)


if __name__ == "__main__":
    main()
