"""Serialized compiled-artifact export: a program saved once and run later
without the Python that defined it.

Counterpart of the JAX package's ``utils/aot.py`` on ``torch.export``.  A
function is traced (non-strict ``torch.export.export``) into an
``ExportedProgram`` of ATen operators and the port's registered operators,
saved with ``torch.export.save``; a later process loads it with
``torch.export.load`` and runs the graph without re-tracing the defining
Python.  The sweep kernels are the operators ``taichi_nerfs_torch::
swr_sweep_fwd`` / ``::swr_sweep_bwd`` (``ops/swr_sweep.py``): a program
exported from CUDA inputs holds the forward sweep as one node, which
launches ``csrc/swr_sweep_fwd.cu`` when the loaded program runs; one
exported from CPU inputs holds the plain sweep inline, as the port's CPU
path runs it.

A program is exported for one device type: the constants a function makes
(``torch.arange(..., device=...)``) are baked with the device of its
example inputs.  Layout written by :func:`export_compiled`::

    <out_dir>/
      <name>.<platform>.pt2   # torch.export.save, one file a platform
      metadata.json           # ABI: arg/result shapes and dtypes, platforms

The native C++ runner (``native/``, fed by ``utils/export.py``) stays the
portable deployment path; this module is the compiled path for hosts that
run PyTorch.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..models import pyramid as pyr


class _Entry(torch.nn.Module):
    """``fn`` as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _aval_desc(t) -> dict:
    return {"shape": [int(n) for n in t.shape],
            "dtype": str(t.dtype).removeprefix("torch.")}


def _device_type(tree) -> str:
    types = {x.device.type for x in pytree.tree_leaves(tree)
             if isinstance(x, torch.Tensor)}
    if len(types) != 1:
        raise ValueError(f"example_args must lie on one device type, got "
                         f"{sorted(types) or 'no tensor'}")
    return types.pop()


def _user_outputs(ep) -> list:
    """The fake values of the program's user outputs, in order."""
    from torch.export.graph_signature import OutputKind

    names = [s.arg.name for s in ep.graph_signature.output_specs
             if s.kind == OutputKind.USER_OUTPUT]
    nodes = {n.name: n for n in ep.graph.nodes}
    return [nodes[n].meta["val"] for n in names]


def export_compiled(
    fn: Callable,
    example_args: Sequence,
    out_dir: str,
    name: str = "render",
    platforms: Sequence[str] | None = None,
    extra_meta: dict | None = None,
) -> str:
    """Export ``fn(*example_args)`` for each of ``platforms`` into
    ``out_dir``; returns the path of the first platform's file.

    ``example_args``: a list of pytrees (dicts, lists) of tensors fixing the
    ABI (shapes and dtypes are static).  ``platforms``: device types
    ("cuda", "cpu"); ``None`` means the device of ``example_args``.  Each
    platform is traced from ``example_args`` moved to it and saved to its
    own file ``<name>.<platform>.pt2``; the entry ``name`` of
    ``metadata.json`` names them (``files``, ``file`` the first one) with
    the platforms, the torch version, each platform's export seconds, the
    flattened inputs' and outputs' shapes and dtypes (``in_avals``,
    ``out_avals``) and ``extra_meta``.
    """
    os.makedirs(out_dir, exist_ok=True)
    args = [pytree.tree_map(
        lambda x: x.detach() if isinstance(x, torch.Tensor) else x, a)
        for a in example_args]
    platforms = list(platforms) if platforms else [_device_type(args)]
    files, secs, outs = {}, {}, None
    for plat in platforms:
        t0 = time.perf_counter()
        dev_args = pytree.tree_map(
            lambda x: x.to(plat) if isinstance(x, torch.Tensor) else x, args)
        with torch.no_grad():
            ep = torch.export.export(_Entry(fn), tuple(dev_args),
                                     strict=False)
        outs = outs or _user_outputs(ep)
        # the archive would also hold a copy of the example inputs (the
        # weights, for a render)
        ep.example_inputs = None
        files[plat] = f"{name}.{plat}.pt2"
        torch.export.save(ep, os.path.join(out_dir, files[plat]))
        secs[plat] = time.perf_counter() - t0

    meta_path = os.path.join(out_dir, "metadata.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    meta[name] = {
        "file": files[platforms[0]],
        "files": files,
        "platforms": platforms,
        "torch_version": torch.__version__,
        # wall seconds of each platform's trace and save
        "export_seconds": secs,
        "in_avals": [_aval_desc(x) for x in pytree.tree_leaves(args)
                     if isinstance(x, torch.Tensor)],
        "out_avals": [_aval_desc(x) for x in outs],
        **(extra_meta or {}),
    }
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    return os.path.join(out_dir, files[platforms[0]])


def load_compiled(out_dir: str, name: str = "render",
                  device=None) -> Callable:
    """Load an exported entry point; returns a callable running the saved
    program (no re-trace of the defining Python), on the arguments'
    structure at export.  ``device``: the device type whose file to load
    (``None``: the first platform exported)."""
    # the sweep operators must be registered before a program naming them
    # is deserialized
    from ..ops import swr_sweep  # noqa: F401

    with open(os.path.join(out_dir, "metadata.json")) as f:
        entry = json.load(f)[name]
    if device is None:
        fname = entry["file"]
    else:
        plat = torch.device(device).type
        if plat not in entry["files"]:
            raise ValueError(f"{name} was exported for {entry['platforms']},"
                             f" not {plat}")
        fname = entry["files"][plat]
    return torch.export.load(os.path.join(out_dir, fname)).module()


def _entry_name(axis: int, flip: int) -> str:
    return f"pyramid_render_a{axis}f{flip}"


def export_pyramid_compiled(
    params,
    pyramid_cfg: pyr.PyramidConfig,
    K,
    img_wh,
    out_dir: str,
    platforms: Sequence[str] | None = None,
    white_bg: bool = True,
    lat_cap: int | None = None,
) -> str:
    """Export the dense pyramid's serving path; returns ``out_dir``.

    The sweep axis and direction shape the whole slab schedule, so the
    artifact holds six entry points ``pyramid_render_a{axis}f{flip}``, one
    per (dominant axis, sweep direction), and :func:`load_pyramid_renderer`
    picks one by the pose, as the reference's C++ runner picks among its
    AOT kernels.  Intrinsics, image size, background and the render
    configuration are constants of the program; the baked grid
    ``(R, R, R, F)`` fp32, ``params["rgb_mlp"]`` and the (3, 4) pose are
    its inputs, so a checkpoint swaps without a new export.  The pixel warp
    is the gather form (pose-agnostic; the matmul warp's solve choice is
    made per pose on the host).  ``lat_cap`` (default ``int(1.25 R) +
    16``) caps the intermediate lattice.  ``params`` and ``platforms``'s
    default device: the device of ``params``.

    The artifact takes the sweep path: deferred shading and an unsplit
    grid.  Other configurations render through the slab scan, whose
    ``skip_empty`` reads the grid on the host, and raise ``ValueError``.
    """
    from ..render.swr import render_swr_fixed_axis

    cfg = pyramid_cfg
    if not cfg.deferred or cfg.split:
        raise ValueError("the compiled artifact serves deferred, unsplit "
                         "configurations (the sweep path)")
    if lat_cap is None:
        lat_cap = int(1.25 * cfg.grid_res) + 16
    K = np.asarray(K, np.float32)
    w, h = img_wh
    lat_pad = 16
    kw = {}
    if max(img_wh) + lat_pad > lat_cap:
        kw["lat_size"] = lat_cap

    with torch.no_grad():
        grid = pyr.bake(params, cfg)
    pose0 = torch.zeros((3, 4), dtype=torch.float32, device=grid.device)
    for axis in range(3):
        for flip in (False, True):

            def infer(g, rgb_mlp, pose, axis=axis, flip=flip):
                return render_swr_fixed_axis(
                    {"rgb_mlp": rgb_mlp}, g, cfg, pose, K, (w, h), axis,
                    flip, white_bg=white_bg, skip_empty=True, warp="gather",
                    **kw,
                )

            export_compiled(
                infer,
                [grid, params["rgb_mlp"], pose0],
                out_dir,
                name=_entry_name(axis, int(flip)),
                platforms=platforms,
                extra_meta={
                    "model": "pyramid",
                    "axis": axis,
                    "flip": bool(flip),
                    "grid_res": int(cfg.grid_res),
                    "scale": float(cfg.scale),
                    "img_wh": [int(w), int(h)],
                    "white_bg": bool(white_bg),
                    "lat_cap": int(lat_cap),
                },
            )
    return out_dir


def load_pyramid_renderer(out_dir: str, device=None) -> Callable:
    """Load all six entry points (``device``: as :func:`load_compiled`);
    returns ``render(grid, rgb_mlp, pose)``, which picks the entry point by
    the pose's dominant axis and side (a host argmax, as the reference
    runner selects its kernels per frame) and returns the render's dict.

    It refuses a pose inside the grid along its dominant axis
    (``ValueError``; the entry points are the outside sweep) and a process
    with TF32 matmuls on (``RuntimeError``: the fold is a matmul, and the
    switch is a runtime setting that the artifact does not carry).
    """
    from ..render.swr import _host_f32
    from .device import require_fp32_matmul

    fns = {(a, f): load_compiled(out_dir, _entry_name(a, f), device)
           for a in range(3) for f in (0, 1)}
    with open(os.path.join(out_dir, "metadata.json")) as f:
        meta = json.load(f)
    scale = float(meta[_entry_name(0, 0)]["scale"])

    def render(grid, rgb_mlp, pose):
        require_fp32_matmul()
        p = _host_f32(pose).reshape(3, 4)
        axis = int(np.argmax(np.abs(p[:, 2])))
        flip = int(p[axis, 3] > 0)
        # the entry points are the OUTSIDE sweep: the shadow-frame
        # intersection assumes the camera clears the expanded cube along
        # the sweep axis, and an inside pose would render a collapsed
        # frame with no error (inside poses render through
        # PyramidRenderer.render, a cubemap face at a time)
        if abs(float(p[axis, 3])) <= scale * 1.05:
            raise ValueError(
                f"pose is inside the grid along its dominant axis "
                f"(|o_a|={abs(float(p[axis, 3])):.3f} <= "
                f"{scale * 1.05:.3f}); the compiled artifact only serves "
                "outside cameras: render inside poses with "
                "PyramidRenderer.render (cubemap-face sweep)"
            )
        with torch.no_grad():
            return fns[(axis, flip)](
                grid, rgb_mlp, torch.as_tensor(p, device=grid.device))

    return render
