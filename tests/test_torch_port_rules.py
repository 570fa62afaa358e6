"""Rules of the PyTorch port: no JAX, and no silent out-of-scope paths."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_helpers import numpy_pyramid_params

from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.render import swr as tswr
from taichi_nerfs_torch.render.serve import PyramidRenderer
from taichi_nerfs_torch.utils.convert import pyramid_params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "taichi_nerfs_torch")
FORBIDDEN = ("jax", "optax", "taichi_nerfs_tpu")


def _package_files():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)


def _modules():
    for path in _package_files():
        if path.endswith(".py"):
            rel = os.path.relpath(path, REPO)[: -len(".py")]
            mod = rel.replace(os.sep, ".")
            yield mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


def test_package_imports_without_jax():
    """Every module of the port imports with jax, optax and the JAX
    package made unimportable."""
    code = (
        "import importlib, sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
        + f"for m in {sorted(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "import taichi_nerfs_torch.render.serve\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_file_of_the_package_names_jax():
    offenders = []
    for path in _package_files():
        with open(path, encoding="utf-8") as f:
            for n, line in enumerate(f, 1):
                if (
                    "import jax" in line
                    or "from jax" in line
                    or "optax" in line
                    or "taichi_nerfs_tpu" in line
                ):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{n}")
    assert not offenders, offenders


@pytest.fixture(scope="module")
def tiny():
    kw = dict(resolutions=(8, 16), features=4, rgb_width=16, deferred=True)
    cfg = tpyr.PyramidConfig(**kw)
    params = pyramid_params_from_numpy(
        numpy_pyramid_params((8, 16), (4, 4), 16, 2, seed=0)
    )
    grid = tpyr.bake(params, cfg)
    K = np.array([[14.4, 0, 8], [0, 14.4, 8], [0, 0, 1]], np.float32)
    from taichi_nerfs_torch.data.cameras import look_at

    pose = look_at(np.array([0.3, 0.2, -1.3]), np.zeros(3),
                   np.array([0.0, 0.0, 1.0]))
    return cfg, params, grid, pose, K


@pytest.mark.parametrize(
    "kw",
    [
        dict(inside=True),
        dict(debug_frames=True),
        dict(slab_window=8),
        dict(want_distortion=True),
        dict(resample_dtype="bfloat16"),
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_out_of_scope_render_options_raise(tiny, kw):
    cfg, params, grid, pose, K = tiny
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tswr.render_swr(params, grid, cfg, pose, K, (16, 16), n_chunks=4,
                        **kw)


def test_non_deferred_and_split_raise(tiny):
    import dataclasses

    cfg, params, grid, pose, K = tiny
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tswr.render_swr(params, grid, dataclasses.replace(cfg, deferred=False),
                        pose, K, (16, 16), n_chunks=4)
    split = tpyr.PyramidConfig(resolutions=(8, 16), features=4,
                               sigma_res=32, deferred=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpyr.bake(params, split)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tswr.render_swr(params, (grid[..., 0], grid[..., 1:]), split, pose,
                        K, (16, 16), n_chunks=4)


def test_renderer_raises_for_inside_camera_and_cam_carve(tiny):
    cfg, params, _, pose, K = tiny
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PyramidRenderer(params, cfg, K, (16, 16), cam_carve=0.5)
    rend = PyramidRenderer(params, cfg, K, (16, 16))
    inside = pose.copy()
    inside[:, 3] = [0.05, 0.0, -0.2]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rend.render(inside)
    out = rend.render(pose)  # an outside camera renders
    assert bool(torch.isfinite(out["rgb"]).all())


def test_renderer_refuses_tf32(tiny, monkeypatch):
    cfg, params, _, pose, K = tiny
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="tf32"):
        PyramidRenderer(params, cfg, K, (16, 16)).render(pose)
