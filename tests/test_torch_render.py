"""Port parity: the serving slice as a whole.

The port's ``render_swr`` against the JAX package's ``render_swr`` with
``sweep_impl="pallas_interpret"`` (the kernel path the served frames take
on the TPU; on the CPU the JAX package's "auto" would take the XLA scan,
whose ``skip_empty`` skips near-empty slabs that the kernel composites), on
deferred-shading scenes in the style of ``tests/test_swr_pallas.py`` and
``tests/test_swr.py``, with numpy-made params handed to both packages.
Tolerance 2e-4, as the JAX package's own render parity tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_tree, np32, numpy_pyramid_params, t32

from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.render import swr as tswr
from taichi_nerfs_torch.render.serve import PyramidRenderer
from taichi_nerfs_torch.utils.convert import (
    load_pyramid_npz,
    pyramid_params_from_numpy,
)
from taichi_nerfs_tpu.data.synthetic import look_at
from taichi_nerfs_tpu.models import pyramid as jpyr
from taichi_nerfs_tpu.render import swr as jswr

TOL = 2e-4
KINDS = ["linear", "cubic"]
EYES = {
    "z": (0.3, 0.2, -1.3),  # z-dominant, near axis
    "oblique": (0.8, 0.5, -1.1),  # oblique, z-dominant
    "+x": (1.3, 0.3, 0.2),  # x-dominant on the + side: the sweep flips
}
CFG_KW = dict(resolutions=(16, 32), features=4, rgb_width=16, scale=0.5,
              sigma_bias=0.0, deferred=True)


def _scene(blob, seed=0, radius=0.25, sigma_bias=0.0):
    tree = numpy_pyramid_params((16, 32), (4, 4), 16, 2, seed=seed,
                                blob=blob, radius=radius)
    kw = dict(CFG_KW, sigma_bias=sigma_bias)
    jcfg = jpyr.PyramidConfig(**kw)
    tcfg = tpyr.PyramidConfig(**kw)
    jp = jax_tree(tree)
    grid = np.asarray(jpyr.bake(jp, jcfg))
    return tree, jcfg, tcfg, jp, grid


@pytest.fixture(scope="module")
def soft():
    """A soft density blob: rays see structure, partial opacity."""
    return _scene(blob=2.0)


@pytest.fixture(scope="module")
def opaque():
    """An opaque core in empty space (sigma ~ e^-12 elsewhere): the
    early-exit loop skips the empty front chunks and stops at the last
    occupied one."""
    return _scene(blob=500.0, seed=1, radius=0.1, sigma_bias=-12.0)


def _K(w, h):
    return np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]],
                    np.float32)


def _pose(eye):
    return look_at(np.array(eye), np.zeros(3), np.array([0.0, 0.0, 1.0]))


def _compare(scene, eye, wh=(24, 24), **kw):
    tree, jcfg, tcfg, jp, grid = scene
    pose, K = _pose(eye), _K(*wh)
    want = jswr.render_swr(jp, jnp.asarray(grid), jcfg, pose, K, wh,
                           n_chunks=8, sweep_impl="pallas_interpret", **kw)
    got = tswr.render_swr(pyramid_params_from_numpy(tree), t32(grid), tcfg,
                          pose, K, wh, n_chunks=8, **kw)
    for k in ("rgb", "depth", "opacity"):
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(np32(got[k]), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    return got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eye", list(EYES), ids=list(EYES))
def test_render_matches_jax(soft, eye, kind):
    got = _compare(soft, EYES[eye], resample_kind=kind)
    assert float(got["opacity"].max()) > 0.5


@pytest.mark.parametrize("warp", ["matmul", "matmul_x", "gather"])
def test_render_warps_match_jax(soft, warp):
    _compare(soft, EYES["oblique"], warp=warp, resample_kind="cubic")


@pytest.mark.parametrize("kind", KINDS)
def test_render_lat_cap_matches_jax(soft, kind):
    # lattice capped at 28 < 24 + 16: the final warp magnifies
    _compare(soft, EYES["+x"], lat_cap=28, resample_kind=kind)


@pytest.mark.parametrize("kind", KINDS)
def test_render_early_exit_matches_jax(opaque, kind, monkeypatch):
    calls = []
    real = tswr.chunk_sweep
    monkeypatch.setattr(
        tswr, "chunk_sweep",
        lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k),
    )
    got = _compare(opaque, (0.3, 0.8, -1.2), wh=(48, 48), early_exit=1e-4,
                   resample_kind=kind)
    assert float(got["opacity"].max()) > 0.9
    # one chunk per sweep call; the empty chunks in front of and behind
    # the core are never swept
    assert calls and set(calls) == {1} and len(calls) < 8


def test_render_early_exit_matches_full_sweep(opaque):
    tree, _, tcfg, _, grid = opaque
    args = (pyramid_params_from_numpy(tree), t32(grid), tcfg,
            _pose((0.3, 0.8, -1.2)), _K(48, 48), (48, 48))
    full = tswr.render_swr(*args, n_chunks=8)
    fast = tswr.render_swr(*args, n_chunks=8, early_exit=1e-4)
    for k in ("rgb", "opacity"):
        np.testing.assert_allclose(np32(fast[k]), np32(full[k]), atol=TOL)


def test_reference_sweep_impl_matches_auto(soft):
    tree, _, tcfg, _, grid = soft
    args = (pyramid_params_from_numpy(tree), t32(grid), tcfg,
            _pose(EYES["oblique"]), _K(24, 24), (24, 24))
    a = tswr.render_swr(*args, n_chunks=8)
    b = tswr.render_swr(*args, n_chunks=8, sweep_impl="reference")
    assert torch.equal(a["rgb"], b["rgb"])


@pytest.mark.parametrize("eye", list(EYES) + ["rolled"])
def test_host_helpers_match_jax(eye):
    if eye == "rolled":
        pose = _pose((0.2, 0.1, -1.3))
        c, s = np.cos(0.8), np.sin(0.8)
        roll = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        pose = np.concatenate([pose[:, :3] @ roll, pose[:, 3:]], axis=1)
    else:
        pose = _pose(EYES[eye])
    K, wh = _K(40, 30), (40, 30)
    axis = int(np.argmax(np.abs(pose[:, 2])))
    assert tswr.sweep_axis(pose) == (axis, bool(pose[axis, 3] > 0))
    assert tswr.pick_warp(pose, K, wh, axis) == jswr.pick_warp(
        pose, K, wh, axis
    )
    for sign in (1.0, -1.0):
        assert tswr.pick_warp(pose, K, wh, axis, face_sign=sign) == (
            jswr.pick_warp(pose, K, wh, axis, face_sign=sign)
        )
    for lo, hi in ((-0.5, 0.5), (-3.0, 3.0), (0.2, 0.3)):
        assert tswr._matmul_solve_choice(pose, axis, lo, hi) == (
            jswr._matmul_solve_choice(pose, axis, lo, hi)
        )
    for a, b in zip(tswr._pixel_slopes(pose, K, wh, axis),
                    jswr._pixel_slopes(pose, K, wh, axis)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lat_cap", ["auto", None], ids=["capped", "uncapped"])
@pytest.mark.parametrize("kind", KINDS)
def test_pyramid_renderer_on_npz_matches_jax(tmp_path, lat_cap, kind):
    """``PyramidRenderer`` on a ``model_pyramid.npz`` written in train.py's
    format, against the JAX ``render_swr`` with ``SwrTrainer.render``'s
    keyword arguments."""
    cfg_kw = dict(resolutions=(8, 16, 32), features=4, rgb_width=16,
                  scale=0.5, sigma_bias=-1.0, deferred=True)
    tree = numpy_pyramid_params((8, 16, 32), (4, 4, 4), 16, 2, seed=3,
                                blob=4.0)
    path = tmp_path / "model_pyramid.npz"
    np.savez(
        path,
        **{f"level_{i}": g for i, g in enumerate(tree["levels"])},
        **{f"rgb_mlp_{k}": v for k, v in tree["rgb_mlp"].items()},
    )
    jcfg = jpyr.PyramidConfig(**cfg_kw)
    tcfg = tpyr.PyramidConfig(**cfg_kw)
    w = h = 40
    K = _K(w, h)
    pose = _pose((1.0, -0.7, 0.5))
    R = jcfg.grid_res
    jp = jax_tree(tree)
    want = jswr.render_swr(
        jp, jpyr.bake_jit(jp, jcfg, dtype=jnp.float32), jcfg, pose, K,
        (w, h), n_chunks=min(16, R), white_bg=True,
        lat_cap=int(1.25 * R) + 16 if lat_cap == "auto" else None,
        skip_empty=True, near=0.0, early_exit=1e-4, resample_kind=kind,
        sweep_impl="pallas_interpret",
    )
    rend = PyramidRenderer(load_pyramid_npz(str(path)), tcfg, K, (w, h),
                           resample_kind=kind)
    got = rend.render(pose, lat_cap=lat_cap)
    assert rend.render(pose, lat_cap=lat_cap)["rgb"].data_ptr() != (
        got["rgb"].data_ptr()
    )
    assert rend.grid is rend.grid  # baked once, cached
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_allclose(np32(got[k]), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
