"""Port parity: cameras inside the scene cube, and ``debug_frames``.

The same numpy inputs go through the JAX package (``sweep_impl="xla"``, the
scan that inside cameras take in both packages) and the port:

* the host helpers ``pixel_faces`` and ``face_slope_bounds``, with pixels
  on a face diagonal (ties go to the first axis in both);
* ``render_swr_fixed_axis(inside=True)`` for one face of the one-face and
  oblique poses of ``tests/test_swr.py``'s inside tests, with the face's
  tight bounds and with none (a crop across a face boundary: the whole
  cone), with ``near`` and without;
* ``render_swr_inside`` (every face, merged per pixel) on a deferred grid
  and on a split per-sample one, an outside camera through it, and a
  chunk wholly behind the camera, with its gradients;
* ``debug_frames`` on an outside and an inside face.

Frames are held to 2e-4 (the scan's tolerance), gradients to 2e-4 relative
norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_tree, np32, numpy_pyramid_params

from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.render import swr as tswr
from taichi_nerfs_torch.train.state import trainable, tree_leaves
from taichi_nerfs_torch.utils.convert import pyramid_params_from_numpy
from taichi_nerfs_tpu.data.synthetic import look_at
from taichi_nerfs_tpu.models import pyramid as jpyr
from taichi_nerfs_tpu.render import swr as jswr

TOL = 2e-4
GRAD_TOL = 2e-4
RES, FEAT = (16, 32), 4
# the inside poses of tests/test_swr.py's test_swr_inside_matches_oracle
ONE_FACE = ((0.1, 0.05, -0.2), (0.0, 0.0, 0.3))
OBLIQUE = ((0.3, 0.25, 0.2), (-0.4, -0.4, -0.3))
CENTRE = ((0.0, 0.0, 0.0), (1.0, 0.4, 0.45))


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _pose(eye, target):
    return look_at(np.asarray(eye, np.float64),
                   np.asarray(target, np.float64), np.array([0.0, 0.0, 1.0]))


def _K(w, f):
    return np.array([[f * w, 0, w / 2], [0, f * w, w / 2], [0, 0, 1]],
                    np.float32)


def _model(deferred=True, sigma_res=0, seed=0):
    """Both packages' config, params and baked grid: a density shell of
    radius 0.35 (around inside cameras) on random levels."""
    kw = dict(resolutions=RES, features=FEAT, rgb_width=16, scale=0.5,
              sigma_bias=0.0, deferred=deferred, sigma_res=sigma_res)
    jc, tc = jpyr.PyramidConfig(**kw), tpyr.PyramidConfig(**kw)
    tree = numpy_pyramid_params(RES, (FEAT,) * len(RES), 16, 2, seed=seed)
    R = RES[-1]
    c = (np.arange(R) + 0.5) / R - 0.5
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt(xx**2 + yy**2 + zz**2)
    tree["levels"][-1][..., 0] += (3.0 * np.exp(-((r - 0.35) / 0.08) ** 2)
                                   ).astype(np.float32)
    jp = jax_tree(tree)
    if sigma_res:
        rng = np.random.default_rng(seed + 100)
        s = (np.arange(sigma_res) + 0.5) / sigma_res - 0.5
        sx, sy, sz = np.meshgrid(s, s, s, indexing="ij")
        rs = np.sqrt(sx**2 + sy**2 + sz**2)
        tree["sigma_level"] = (
            1e-2 * rng.normal(size=(sigma_res,) * 3)
            + 3.0 * np.exp(-((rs - 0.35) / 0.08) ** 2)).astype(np.float32)
        jp["sigma_level"] = jnp.asarray(tree["sigma_level"])
    tp = pyramid_params_from_numpy(tree)
    return jc, tc, jp, tp, jpyr.bake(jp, jc), tpyr.bake(tp, tc)


@pytest.fixture(scope="module")
def model():
    return _model()


def _assert_frames(a, b, tol=TOL):
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_allclose(np32(b[k]), np.asarray(a[k]), rtol=tol,
                                   atol=tol, err_msg=k)


# ------------------------------------------------------------ host helpers


@pytest.mark.parametrize("view", [ONE_FACE, OBLIQUE, CENTRE],
                         ids=["one_face", "oblique", "centre"])
def test_pixel_faces_and_slope_bounds_match_jax(view):
    w = 32
    K = _K(w, 0.7)
    pose = _pose(*view)
    want = jswr.pixel_faces(pose, K, (w, w))
    got = tswr.pixel_faces(pose, K, (w, w))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, p in want[2]:
        for crop_xy, c in (((0, 0), w), ((5, 9), 16)):
            jb = jswr.face_slope_bounds(pose, K, (c, c), a,
                                        1.0 if p else -1.0, crop_xy=crop_xy)
            tb = tswr.face_slope_bounds(pose, K, (c, c), a,
                                        1.0 if p else -1.0, crop_xy=crop_xy)
            assert (jb is None) == (tb is None)
            if jb is not None:
                np.testing.assert_array_equal(tb, jb)


def test_pixel_faces_break_ties_to_the_first_axis():
    """An axis-aligned camera with 45-degree corner rays: the rays of the
    image's diagonals have equal components, which both packages give to
    the first axis; a face absent from a crop gives None."""
    w = 9
    K = np.array([[4.0, 0, 4.5], [0, 4.0, 4.5], [0, 0, 1]], np.float32)
    pose = np.array([[1, 0, 0, 0.0], [0, 1, 0, 0.0], [0, 0, 1, 0.0]],
                    np.float32)
    want = jswr.pixel_faces(pose, K, (w, w))
    got = tswr.pixel_faces(pose, K, (w, w))
    dirs = got[3]
    tie = np.abs(np.abs(dirs[..., 0]) - np.abs(dirs[..., 2])) == 0
    assert tie.any()  # the corner pixels sit on the x / z diagonal
    assert (got[0][tie] == 0).all()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for f in (-1.0, 1.0):
        assert tswr.face_slope_bounds(pose, K, (3, 3), 1, f,
                                      crop_xy=(3, 3)) is None
        assert jswr.face_slope_bounds(pose, K, (3, 3), 1, f,
                                      crop_xy=(3, 3)) is None


# ---------------------------------------------------------- one face


@pytest.mark.parametrize("view,bounds,near", [
    (ONE_FACE, True, 0.0),
    (ONE_FACE, False, 0.1),
    (OBLIQUE, True, 0.05),
    (OBLIQUE, False, 0.0),  # a crop across a face boundary: the cone
], ids=["one_face-bounds", "one_face-near", "oblique-bounds-near",
        "oblique-cone"])
def test_inside_face_matches_jax(model, view, bounds, near):
    jc, tc, jp, tp, jg, tg = model
    w = 24
    K = _K(w, 0.7)
    pose = _pose(*view)
    dom, pos, faces, _ = jswr.pixel_faces(pose, K, (w, w))
    a, p = max(faces, key=lambda f: ((dom == f[0]) & (pos == f[1])).sum())
    sb = (jswr.face_slope_bounds(pose, K, (w, w), a, 1.0 if p else -1.0)
          if bounds else None)
    kw = dict(n_chunks=4, near=near, warp="gather")
    want = jswr.render_swr_fixed_axis(
        jp, jg, jc, jnp.asarray(pose), jnp.asarray(K), (w, w), a, not p,
        inside=True, sweep_impl="xla",
        slope_bounds=None if sb is None else jnp.asarray(sb), **kw)
    got = tswr.render_swr_fixed_axis(tp, tg, tc, pose, K, (w, w), a, not p,
                                     inside=True, slope_bounds=sb, **kw)
    assert float(np.asarray(want["opacity"]).max()) > 0.3
    _assert_frames(want, got)


# ---------------------------------------------------------- whole image


@pytest.mark.parametrize("view", [ONE_FACE, OBLIQUE, CENTRE],
                         ids=["one_face", "oblique", "centre"])
@pytest.mark.parametrize("variant", ["deferred", "split_per_sample"])
def test_render_swr_inside_matches_jax(view, variant):
    jc, tc, jp, tp, jg, tg = (_model() if variant == "deferred" else
                              _model(deferred=False, sigma_res=64))
    w = 24
    K = _K(w, 0.7)
    pose = _pose(*view)
    kw = dict(n_chunks=4, near=0.05, resample_kind="cubic")
    want = jswr.render_swr_inside(jp, jg, jc, pose, K, (w, w),
                                  sweep_impl="xla", **kw)
    got = tswr.render_swr_inside(tp, tg, tc, pose, K, (w, w), **kw)
    _assert_frames(want, got)
    assert len(jswr.pixel_faces(pose, K, (w, w))[2]) > 1  # a merge


def test_render_swr_inside_lattice_cap_matches_jax(model):
    jc, tc, jp, tp, jg, tg = model
    w = 40
    K = _K(w, 0.7)
    pose = _pose(*OBLIQUE)
    want = jswr.render_swr_inside(jp, jg, jc, pose, K, (w, w), lat_cap=36,
                                  n_chunks=4, sweep_impl="xla",
                                  dist_min=0.5)
    got = tswr.render_swr_inside(tp, tg, tc, pose, K, (w, w), lat_cap=36,
                                 n_chunks=4, dist_min=0.5)
    _assert_frames(want, got)


def test_outside_camera_through_the_inside_path(model):
    """As tests/test_swr.py: an outside camera rendered face by face agrees
    with the outside sweep, and the port's face path with the JAX one."""
    jc, tc, jp, tp, jg, tg = model
    w = 24
    K = _K(w, 0.9)
    pose = _pose((0.1, 0.2, -1.3), (0.0, 0.0, 0.0))
    got = tswr.render_swr_inside(tp, tg, tc, pose, K, (w, w), n_chunks=4)
    want = jswr.render_swr_inside(jp, jg, jc, pose, K, (w, w), n_chunks=4,
                                  sweep_impl="xla")
    _assert_frames(want, got)
    out = tswr.render_swr(tp, tg, tc, pose, K, (w, w), n_chunks=4)
    mse = float(torch.mean((out["rgb"] - got["rgb"]) ** 2))
    assert -10 * np.log10(mse + 1e-12) > 30.0


def test_chunk_behind_the_camera_has_finite_gradients(model):
    """A camera near the +z wall looking up: every slab of the lower
    chunks is behind it, so those chunks park their plane on the wall and
    composite nothing; the frame and the level gradients are finite and
    match JAX's."""
    jc, tc, jp, tp, jg, tg = model
    w = 16
    K = _K(w, 0.6)
    pose = _pose((0.02, -0.03, 0.3), (0.1, 0.0, 1.0))
    axis, flip, n_chunks = 2, False, 4
    h = 1.0 / RES[-1]
    zs = -0.5 + (np.arange(RES[-1]) + 0.5) * h
    behind = (zs.reshape(n_chunks, -1) - 0.3 <= 0.5 * h).all(axis=1)
    assert behind.sum() >= 2  # whole chunks behind the camera
    kw = dict(n_chunks=n_chunks, warp="gather")
    cot = np.random.default_rng(1).normal(size=(w * w, 3)).astype(np.float32)

    def jloss(params):
        grid = jpyr.bake(params, jc)
        out = jswr.render_swr_fixed_axis(
            params, grid, jc, jnp.asarray(pose), jnp.asarray(K), (w, w),
            axis, flip, inside=True, sweep_impl="xla", **kw)
        return jnp.sum(out["rgb"] * cot), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jp)
    params = trainable(tp)
    out = tswr.render_swr_fixed_axis(params, tpyr.bake(params, tc), tc, pose,
                                     K, (w, w), axis, flip, inside=True,
                                     **kw)
    grads = torch.autograd.grad(torch.sum(out["rgb"] * torch.as_tensor(cot)),
                                tree_leaves(params))
    _assert_frames(want, out)
    for g, jgr in zip(grads, jax.tree_util.tree_leaves(jgrad)):
        assert bool(torch.isfinite(g).all())
        assert _rel_norm(np32(g), jgr) <= GRAD_TOL


# ---------------------------------------------------------- debug frames


@pytest.mark.parametrize("inside", [False, True], ids=["outside", "inside"])
def test_debug_frames_match_jax(model, inside):
    jc, tc, jp, tp, jg, tg = model
    w = 20
    if inside:
        pose, K, axis, flip = _pose(*ONE_FACE), _K(w, 0.7), 2, False
    else:
        pose, K = _pose((0.3, 0.2, -1.3), (0.0, 0.0, 0.0)), _K(w, 0.9)
        axis, flip = tswr.sweep_axis(pose)
    kw = dict(n_chunks=4, debug_frames=True, inside=inside,
              want_distortion=True)
    want = jswr.render_swr_fixed_axis(
        jp, jg, jc, jnp.asarray(pose), jnp.asarray(K), (w, w), axis, flip,
        sweep_impl="xla", **kw)
    got = tswr.render_swr_fixed_axis(tp, tg, tc, pose, K, (w, w), axis,
                                     flip, **kw)
    _assert_frames(want, got)
    np.testing.assert_allclose(np32(got["global_frame"]),
                               np.asarray(want["global_frame"]), rtol=TOL,
                               atol=TOL)
    assert len(got["chunk_debug"]) == 3
    for a, b in zip(got["chunk_debug"], want["chunk_debug"]):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_allclose(np32(a), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def test_debug_frames_refuse_early_exit(model):
    _, tc, _, tp, _, tg = model
    with pytest.raises(ValueError, match="early_exit"):
        tswr.render_swr(tp, tg, tc, _pose((0.3, 0.2, -1.3), (0, 0, 0)),
                        _K(16, 0.9), (16, 16), n_chunks=4,
                        debug_frames=True, early_exit=1e-4)
