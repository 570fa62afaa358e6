"""Port parity: the shear-warp renderer's slab scan and what runs it.

The same numpy inputs go through the JAX package and the port:

* the windowed and per-batch resamples (``ops/warp.py``) on the cases of
  ``tests/test_warp.py``'s ``TestWindowedMatmul``, and the window helpers;
* ``slab_window_bound`` on host poses, including a narrow view where it is
  not 0;
* ``render_swr`` on the scan path (the JAX package's
  ``sweep_impl="xla"``): a split ``sigma_res`` grid, per-sample shading,
  the distortion loss and a windowed resample, each alone and all together,
  and early exit; tolerance 2e-4 as ``tests/test_torch_render.py``;
* ``make_swr_loss`` on the same paths and on linear training in the
  sweep's scope: loss within 1e-5 relative, level gradients within 2e-4
  relative norm, as ``tests/test_torch_swr_train.py``;
* the trainers' slab window per phase, a split ``model_pyramid.npz``
  through both packages, default-flag (linear) training and a CLI run of
  the scan's options.

Per-sample shading runs the rgb MLP with bf16-rounded operands on every
lattice point of every slab in both packages; at these sizes its outputs
and gradients stay within the tolerances above.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_tree, np32, numpy_pyramid_params, t32

from taichi_nerfs_torch.data import synthetic as tsyn
from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.ops import warp as twarp
from taichi_nerfs_torch.render import swr as tswr
from taichi_nerfs_torch.render.serve import PyramidRenderer, config_for_params
from taichi_nerfs_torch.train import swr_step as tst
from taichi_nerfs_torch.utils.convert import (
    load_pyramid_npz,
    pyramid_params_from_numpy,
    save_pyramid_npz,
)
from taichi_nerfs_tpu.data.synthetic import look_at
from taichi_nerfs_tpu.models import pyramid as jpyr
from taichi_nerfs_tpu.ops import warp as jwarp
from taichi_nerfs_tpu.render import swr as jswr
from taichi_nerfs_tpu.train import swr_step as jst

TOL = 2e-4
LOSS_TOL, GRAD_TOL = 1e-5, 2e-4
RES, FEAT = (8, 16), 4


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tree(seed=0, blob=2.0, radius=0.25, sigma_res=0, res=RES):
    tree = numpy_pyramid_params(res, (FEAT,) * len(res), 16, 2, seed=seed,
                                blob=blob, radius=radius)
    if sigma_res:
        rng = np.random.default_rng(seed + 100)
        tree["sigma_level"] = (
            1e-2 * rng.normal(size=(sigma_res,) * 3)).astype(np.float32)
    return tree


def _jax_params(tree):
    jp = jax_tree(tree)
    if "sigma_level" in tree:
        jp["sigma_level"] = jnp.asarray(tree["sigma_level"])
    return jp


def _cfgs(**kw):
    kw = dict(dict(resolutions=RES, features=FEAT, rgb_width=16, scale=0.5,
                   sigma_bias=0.0, deferred=True), **kw)
    return jpyr.PyramidConfig(**kw), tpyr.PyramidConfig(**kw)


def _pose(eye):
    return look_at(np.array(eye), np.zeros(3), np.array([0.0, 0.0, 1.0]))


def _K(w, h, f=0.9):
    return np.array([[f * w, 0, w / 2], [0, f * w, h / 2], [0, 0, 1]],
                    np.float32)


# ------------------------------------------------------------------ warp


@pytest.mark.parametrize(
    "n,out_len,start,step,window",
    [
        (256, 144, 40.2, 0.31, 64),   # training-crop regime
        (256, 144, -0.7, 0.18, 32),   # support crosses the low edge
        (256, 144, 230.5, 0.25, 64),  # support crosses the high edge
        (256, 144, -80.0, 0.2, 32),   # fully below the source
        (256, 144, 300.0, 0.2, 32),   # fully above the source
        (256, 144, 120.0, -0.3, 64),  # negative step
        (64, 144, 10.0, 0.3, 128),    # window >= n: the full matrix
    ],
)
def test_windowed_resample_matches_jax(n, out_len, start, step, window):
    x = np.random.default_rng(3).normal(size=(4, n, 8)).astype(np.float32)
    want = np.asarray(jwarp.resample_matmul_windowed(
        jnp.asarray(x), jnp.float32(start), jnp.float32(step), out_len, 1,
        window))
    got = twarp.resample_matmul_windowed(
        t32(x), torch.tensor(start), torch.tensor(step), out_len, 1, window)
    # the tolerance of tests/test_warp.py's windowed-vs-full comparison
    np.testing.assert_allclose(np32(got), want, rtol=2e-4, atol=5e-5)
    full = twarp.resample_matmul(t32(x), start, step, out_len, 1)
    np.testing.assert_allclose(np32(got), np32(full), rtol=2e-4, atol=5e-5)


def test_windowed_resample_grad_matches_full():
    rng = np.random.default_rng(4)
    x = t32(rng.normal(size=(3, 128, 5))).requires_grad_(True)
    cot = t32(rng.normal(size=(3, 96, 5)))
    grads = []
    for fn in (lambda v: twarp.resample_matmul_windowed(v, 20.3, 0.4, 96,
                                                        1, 64),
               lambda v: twarp.resample_matmul(v, 20.3, 0.4, 96, 1)):
        (g,) = torch.autograd.grad((fn(x) * cot).sum(), x)
        grads.append(np32(g))
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["linear", "cubic"])
@pytest.mark.parametrize("axis", [1, 2])
def test_batched_resample_matches_jax(kind, axis):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 10)).astype(np.float32)
    start = np.array([-1.3, 2.2], np.float32)
    step = np.array([0.7, 1.15], np.float32)
    want = np.asarray(jwarp.resample_matmul_batched(
        jnp.asarray(x), jnp.asarray(start), jnp.asarray(step), 9, axis,
        kind=kind))
    got = twarp.resample_matmul_batched(t32(x), t32(start), t32(step), 9,
                                        axis, kind=kind)
    np.testing.assert_allclose(np32(got), want, rtol=1e-5, atol=1e-6)
    # each batch entry is its own dense resample
    for b in range(2):
        one = twarp.resample_matmul(t32(x[b]), float(start[b]),
                                    float(step[b]), 9, axis - 1, kind=kind)
        np.testing.assert_allclose(np32(got[b]), np32(one), rtol=1e-6,
                                   atol=1e-6)


def test_window_helpers_match_jax():
    for step, out_len in ((0.3, 144), (0.0, 10), (1.7, 33), (0.05, 800)):
        assert twarp.resample_window(step, out_len) == (
            jwarp.resample_window(step, out_len))
        assert twarp.resample_window(step, out_len, 8) == (
            jwarp.resample_window(step, out_len, 8))
    for lo, hi, n in ((0.8, 1.2, 64), (1.0, 1.0, 7), (0.3, 2.5, 100)):
        assert twarp.residual_window(lo, hi, n) == (
            jwarp.residual_window(lo, hi, n))
        assert twarp.drift_window(-5.0, 9.0, lo, hi, n) == (
            jwarp.drift_window(-5.0, 9.0, lo, hi, n))
    arr = np.random.default_rng(6).normal(size=(17, 17))
    for k in (0, 3, 16, 40):
        assert tswr._max_window_span(arr, k) == jswr._max_window_span(arr, k)


@pytest.mark.parametrize(
    "wh,f,crop,res,eyes,lat_size,want",
    [
        # a narrow view: the only kind where the bound is not 0
        ((800, 800), 4.0, 32, (32, 64, 128, 256), [(0.3, 0.2, -1.3)], 0, 64),
        ((800, 800), 4.0, 32, (32, 64, 128, 256),
         [(0.3, 0.2, -1.3), (1.25, 0.4, 0.2)], 0, 64),
        ((800, 800), 4.0, 64, (32, 64, 128), [(0.3, 0.2, -1.3)], 0, 32),
        ((800, 800), 0.9 * 4.0, 16, (32, 64, 128, 256),
         [(0.3, 0.2, -1.3)], 96, None),
        # the views of the synthetic rigs: 0 (the full matrix)
        ((256, 256), 0.9, 128, (32, 64, 128, 256), [(0.3, 0.2, -1.3)], 0, 0),
        ((800, 800), 0.9, 256, (32, 64, 128, 256),
         [(0.8, 0.5, -1.1), (1.3, 0.3, 0.2)], 0, 0),
        ((800, 800), 0.9, None, (32, 64, 128, 256), [(0.3, 0.2, -4.0)], 0, 0),
    ],
)
def test_slab_window_bound_matches_jax(wh, f, crop, res, eyes, lat_size,
                                       want):
    poses = np.stack([_pose(e) for e in eyes])
    K = _K(*wh, f=f)
    got = tswr.slab_window_bound(poses, K, wh, tpyr.PyramidConfig(res),
                                 crop=crop, lat_size=lat_size)
    assert got == jswr.slab_window_bound(poses, K, wh,
                                         jpyr.PyramidConfig(res), crop=crop,
                                         lat_size=lat_size)
    if want is not None:
        assert got == want


# ------------------------------------------------------------------ model


def test_split_init_and_bake_match_jax():
    gen = torch.Generator().manual_seed(3)
    _, split = _cfgs(sigma_res=32)
    p = tpyr.init_pyramid_params(split, gen)
    assert tuple(p["sigma_level"].shape) == (32, 32, 32)
    # the split config's levels and MLP are the unsplit config's
    q = tpyr.init_pyramid_params(_cfgs()[1], torch.Generator().manual_seed(3))
    for a, b in zip(tst.tree_leaves({k: p[k] for k in q}), tst.tree_leaves(q)):
        assert torch.equal(a, b)
    tree = _tree(seed=1, blob=3.0, sigma_res=32)
    jcfg, tcfg = _cfgs(sigma_res=32, sigma_bias=-1.0)
    js, jf = jpyr.bake(_jax_params(tree), jcfg)
    ts, tf = tpyr.bake(pyramid_params_from_numpy(tree), tcfg)
    assert tuple(ts.shape) == (32, 32, 32) and tuple(tf.shape) == (16, 16,
                                                                   16, 3)
    np.testing.assert_allclose(np32(ts), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np32(tf), np.asarray(jf), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------ render

# a narrow view (focal 6 w, lattice pad 2) on which an 8-cell source window
# reaches most of the object
NARROW = dict(wh=(16, 16), f=6.0, eye=(0.1, 0.05, -1.3), lat_pad=2)
OBLIQUE = dict(wh=(24, 24), f=0.9, eye=(0.8, 0.5, -1.1))
RENDER_CASES = {
    "split": (dict(sigma_res=32), OBLIQUE, {}),
    "per_sample": (dict(deferred=False), OBLIQUE, {}),
    "distortion": ({}, OBLIQUE, dict(want_distortion=True)),
    "window8": ({}, NARROW, dict(slab_window=8)),
    "split_window8": (dict(sigma_res=32), NARROW, dict(slab_window=8)),
    "x_flip": (dict(deferred=False, sigma_res=32),
               dict(OBLIQUE, eye=(1.3, 0.3, 0.2)), {}),
    "all": (dict(sigma_res=32, deferred=False), NARROW,
            dict(want_distortion=True, slab_window=8, skip_empty=True)),
}


def _render_both(cfg_kw, view, kw, seed=0, blob=2.0, radius=0.25):
    view = dict(view)
    wh, f, eye = view.pop("wh"), view.pop("f"), view.pop("eye")
    jcfg, tcfg = _cfgs(**cfg_kw)
    tree = _tree(seed, blob, radius, sigma_res=jcfg.sigma_res)
    jp = _jax_params(tree)
    tp = pyramid_params_from_numpy(tree)
    pose, K = _pose(eye), _K(*wh, f=f)
    kw = dict(kw, **view)
    want = jswr.render_swr(jp, jpyr.bake(jp, jcfg), jcfg, pose, K, wh,
                           n_chunks=4, sweep_impl="xla", **kw)
    got = tswr.render_swr(tp, tpyr.bake(tp, tcfg), tcfg, pose, K, wh,
                          n_chunks=4, **kw)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(np32(got[k]), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    return got


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_scan_render_matches_jax(case, monkeypatch):
    calls = []
    monkeypatch.setattr(tswr, "chunk_sweep",
                        lambda *a, **k: calls.append(1))
    got = _render_both(*RENDER_CASES[case])
    assert float(got["opacity"].max()) > 0.5
    assert not calls  # the scan, never the sweep
    if "distortion" in got:
        assert float(got["distortion"].max()) > 0


@pytest.mark.parametrize("deferred", [True, False],
                         ids=["deferred", "per_sample"])
def test_scan_early_exit_matches_jax(deferred, monkeypatch):
    """A narrow view filled by an opaque core: every lattice point is
    saturated after the first chunk, and the scan stops there."""
    chunks = []
    real = tswr._scan_chunk
    monkeypatch.setattr(tswr, "_scan_chunk",
                        lambda *a, **k: chunks.append(1) or real(*a, **k))
    got = _render_both(
        dict(deferred=deferred, sigma_res=32, sigma_bias=-12.0),
        dict(wh=(16, 16), f=6.0, eye=(0.1, 0.3, -1.4), lat_pad=2),
        dict(early_exit=1e-4, skip_empty=True), seed=1, blob=500.0,
        radius=0.25,
    )
    assert float(got["opacity"].min()) > 0.9
    assert len(chunks) == 1


def test_windowed_render_matches_full_where_it_covers():
    """A 16-cell window covers a focal-12 view of a 32^3 grid: the
    windowed scan renders what the full-matrix sweep renders."""
    _, tcfg = _cfgs(resolutions=(16, 32))
    tp = pyramid_params_from_numpy(_tree(blob=3.0, res=(16, 32)))
    grid = tpyr.bake(tp, tcfg)
    args = (tp, grid, tcfg, _pose((0.1, 0.05, -1.3)), _K(16, 16, f=12.0),
            (16, 16))
    full = tswr.render_swr(*args, n_chunks=4, lat_pad=2)
    win = tswr.render_swr(*args, n_chunks=4, lat_pad=2, slab_window=16)
    assert float(full["opacity"].max()) > 0.5
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_allclose(np32(win[k]), np32(full[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_scan_options_are_checked():
    jcfg, tcfg = _cfgs()
    tp = pyramid_params_from_numpy(_tree())
    grid = tpyr.bake(tp, tcfg)
    args = (tp, grid, tcfg, _pose(OBLIQUE["eye"]), _K(16, 16), (16, 16))
    with pytest.raises(ValueError, match="cubic"):
        tswr.render_swr(*args, slab_window=8, resample_kind="cubic")
    with pytest.raises(ValueError, match="early_exit"):
        tswr.render_swr(*args, want_distortion=True, early_exit=1e-4)
    with pytest.raises(ValueError, match="split"):
        tswr.render_swr(*args[:2], _cfgs(sigma_res=32)[1], *args[3:])


# ------------------------------------------------------------------ loss

LOSS_CASES = {
    # deferred, unsplit, full matrices: the sweep (the JAX Pallas kernel in
    # interpret mode on one side, the port's plain sweep on the other)
    "linear": ({}, 0, {}),
    "windowed": ({}, 8, {}),
    "split": (dict(sigma_res=32), 0, {}),
    "per_sample": (dict(deferred=False), 0, {}),
    "distortion": ({}, 0, dict(distortion_w=1e-2)),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_grads_match_jax(case):
    cfg_kw, slab_window, tkw = LOSS_CASES[case]
    jm, tm = _cfgs(sigma_bias=-1.0, **cfg_kw)
    tree = _tree(seed=5, blob=3.0, sigma_res=jm.sigma_res)
    common = dict(crop=24, n_chunks=4, tv_w=5e-3, sigma_l1=1e-3,
                  alpha_w=0.2, random_bg=True, **tkw)
    in_sweep = case == "linear"
    jc = jst.SwrTrainConfig(
        sweep_impl="pallas_interpret" if in_sweep else "xla", **common)
    tc = tst.SwrTrainConfig(**common)
    assert tc.resample_kind == "linear"
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (40, 40, 4), dtype=np.uint8)
    pose = look_at(np.array([0.4, -1.2, 0.5]), np.zeros(3),
                   np.array([0.0, 0.0, 1.0]))
    f = 96.0 if slab_window else 36.0  # a narrow view for the window
    K = np.array([[f, 0, 20], [0, f, 20], [0, 0, 1]], np.float32)
    axis = int(np.argmax(np.abs(pose[:, 2])))
    flip = bool(pose[axis, 3] > 0)
    crop_xy, lat = (9, 5), 40
    k_tv = jax.random.PRNGKey(3)
    # the JAX loss's own random draws, handed to the port as arguments
    bg = np.asarray(jax.random.uniform(jax.random.fold_in(k_tv, 17),
                                       (24 * 24, 3)))
    tv_res = (RES[-1],) + ((jm.sigma_res,) if jm.split else ())
    tv_starts = tuple(
        int(jax.random.randint(jax.random.fold_in(k_tv, i), (), 0,
                               r - tst.tv_window(r) + 1))
        for i, r in enumerate(tv_res))
    jloss = jst.make_swr_loss(
        jnp.asarray(img), jnp.asarray(pose), jnp.asarray(K),
        jnp.asarray(crop_xy, jnp.int32), k_tv, jm, jc, axis, flip,
        slab_window=slab_window, lat_size=lat,
    )
    (jl, jmse), jg = jax.value_and_grad(jloss, has_aux=True)(
        _jax_params(tree))
    params = tst._trainable(pyramid_params_from_numpy(tree))
    tloss = tst.make_swr_loss(
        torch.as_tensor(img), pose, K, crop_xy, tm, tc, axis, flip, bg=t32(bg),
        tv_starts=tv_starts, lat_size=lat, slab_window=slab_window,
    )
    tl, tmse = tloss(params)
    grads = torch.autograd.grad(tl, tst.tree_leaves(params))
    tl, tmse = float(tl.detach()), float(tmse.detach())
    assert abs(tl - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert abs(tmse - float(jmse)) <= LOSS_TOL * abs(float(jmse))
    leaves = jax.tree_util.tree_leaves(jg)
    assert len(leaves) == len(grads)
    for lv, (a, b) in enumerate(zip(grads, leaves)):
        assert _rel_norm(np32(a), b) <= GRAD_TOL, lv
    assert float(np.abs(np.asarray(jg["levels"][-1])).max()) > 0
    if jm.split:
        assert float(np.abs(np.asarray(jg["sigma_level"])).max()) > 0


# ------------------------------------------------------------------ trainer


@pytest.fixture(scope="module")
def sphere():
    return tsyn.SyntheticSphereDataset(n_images=8, img_wh=(32, 32))


def test_trainer_slab_window_matches_jax():
    """Per coarse-to-fine phase, on narrow 800^2 views (focal 4 w, crop 32):
    0 at R=16, a 32-cell window at R=128, as the JAX trainer picks them."""
    wh = (800, 800)
    poses = np.stack([_pose((0.3, 0.2, -1.3)), _pose((0.2, -0.3, -1.25))])
    K = _K(*wh, f=4.0)
    images = np.zeros((2, wh[0] * wh[1], 3), np.float32)
    kw = dict(resolutions=(16, 128), features=2, rgb_width=8, deferred=True)
    tkw = dict(crop=32, n_chunks=4, prog_steps=(2,), max_steps=4)
    jtr = jst.SwrTrainer(jpyr.PyramidConfig(**kw), jst.SwrTrainConfig(**tkw),
                         images, poses, K, wh)
    ttr = tst.SwrTrainer(tpyr.PyramidConfig(**kw), tst.SwrTrainConfig(**tkw),
                         images, poses, K, wh, device="cpu")
    got = [ttr.slab_window]
    want = [jtr.slab_window]
    jtr._activate_phase(1, jax.random.PRNGKey(1))
    ttr._advance_phases(to_idx=1)
    got.append(ttr.slab_window)
    want.append(jtr.slab_window)
    assert got == want == [0, 32]
    # cubic keeps the full matrix
    cubic = tst.SwrTrainer(tpyr.PyramidConfig(**kw),
                           tst.SwrTrainConfig(resample_kind="cubic", **tkw),
                           images, poses, K, wh, device="cpu")
    cubic._advance_phases(to_idx=1)
    assert cubic.slab_window == 0


def test_default_linear_training_improves(sphere):
    """``SwrTrainConfig()``'s own resample kind (linear) trains."""
    tcfg = tst.SwrTrainConfig(crop=32, lr=5e-2, max_steps=40, n_chunks=4,
                              sigma_l1=0.0)
    assert tcfg.resample_kind == "linear"
    trainer = tst.SwrTrainer(tpyr.PyramidConfig(**dict(
        resolutions=RES, features=FEAT, rgb_width=16, deferred=True)), tcfg,
        sphere.rays, sphere.poses, sphere.K, sphere.img_wh, device="cpu")
    assert trainer.slab_window == 0
    first = None
    for _ in range(40):
        m = trainer.run_step()
        first = float(m["loss"]) if first is None else first
    assert float(m["psnr"]) > -10 * np.log10(first) + 4
    rgb = np32(trainer.render(sphere.poses[0])["rgb"]).reshape(32, 32, 3)
    gt = sphere.rays[0].reshape(32, 32, 3)
    assert -10 * np.log10(np.mean((rgb - gt) ** 2) + 1e-12) > 14


def test_split_npz_round_trip_through_both_packages(sphere, tmp_path):
    """A split, per-sample model trained by the port: its
    ``model_pyramid.npz`` (with ``sigma_level``) reads back exactly in both
    packages, and both render the same frame from it."""
    kw = dict(resolutions=RES, features=FEAT, rgb_width=16, sigma_res=32,
              deferred=False)
    # 16 chunks, as PyramidRenderer sweeps them
    tkw = dict(crop=32, max_steps=4, n_chunks=16, distortion_w=1e-3)
    tr = tst.SwrTrainer(tpyr.PyramidConfig(**kw), tst.SwrTrainConfig(**tkw),
                        sphere.rays, sphere.poses, sphere.K, sphere.img_wh,
                        device="cpu")
    assert len(tr.draw()[3]) == 2  # TV windows: the finest and sigma levels
    for _ in range(3):
        assert np.isfinite(float(tr.run_step()["loss"]))
    path = str(tmp_path / "model_pyramid.npz")
    save_pyramid_npz(path, tr.state.params)
    back = load_pyramid_npz(path)
    assert set(back) == {"levels", "rgb_mlp", "sigma_level"}
    for a, b in zip(tst.tree_leaves(back), tst.tree_leaves(tr.state.params)):
        assert torch.equal(a, b.detach())
    cfg = config_for_params(back, tpyr.PyramidConfig(deferred=False))
    assert (cfg.resolutions, cfg.sigma_res) == (RES, 32)
    jtr = jst.SwrTrainer(jpyr.PyramidConfig(**kw), jst.SwrTrainConfig(**tkw),
                         sphere.rays, sphere.poses, sphere.K, sphere.img_wh)
    jtr.load_npz(path)
    np.testing.assert_array_equal(np.asarray(jtr.state.params["sigma_level"]),
                                  np32(tr.state.params["sigma_level"]))
    for a, b in zip(jtr.state.params["levels"], tr.state.params["levels"]):
        np.testing.assert_array_equal(np.asarray(a), np32(b))
    tr2 = tst.SwrTrainer(tpyr.PyramidConfig(**kw), tst.SwrTrainConfig(**tkw),
                         sphere.rays, sphere.poses, sphere.K, sphere.img_wh,
                         device="cpu")
    tr2.load_npz(path)
    pose = sphere.poses[1]
    want = jtr.render(pose)
    got = tr2.render(pose)
    rend = PyramidRenderer(back, tpyr.PyramidConfig(**kw), sphere.K,
                           sphere.img_wh).render(pose)
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_allclose(np32(got[k]), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_array_equal(np32(rend[k]), np32(got[k]))
    with pytest.raises(ValueError, match="sigma_level"):
        tst.SwrTrainer(tpyr.PyramidConfig(**dict(kw, sigma_res=0)),
                       tst.SwrTrainConfig(**tkw), sphere.rays, sphere.poses,
                       sphere.K, sphere.img_wh, device="cpu").load_npz(path)


def test_train_entry_runs_the_scan_options(tmp_path, monkeypatch):
    """``python -m taichi_nerfs_torch.train`` with a split grid, per-sample
    shading and the distortion loss."""
    from taichi_nerfs_torch.train.__main__ import main

    monkeypatch.chdir(tmp_path)
    manifest = main([
        "--root_dir", "synthetic://sphere?views=4&res=16",
        "--dataset_name", "synthetic", "--model_name", "pyramid",
        "--pyramid_levels", "8,16", "--features", "4", "--sigma_res", "32",
        "--shading", "per_sample", "--distortion_loss_w", "1e-3",
        "--max_steps", "3", "--exp_name", "tiny", "--eval_views", "1",
        "--device", "cpu",
    ])
    cfg = json.loads(manifest["config"])
    assert cfg["mcfg"]["sigma_res"] == 32 and not cfg["mcfg"]["deferred"]
    assert cfg["tcfg"]["distortion_w"] == 1e-3
    assert cfg["tcfg"]["resample_kind"] == "linear"
    assert manifest["views_finite"] == 1
    params = load_pyramid_npz(
        str(tmp_path / "results" / "tiny" / "model_pyramid.npz"))
    assert tuple(params["sigma_level"].shape) == (32, 32, 32)
