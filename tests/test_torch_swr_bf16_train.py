"""Port parity: the bf16 options of the pyramid trainer and server.

* ``Adam(mu_dtype=torch.bfloat16)`` against the JAX optimizer with
  ``adam_mu_bf16`` (its Adam with ``mu_dtype=bf16``) fed the same gradients,
  over a few steps and across a ``grow_swr_state``: params within 1e-6
  relative, the first moment bf16 and bit-equal, the second equal;
* a full ``save_state`` / ``load_state`` keeps the bf16 first moment bit
  for bit, and the resumed step is the uninterrupted one;
* one ``swr_train_step`` at ``bake_dtype="bfloat16"``, ``adam_mu_bf16``,
  cubic, random background, opacity and TV terms, against the JAX
  ``swr_train_step`` (its sweep in Pallas interpret mode), with each
  ``resample_dtype``: loss within 2e-2 relative, updated levels within
  2e-2 relative norm;
* the trainer across its phases with every bf16 option, the entry point
  with ``--bake_dtype bfloat16`` (its manifest), ``PyramidRenderer`` and
  the serve entry with a bf16 bake.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import jax_tree, np32, numpy_pyramid_params, t32

from taichi_nerfs_torch.data import synthetic as tsyn
from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.render.serve import PyramidRenderer
from taichi_nerfs_torch.render.serve import main as serve_main
from taichi_nerfs_torch.train import swr_step as tst
from taichi_nerfs_torch.utils.convert import (
    pyramid_params_from_numpy,
    save_pyramid_npz,
)
from taichi_nerfs_tpu.models import pyramid as jpyr
from taichi_nerfs_tpu.train import swr_step as jst

BF16_TOL = 2e-2
SMALL = dict(resolutions=(8, 16), features=4, rgb_width=16, scale=0.5,
             deferred=True)
BF16 = dict(bake_dtype="bfloat16", adam_mu_bf16=True)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bits(x):
    """A bf16 array's values as fp32 numpy (exact)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def sphere():
    return tsyn.SyntheticSphereDataset(n_images=8, img_wh=(32, 32))


# ------------------------------------------------------------------ adam


def test_adam_mu_bf16_matches_jax_across_growth():
    full = jpyr.PyramidConfig(resolutions=(4, 8, 16), features=4,
                              rgb_width=8, deferred=True)
    tcfg_kw = dict(lr=3e-2, max_steps=12, resample_kind="cubic",
                   adam_mu_bf16=True)
    jc, tc = jst.SwrTrainConfig(**tcfg_kw), tst.SwrTrainConfig(**tcfg_kw)
    tree = numpy_pyramid_params((4, 8), (4, 4), 8, 2, seed=2)
    jp = jax_tree(tree)
    jopt = jst.make_optimizer(jc)
    js = jopt.init(jp)
    tp = tst._trainable(pyramid_params_from_numpy(tree))
    topt = tst.make_optimizer(tc)
    ts_ = topt.init(tp)
    rng = np.random.default_rng(0)

    def steps(n, jp, js, ts_):
        for _ in range(n):
            g = jax.tree_util.tree_map(
                lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32),
                jax.device_get(jp),
            )
            u, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                jp)
            jp = optax.apply_updates(jp, u)
            ts_ = topt.update(pyramid_params_from_numpy(g), ts_, tp)
        return jp, js, ts_

    def check(jp, js, ts_):
        adam = js[0]
        for a, b in zip(tst.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(np32(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        for a, b in zip(tst.tree_leaves(ts_.mu),
                        jax.tree_util.tree_leaves(adam.mu)):
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
            np.testing.assert_array_equal(_bits(a), _bits(b))
        for a, b in zip(tst.tree_leaves(ts_.nu),
                        jax.tree_util.tree_leaves(adam.nu)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(np32(a), np.asarray(b), rtol=1e-6,
                                       atol=0)
        assert ts_.count == int(adam.count)

    jp, js, ts_ = steps(3, jp, js, ts_)
    check(jp, js, ts_)
    jstate = jst.grow_swr_state(jst.SwrTrainState(jp, js, None), full, jc,
                                jax.random.PRNGKey(1))
    jp, js = jstate.params, jstate.opt_state
    tstate = tst.grow_swr_state(tst.SwrTrainState(tp, ts_),
                                tpyr.PyramidConfig(**dataclasses.asdict(full)),
                                tc)
    with torch.no_grad():
        tstate.params["levels"][2].copy_(t32(jp["levels"][2]))
    tp, ts_ = tstate.params, tstate.opt_state
    # the new level's first moment starts as bf16 zeros
    assert ts_.mu["levels"][2].dtype == torch.bfloat16
    assert not bool(ts_.mu["levels"][2].any())
    jp, js, ts_ = steps(3, jp, js, ts_)
    check(jp, js, ts_)


def _trainer(scene, **tkw):
    mkw = dict(SMALL, **tkw.pop("mcfg", {}))
    base = dict(crop=32, lr=5e-2, max_steps=40, n_chunks=4, sigma_l1=0.0,
                resample_kind="cubic")
    base.update(tkw)
    alphas = scene.alphas if base.get("random_bg") else None
    return tst.SwrTrainer(tpyr.PyramidConfig(**mkw),
                          tst.SwrTrainConfig(**base), scene.rays,
                          scene.poses, scene.K, scene.img_wh, alphas=alphas,
                          device="cpu")


def test_full_save_load_keeps_the_bf16_moment(sphere, tmp_path):
    kw = dict(mcfg=dict(resolutions=(4, 8), rgb_width=8, rgb_depth=1),
              crop=16, max_steps=40, n_chunks=2, prog_steps=(4,),
              random_bg=True, tv_w=3e-3, **BF16)
    tr = _trainer(sphere, **kw)
    for _ in range(6):  # crosses the phase boundary at step 4
        tr.run_step()
    path = str(tmp_path / "state.pt")
    tr.save_state(path, light=False)
    tr2 = _trainer(sphere, **kw)
    tr2.load_state(path)
    for a, b in zip(tst.tree_leaves(tr.state.opt_state.mu),
                    tst.tree_leaves(tr2.state.opt_state.mu)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)
    for a, b in zip(tst.tree_leaves(tr.state.params),
                    tst.tree_leaves(tr2.state.params)):
        assert torch.equal(a, b)
    m1, m2 = tr.run_step(), tr2.run_step()
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(tst.tree_leaves(tr.state.params),
                    tst.tree_leaves(tr2.state.params)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ step


@pytest.mark.parametrize("rs_dtype", ["float32", "bfloat16"])
def test_bf16_train_step_matches_jax(rs_dtype):
    res = (8, 16, 32)
    tree = numpy_pyramid_params(res, (4, 4, 4), 16, 2, seed=5, blob=3.0)
    cfg_kw = dict(resolutions=res, features=4, rgb_width=16, scale=0.5,
                  sigma_bias=-1.0, deferred=True)
    jm, tm = jpyr.PyramidConfig(**cfg_kw), tpyr.PyramidConfig(**cfg_kw)
    common = dict(crop=24, n_chunks=8, tv_w=5e-3, sigma_l1=1e-3,
                  alpha_w=0.2, random_bg=True, resample_kind="cubic",
                  resample_dtype=rs_dtype, lr=1e-2, max_steps=100, **BF16)
    jc = jst.SwrTrainConfig(sweep_impl="pallas_interpret", **common)
    tc = tst.SwrTrainConfig(**common)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (40, 40, 4), dtype=np.uint8)
    pose = tsyn.look_at(np.array([0.4, -1.2, 0.5]), np.zeros(3),
                        np.array([0.0, 0.0, 1.0]))
    K = np.array([[36.0, 0, 20], [0, 36.0, 20], [0, 0, 1]], np.float32)
    axis = int(np.argmax(np.abs(pose[:, 2])))
    flip = bool(pose[axis, 3] > 0)
    crop_xy, lat = (9, 5), 40
    jp = jax_tree(tree)
    key = jax.random.PRNGKey(3)
    jstate = jst.SwrTrainState(jp, jst.make_optimizer(jc).init(jp), key)
    # the JAX step's own draws, handed to the port as arguments
    _, k_tv = jax.random.split(key)
    bg = np.asarray(jax.random.uniform(jax.random.fold_in(k_tv, 17),
                                       (24 * 24, 3)))
    rf = res[-1]
    s0 = int(jax.random.randint(jax.random.fold_in(k_tv, 0), (), 0,
                                rf - tst.tv_window(rf) + 1))
    jnew, jmet = jst.swr_train_step(
        jstate, jnp.asarray(img), jnp.asarray(pose), jnp.asarray(K),
        jnp.asarray(crop_xy, jnp.int32), jm, jc, axis, flip, lat_size=lat)
    params = tst._trainable(pyramid_params_from_numpy(tree))
    before = [np32(g).copy() for g in params["levels"]]
    state = tst.SwrTrainState(params, tst.make_optimizer(tc).init(params))
    tnew, tmet = tst.swr_train_step(
        state, torch.as_tensor(img), pose, K, crop_xy, tm, tc, axis, flip,
        bg=t32(bg), tv_starts=(s0,), lat_size=lat)
    tl, jl = float(tmet["loss"]), float(jmet["loss"])
    assert abs(tl - jl) <= BF16_TOL * abs(jl)
    for lv, (a, b, b0) in enumerate(zip(tnew.params["levels"],
                                        jnew.params["levels"], before)):
        assert _rel_norm(np32(a), b) <= BF16_TOL, lv
        assert not np.array_equal(np32(a), b0), lv  # the step moved it
    for a, b in zip(tst.tree_leaves(tnew.opt_state.mu),
                    jax.tree_util.tree_leaves(jnew.opt_state[0].mu)):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16


# ------------------------------------------------------------------ trainer


def test_trainer_runs_every_bf16_option_across_phases(sphere):
    tr = _trainer(sphere, mcfg=dict(resolutions=(4, 8, 16)),
                  prog_steps=(3, 3), max_steps=9, random_bg=True,
                  alpha_w=0.1, tv_w=3e-3, resample_dtype="bfloat16", **BF16)
    for _ in range(9):
        m = tr.run_step()
        assert np.isfinite(float(m["loss"]))
    assert len(tr.state.params["levels"]) == 3
    assert all(m.dtype == torch.bfloat16
               for m in tst.tree_leaves(tr.state.opt_state.mu))
    assert all(v.dtype == torch.float32
               for v in tst.tree_leaves(tr.state.opt_state.nu))
    out = tr.render(sphere.poses[0])
    assert tr._grid_cache[1].dtype == torch.bfloat16
    rgb, op = np32(out["rgb"]), np32(out["opacity"])
    assert np.isfinite(rgb).all()
    assert op.min() >= -1e-6 and op.max() <= 1.0 + 1e-6


def test_unknown_bf16_option_values_raise(sphere):
    for over in (dict(bake_dtype="float16"), dict(resample_dtype="fp8")):
        with pytest.raises(ValueError):
            _trainer(sphere, **over)
    params = pyramid_params_from_numpy(
        numpy_pyramid_params((8, 16), (4, 4), 16, 2, seed=0))
    with pytest.raises(ValueError, match="bake_dtype"):
        PyramidRenderer(params, tpyr.PyramidConfig(**SMALL),
                        bake_dtype="float16")


def test_train_entry_point_bf16(tmp_path, monkeypatch):
    """``--bake_dtype bfloat16`` trains (the bf16 bake and moment) and the
    manifest records both, as ``train.py``'s does."""
    from taichi_nerfs_torch.train.__main__ import main

    monkeypatch.chdir(tmp_path)
    argv = ["--root_dir", "synthetic://sphere?views=4&res=32",
            "--dataset_name", "synthetic", "--model_name", "pyramid",
            "--pyramid_levels", "8,16", "--features", "4",
            "--level_features", "4,2", "--bake_dtype", "bfloat16",
            "--resample_kind", "cubic", "--random_bg", "--alpha_w", "0.1",
            "--max_steps", "6", "--prog_steps", "2", "--exp_name", "tiny",
            "--device", "cpu"]
    manifest = main(argv)
    tcfg = json.loads(manifest["config"])["tcfg"]
    assert tcfg["bake_dtype"] == "bfloat16" and tcfg["adam_mu_bf16"] is True
    assert manifest["views_finite"] == 8 and manifest["steps"] == 6
    assert (tmp_path / "results" / "tiny" / "model_pyramid.npz").is_file()


# ------------------------------------------------------------------ serve


@pytest.mark.parametrize("rs_dtype", ["float32", "bfloat16"])
def test_renderer_serves_a_bf16_bake(rs_dtype):
    cfg = tpyr.PyramidConfig(**dict(SMALL, resolutions=(8, 16, 32)))
    params = pyramid_params_from_numpy(
        numpy_pyramid_params((8, 16, 32), (4, 4, 4), 16, 2, seed=3,
                             blob=6.0))
    K = np.array([[14.4, 0, 8], [0, 14.4, 8], [0, 0, 1]], np.float32)
    pose = tsyn.look_at(np.array([0.3, 0.2, -1.3]), np.zeros(3),
                        np.array([0.0, 0.0, 1.0]))
    ref = PyramidRenderer(params, cfg, K, (16, 16), resample_kind="cubic")
    rend = PyramidRenderer(params, cfg, K, (16, 16), resample_kind="cubic",
                           bake_dtype="bfloat16", resample_dtype=rs_dtype)
    assert rend.grid.dtype == torch.bfloat16
    for cap in ("auto", None):
        out = rend.render(pose, lat_cap=cap)
        rgb, op = np32(out["rgb"]), np32(out["opacity"])
        assert np.isfinite(rgb).all() and np.isfinite(op).all()
        assert op.min() >= -1e-6 and op.max() <= 1.0 + 1e-6
        assert op.max() > 0.5
        want = np32(ref.render(pose, lat_cap=cap)["rgb"])
        np.testing.assert_allclose(rgb, want, rtol=0, atol=BF16_TOL)


def test_serve_entry_bf16(tmp_path):
    # the record widths (the serve entry's base config): rgb MLP 64 x 2
    tree = numpy_pyramid_params((8, 16), (8, 8), 64, 2, seed=1, blob=3.0)
    path = str(tmp_path / "model_pyramid.npz")
    save_pyramid_npz(path, pyramid_params_from_numpy(tree))
    out_dir = tmp_path / "serve"
    serve_main(["--ckpt_path", path, "--img_wh", "16", "16", "--n_views",
                "1", "--resample_kind", "cubic", "--bake_dtype", "bfloat16",
                "--resample_dtype", "bfloat16", "--out_dir", str(out_dir),
                "--device", "cpu"])
    assert (out_dir / "rgb_000.png").is_file()
