"""Port parity of the svox model family: ``eval_sh`` and the dense SH voxel
grid (``models/voxel_grid.py``).

* ``eval_sh`` for degrees 0-4 within 1e-6, ``rgb_to_sh`` / ``sh_to_rgb``;
* ``query_grids``, nearest and trilinear, on random fields, at points
  outside the grid, on cell borders and at exact halves (which the nearest
  query rounds half to even, as ``jnp.round`` does), bit-equal;
* ``density`` / ``forward`` and the gradients w.r.t. both fields within
  1e-5;
* one ``train_step`` of the tiny svox config of ``tests/test_voxel_grid.py``
  (grid 48, radius 1.05 / 48, SH degree 1) against the JAX step, with the
  checks of ``test_torch_ngp_render.py:_assert_same_step``;
* a short run of the port's trainer whose loss falls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ngp_render import (
    _assert_same_step,
    _ball_bitfield,
    _configs,
    _jax_draws,
    _jax_state,
)
from torch_port_helpers import np32, t32

from taichi_nerfs_torch import config as tconfig
from taichi_nerfs_torch.models import voxel_grid as tvox
from taichi_nerfs_torch.models.registry import get_model
from taichi_nerfs_torch.ops import sh as tsh
from taichi_nerfs_torch.train import state as tstate
from taichi_nerfs_torch.train import step as tstep
from taichi_nerfs_torch.utils import convert as tconv
from taichi_nerfs_tpu import config as jconfig
from taichi_nerfs_tpu.data.synthetic import SyntheticSphereDataset as JDS
from taichi_nerfs_tpu.models import voxel_grid as jvox
from taichi_nerfs_tpu.ops import sh as jsh
from taichi_nerfs_tpu.train import step as jstep


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(500, (deg + 1) ** 2)).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))
    got = tsh.eval_sh(deg, t32(sh), t32(d))
    assert got.shape == want.shape == (500,)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-6)


def test_rgb_sh_conversions():
    rgb = np.random.default_rng(0).uniform(0, 1, (64, 3)).astype(np.float32)
    sh = np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb)))
    np.testing.assert_allclose(np32(tsh.rgb_to_sh(t32(rgb))), sh, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np32(tsh.sh_to_rgb(t32(sh))),
                               np.asarray(jsh.sh_to_rgb(jnp.asarray(sh))),
                               rtol=0, atol=1e-6)


# grid 16 with radius 1/16: grid points and halves are exact in fp32
_G, _R = 16, 0.0625


def _model_cfgs(g=_G, r=_R, deg=2):
    kw = dict(name="svox", scale=0.5, voxel_grid_size=g, voxel_radius=r,
              voxel_sh_degree=deg)
    return tconfig.ModelConfig(**kw), jconfig.ModelConfig(**kw)


def _fields(cfg, seed=0):
    rng = np.random.default_rng(seed)
    g, dim = cfg.voxel_grid_size, (1 + cfg.voxel_sh_degree) ** 2
    return {
        "sh_fields": (0.3 * rng.normal(size=(g, g, g, 3 * dim))
                      ).astype(np.float32),
        "density_fields": rng.normal(size=(g, g, g, 1)).astype(np.float32),
    }


def _query_points(cfg, seed=1):
    """Random points in and around the grid, cell borders, exact halves
    (even and odd cells below them) and points outside."""
    rng = np.random.default_rng(seed)
    g, r = cfg.voxel_grid_size, cfg.voxel_radius
    lo = (0 - int(np.ceil(g / 2)) + 1) * r
    pts = [rng.uniform(lo - 2 * r, lo + (g + 1) * r, (600, 3))]
    k = rng.integers(-1, g + 1, (200, 3)).astype(np.float64)
    pts.append(lo + k * r)  # cell borders, a few outside
    k = rng.integers(0, g - 1, (200, 3)) + 0.5
    pts.append(lo + k * r)  # exact halves
    pts.append(np.array([[10.0, 0, 0], [0, -10.0, 0], [lo - r, 0, 0]]))
    return np.concatenate(pts).astype(np.float32)


def test_query_points_hit_halves_and_borders():
    tm, _ = _model_cfgs()
    fidx = np32(tvox._normalize(tm, t32(_query_points(tm))))
    assert np.sum(fidx == np.round(fidx)) > 500
    halves = np.abs(fidx - np.floor(fidx) - 0.5) == 0
    assert halves.sum() > 500
    # half-to-even: both directions occur
    assert len(set(np.round(fidx[halves]) - np.floor(fidx[halves]))) == 2


@pytest.mark.parametrize("trilinear", [False, True],
                         ids=["nearest", "trilinear"])
def test_query_grids(trilinear):
    tm, jm = _model_cfgs()
    f = _fields(tm)
    x = _query_points(tm)
    jsh_, jd = jvox.query_grids({k: jnp.asarray(v) for k, v in f.items()},
                                jm, jnp.asarray(x), trilinear)
    tsh_, td = tvox.query_grids({k: t32(v) for k, v in f.items()}, tm,
                                t32(x), trilinear)
    np.testing.assert_array_equal(np32(tsh_), np.asarray(jsh_))
    np.testing.assert_array_equal(np32(td), np.asarray(jd))
    assert np.all(np32(td)[-3:-1] == 0)  # far outside: gated to zero


def test_init_params_match():
    tm, jm = _model_cfgs(g=8, deg=1)
    tm = tm.replace(voxel_origin_sh=0.25, voxel_origin_sigma=0.5)
    jm = jm.replace(voxel_origin_sh=0.25, voxel_origin_sigma=0.5)
    jp = jax.device_get(jvox.init_params(jax.random.PRNGKey(0), jm))
    tp = get_model("svox").init_params(tm, torch.Generator().manual_seed(0))
    for k in ("sh_fields", "density_fields"):
        np.testing.assert_array_equal(np32(tp[k]), jp[k])
    assert tvox.sh_dim(tm) == 4
    assert tvox._grid_min(tm) == jvox._grid_min(jm)


@pytest.mark.parametrize("deg", [1, 2])
def test_density_forward_and_grads(deg):
    tm, jm = _model_cfgs(deg=deg)
    f = _fields(tm, seed=deg)
    x = _query_points(tm, seed=2)
    rng = np.random.default_rng(3)
    d = rng.normal(size=x.shape).astype(np.float32)
    cot = rng.normal(size=(x.shape[0], 3)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in f.items()}
    tp = {k: t32(v).requires_grad_() for k, v in f.items()}
    np.testing.assert_allclose(
        np32(tvox.density(tp, tm, t32(x))),
        np.asarray(jvox.density(jp, jm, jnp.asarray(x))), rtol=0, atol=1e-5)

    def jloss(p):
        s, c = jvox.forward(p, jm, jnp.asarray(x), jnp.asarray(d))
        return jnp.sum(c * cot) + jnp.sum(s), (s, c)

    (_, (js, jc)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    ts, tc = tvox.forward(tp, tm, t32(x), t32(d))
    np.testing.assert_allclose(np32(ts), np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np32(tc), np.asarray(jc), rtol=0, atol=1e-5)
    assert np32(tc).min() >= 0 and np32(tc).max() <= 1
    tg = torch.autograd.grad(torch.sum(tc * t32(cot)) + torch.sum(ts),
                             [tp["sh_fields"], tp["density_fields"]])
    for a, k in zip(tg, ("sh_fields", "density_fields")):
        b = np.asarray(jg[k])
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(np32(a), b, rtol=0, atol=1e-5, err_msg=k)


def test_one_svox_train_step():
    tcfg, jcfg = _configs("svox")
    scene = JDS(n_images=3, img_wh=(16, 16))
    f = _fields(tcfg.model, seed=4)
    f["density_fields"] = np.abs(f["density_fields"]) * 4.0
    jp = {k: jnp.asarray(v) for k, v in f.items()}
    tp = tstate.trainable(tconv.ngp_params_from_numpy(f))
    words, _ = _ball_bitfield(seed=2)
    jst = _jax_state(jcfg, jp, words)
    draws = _jax_draws(jst, jcfg, random_bg=False)
    jnew, jm = jstep.train_step(jst, scene.as_batch(), jcfg, 128, 4096)
    occ = tconv.occupancy_from_numpy(np.zeros((1, 32**3)),
                                     np.zeros((1, 32**3)), words)
    ts = tstate.TrainState(tp, tstate.make_optimizer(tcfg).init(tp), occ)
    data = tstep.Batch(t32(scene.rays), t32(scene.poses),
                       t32(scene.directions))
    tnew, tm = tstep.train_step(ts, data, tcfg, 128, 4096, draws)
    _assert_same_step(tnew, tm, jnew, jm)
    moved = np.abs(np32(tnew.params["sh_fields"]) - f["sh_fields"])
    assert moved.max() > 0


def test_svox_trains_short():
    """40 steps of the port's trainer on the sphere: the loss falls (the
    JAX suite's ``test_svox_trains`` runs 120 steps, marked slow)."""
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.train.loop import Trainer

    tcfg, _ = _configs("svox")
    scene = SyntheticSphereDataset(n_images=8, img_wh=(32, 32),
                                   device="cpu")
    trainer = Trainer(tcfg, scene.as_batch(), scene.K, scene.img_wh,
                      log_fn=lambda *_: None, device="cpu")
    losses = [float(trainer.run_step()["loss"]) for _ in range(40)]
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-8:]) < losses[0], losses
