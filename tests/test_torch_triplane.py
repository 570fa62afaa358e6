"""Port parity of the tri-plane encoder and the NGP field that uses it.

The encoder against the JAX ``ops/triplane.py`` at a small config (4
levels, F 2, base 4, max 32) and at the default ``TriPlaneConfig``
(max_res 1024): output within 1e-6, the table gradient within 1e-5
relative norm; points exactly at 0 and 1; points outside [0, 1], where JAX
clamps a negative cell to 0 (finite) and reads NaN past the table's end.
The field (``models/ngp.py`` with ``pos_encoder_type="triplane"``) at fp32
and bf16 MLPs within 1e-5, the tolerance of
``test_torch_ngp_encoders.py:test_ngp_density_and_forward``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import np32, t32

from taichi_nerfs_torch import config as tconfig
from taichi_nerfs_torch.models import ngp as tngp
from taichi_nerfs_torch.ops import triplane as ttri
from taichi_nerfs_torch.utils.convert import ngp_params_from_numpy
from taichi_nerfs_tpu import config as jconfig
from taichi_nerfs_tpu.models import ngp as jngp
from taichi_nerfs_tpu.ops import triplane as jtri

_SMALL = dict(levels=4, feature_per_level=2, base_res=4, max_res=32)


def _cfgs(kw):
    return tconfig.TriPlaneConfig(**kw), jconfig.TriPlaneConfig(**kw)


def _table(jc, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (3, jc.max_res**2, jc.feature_per_level)
                       ).astype(np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _compare(tc, jc, table, x, seed=1):
    """Output and table gradient of both encoders at ``x``; returns the
    JAX output."""
    want = np.asarray(jtri.triplane_encode(jnp.asarray(table),
                                           jnp.asarray(x), jc))
    tt = t32(table).requires_grad_()
    got = ttri.triplane_encode(tt, t32(x), tc)
    assert got.shape == want.shape == (x.shape[0], jc.out_dim)
    g = np32(got)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
    np.testing.assert_allclose(g, want, rtol=0, atol=1e-6)
    # the gradient, over the points whose features are finite
    keep = ~np.isnan(want).any(axis=1)
    rng = np.random.default_rng(seed)
    cot = rng.normal(size=want.shape).astype(np.float32)
    jg = np.asarray(jax.grad(lambda t: jnp.sum(
        jtri.triplane_encode(t, jnp.asarray(x[keep]), jc) * cot[keep]))(
            jnp.asarray(table)))
    (tg,) = torch.autograd.grad(torch.sum(
        ttri.triplane_encode(tt, t32(x[keep]), tc) * t32(cot[keep])), tt)
    assert tg.dtype == torch.float32
    assert _rel(np32(tg), jg) <= 1e-5
    assert float(torch.abs(tg).max()) > 0
    return want


@pytest.mark.parametrize("kw", [_SMALL, {}], ids=["small", "default"])
def test_triplane_encode_and_grad(kw):
    tc, jc = _cfgs(kw)
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    _compare(tc, jc, _table(jc), x)


@pytest.mark.parametrize("kw", [_SMALL, {}], ids=["small", "default"])
def test_triplane_cube_corners_and_faces(kw):
    """Points exactly at 0 and 1: every index in range, finite."""
    tc, jc = _cfgs(kw)
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2, (64, 3)).astype(np.float32)
    x[32:, 0] = rng.uniform(0, 1, 32)  # faces too
    want = _compare(tc, jc, _table(jc, 1), x)
    assert np.isfinite(want).all()


def test_triplane_outside_the_cube():
    """Below 0 the cell clamps to 0 (finite, as JAX's uint32 cast gives);
    past 1 the flat index can leave the table, where JAX reads NaN."""
    tc, jc = _cfgs({})
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    x[0:100, 0] = -0.01
    x[100:200, 1] = -0.2
    x[200:300, 2] = 1.01
    x[300:400, 0] = 1.01
    want = _compare(tc, jc, _table(jc, 2), x)
    assert np.isfinite(want[:200]).all()
    assert np.isnan(want[200:]).any()


def _tiny_model(mlp_dtype):
    kw = dict(scale=0.5, pos_encoder_type="triplane", grid_size=32,
              xyz_net_width=16, rgb_net_width=16, mlp_dtype=mlp_dtype)
    return (tconfig.ModelConfig(triplane=tconfig.TriPlaneConfig(**_SMALL),
                                **kw),
            jconfig.ModelConfig(triplane=jconfig.TriPlaneConfig(**_SMALL),
                                **kw))


@pytest.mark.parametrize("mlp_dtype", ["float32", "bfloat16"])
def test_ngp_triplane_density_and_forward(mlp_dtype):
    tm, jm = _tiny_model(mlp_dtype)
    jp = jngp.init_ngp_params(jax.random.PRNGKey(1), jm)
    tp = ngp_params_from_numpy(jax.device_get(jp))
    assert set(tp) == {"triplane_table", "xyz_mlp", "rgb_mlp"}
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.5, 0.5, (2000, 3)).astype(np.float32)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    js = np.asarray(jngp.density(jp, jm, jnp.asarray(x)))
    np.testing.assert_allclose(np32(tngp.density(tp, tm, t32(x))), js,
                               rtol=1e-5, atol=1e-5)
    jsig, jrgb = jngp.forward(jp, jm, jnp.asarray(x), jnp.asarray(d))
    tsig, trgb = tngp.forward(tp, tm, t32(x), t32(d))
    np.testing.assert_allclose(np32(tsig), np.asarray(jsig), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np32(trgb), np.asarray(jrgb), rtol=1e-5,
                               atol=1e-5)


def test_dense_triplane_step_stays_finite():
    """A train step on the dense sample grid (no packing): the JAX renderer
    evaluates the invalid slots where the march left them, outside the
    cube, and its tri-plane loss is NaN; the port evaluates them at the
    cube's centre (``render/renderer.py:_counted``), so its loss and update
    are finite.  Packed steps, where both are finite, match
    (``test_torch_ngp_render.py:test_one_train_step[triplane]``)."""
    from test_torch_ngp_render import (
        _ball_bitfield,
        _configs,
        _jax_draws,
        _jax_state,
        _params,
    )

    from taichi_nerfs_torch.train import state as tstate
    from taichi_nerfs_torch.train import step as tstep
    from taichi_nerfs_torch.utils import convert as tconv
    from taichi_nerfs_tpu.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_tpu.train import step as jstep

    tcfg, jcfg = (
        c.replace(model=c.model.replace(triplane=m.TriPlaneConfig()))
        for c, m in zip(_configs("triplane"), (tconfig, jconfig)))
    scene = SyntheticSphereDataset(n_images=3, img_wh=(16, 16))
    jp, tp = _params(jcfg, seed=3)
    words, _ = _ball_bitfield(seed=2)
    jst = _jax_state(jcfg, jp, words)
    draws = _jax_draws(jst, jcfg, random_bg=False)
    _, jm = jstep.train_step(jst, scene.as_batch(), jcfg, 128, None)
    assert np.isnan(float(jm["loss"]))
    occ = tconv.occupancy_from_numpy(np.zeros((1, 32**3)),
                                     np.zeros((1, 32**3)), words)
    ts = tstate.TrainState(tp, tstate.make_optimizer(tcfg).init(tp), occ)
    data = tstep.Batch(t32(scene.rays), t32(scene.poses),
                       t32(scene.directions))
    tnew, tm = tstep.train_step(ts, data, tcfg, 128, None, draws)
    assert np.isfinite(float(tm["loss"]))
    assert int(tm["rm_samples"]) == int(jm["rm_samples"])
    for leaf in tstate.tree_leaves(tnew.params):
        assert bool(torch.isfinite(leaf).all())
