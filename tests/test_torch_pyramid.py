"""Port parity: the dense pyramid model (bake and rgb heads).

The same numpy params go through the JAX ``bake`` and the port's.
Tolerance 1e-5: both run fp32 upsample matmuls (summed in another order)
and an exp whose output reaches e^11 where the cap binds (compared
relatively).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_tree, np32, numpy_pyramid_params, t32

from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.utils.convert import pyramid_params_from_numpy
from taichi_nerfs_tpu.models import pyramid as jpyr

TOL = 1e-5


def _cfgs(**kw):
    return jpyr.PyramidConfig(**kw), tpyr.PyramidConfig(**kw)


def _bake_both(cfg_kw, tree):
    jcfg, tcfg = _cfgs(**cfg_kw)
    want = np.asarray(jpyr.bake(jax_tree(tree), jcfg))
    got = np32(tpyr.bake(pyramid_params_from_numpy(tree), tcfg))
    return got, want


@pytest.mark.parametrize(
    "level_features",
    [(4, 4, 4), (4, 4, 2), (4, 3, 1)],
    ids=["full", "lean", "leaner"],
)
def test_bake_matches(level_features):
    res = (8, 16, 32)
    cfg_kw = dict(resolutions=res, features=4, level_features=level_features,
                  rgb_width=16, sigma_bias=-1.0, deferred=True)
    tree = numpy_pyramid_params(res, level_features, 16, 2, seed=1,
                                blob=3.0)
    got, want = _bake_both(cfg_kw, tree)
    assert got.shape == want.shape == (32, 32, 32, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_bake_logit_cap_binds():
    res = (8, 16)
    cfg_kw = dict(resolutions=res, features=4, rgb_width=16,
                  sigma_bias=0.0, deferred=True)
    tree = numpy_pyramid_params(res, (4, 4), 16, 2, seed=2, blob=20.0)
    got, want = _bake_both(cfg_kw, tree)
    # the logit reaches ~20 at the blob's core: sigma stops at e^11
    assert float(want[..., 0].max()) == pytest.approx(np.exp(11.0),
                                                      rel=1e-6)
    assert int((want[..., 0] >= np.exp(11.0) * (1 - 1e-6)).sum()) > 8
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_upsample_matrix_edge_clamp():
    for n_in, n_out in ((4, 8), (8, 16), (5, 16)):
        np.testing.assert_allclose(
            np32(tpyr._upsample_matrix(n_in, n_out)),
            np.asarray(jpyr._upsample_matrix(n_in, n_out)),
            rtol=1e-6, atol=1e-7,
        )
        # clamped edges: every output column's weights sum to 1
        np.testing.assert_allclose(
            np32(tpyr._upsample_matrix(n_in, n_out)).sum(0), 1.0, rtol=1e-6
        )


def test_upsample3_matches():
    g = np.random.default_rng(3).normal(size=(6, 6, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np32(tpyr._upsample3(t32(g), 12)),
        np.asarray(jpyr._upsample3(jnp.asarray(g), 12)),
        rtol=TOL, atol=TOL,
    )


def test_rgb_from_features_matches():
    res = (8, 16)
    jcfg, tcfg = _cfgs(resolutions=res, features=5, rgb_width=16,
                       deferred=True)
    tree = numpy_pyramid_params(res, (5, 5), 16, 2, seed=4)
    rng = np.random.default_rng(5)
    feats = rng.normal(0, 0.5, (7, 9, 4)).astype(np.float32)
    dirs = rng.normal(size=(7, 9, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    got = tpyr.rgb_from_features(pyramid_params_from_numpy(tree), tcfg,
                                 t32(feats), t32(dirs))
    want = jpyr.rgb_from_features(jax_tree(tree), jcfg, jnp.asarray(feats),
                                  jnp.asarray(dirs))
    assert tuple(got.shape) == (7, 9, 3)
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_density_from_grid_clamps():
    x = np.random.default_rng(6).normal(size=(5, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np32(tpyr.density_from_grid(t32(x))),
        np.asarray(jpyr.density_from_grid(jnp.asarray(x))),
    )


def test_config_checks_truncate_and_init():
    kw = dict(resolutions=(8, 16, 32), features=4, level_features=(4, 4, 2))
    jcfg, tcfg = _cfgs(**kw)
    assert tcfg.grid_res == 32 and tcfg.feat_of(2) == 2
    assert dataclasses.asdict(tpyr.truncate(tcfg, 2)) == dataclasses.asdict(
        jpyr.truncate(jcfg, 2)
    )
    assert tpyr.rgb_mlp_spec(tcfg).layer_dims() == (
        jpyr.rgb_mlp_spec(jcfg).layer_dims()
    )
    for bad in (
        dict(resolutions=(8, 16), features=4, level_features=(4, 5)),
        dict(resolutions=(8, 16), features=4, level_features=(3, 3)),
        dict(resolutions=(8, 16), features=4, level_features=(4,)),
        dict(resolutions=(8, 16), features=4, sigma_res=16),
    ):
        with pytest.raises(ValueError):
            tpyr.PyramidConfig(**bad)
    p = tpyr.init_pyramid_params(tcfg, torch.Generator().manual_seed(0))
    assert [tuple(g.shape) for g in p["levels"]] == [
        (8, 8, 8, 4), (16, 16, 16, 4), (32, 32, 32, 2)
    ]
    assert float(p["levels"][2].std()) == pytest.approx(1e-2, rel=0.05)
