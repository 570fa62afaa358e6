"""Port parity: resampling, SH, MLP, TruncExp, metrics and the numpy helpers.

Each ported function against its JAX counterpart on the same numpy inputs.
Tolerances: 1e-6 where both sides compute in fp32, 1e-5 where the MLP
rounds operands to bf16 (the sums run in another order, so a product can
land on the other side of a bf16 rounding step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import mlp_dims, np32, t32

from taichi_nerfs_torch.data import cameras as tcam
from taichi_nerfs_torch.models import mlp as tmlp
from taichi_nerfs_torch.models.ngp import trunc_exp as t_trunc_exp
from taichi_nerfs_torch.ops import warp as twarp
from taichi_nerfs_torch.ops.sh import sh_encode as t_sh
from taichi_nerfs_torch.train import metrics as tmet
from taichi_nerfs_torch.utils.viz import depth2img as t_depth2img
from taichi_nerfs_tpu.data.synthetic import look_at as j_look_at
from taichi_nerfs_tpu.models import mlp as jmlp
from taichi_nerfs_tpu.models.ngp import trunc_exp as j_trunc_exp
from taichi_nerfs_tpu.ops import warp as jwarp
from taichi_nerfs_tpu.ops.sh import sh_encode as j_sh
from taichi_nerfs_tpu.train import metrics as jmet
from taichi_nerfs_tpu.utils.viz import depth2img as j_depth2img

KINDS = ["linear", "cubic"]


@pytest.mark.parametrize("kind", KINDS)
def test_interp_kernel(kind):
    x = np.linspace(-3.0, 3.0, 2001, dtype=np.float32)
    np.testing.assert_allclose(
        np32(twarp.interp_kernel(t32(x), kind)),
        np.asarray(jwarp.interp_kernel(jnp.asarray(x), kind)),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("kind", KINDS)
def test_interp_matrix(kind):
    start, step = np.float32(-1.37), np.float32(0.83)
    got = twarp.interp_matrix(t32(start), t32(step), 12, 17, kind=kind)
    want = jwarp.interp_matrix(jnp.float32(start), jnp.float32(step), 12, 17,
                               kind=kind)
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_resample_matmul(kind, axis):
    x = np.random.default_rng(axis).normal(size=(5, 6, 7)).astype(np.float32)
    start, step = np.float32(-0.6), np.float32(0.71)
    got = twarp.resample_matmul(t32(x), t32(start), t32(step), 9, axis,
                                kind=kind)
    want = jwarp.resample_matmul(jnp.asarray(x), jnp.float32(start),
                                 jnp.float32(step), 9, axis, kind=kind)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_sh_encode():
    d = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True) + 1.0) / 2.0
    np.testing.assert_allclose(
        np32(t_sh(t32(d))), np.asarray(j_sh(jnp.asarray(d))),
        rtol=1e-6, atol=1e-6,
    )


def _mlp_case(bias):
    spec_kw = dict(input_dim=11, output_dim=3, net_depth=6, net_width=16,
                   bias_enabled=bias, output_activation="sigmoid")
    rng = np.random.default_rng(2)
    params = {}
    for i, (fi, fo) in enumerate(mlp_dims(11, 3, 6, 16)):
        params[f"w{i}"] = rng.normal(0, 0.4, (fi, fo)).astype(np.float32)
        if bias:
            params[f"b{i}"] = rng.normal(0, 0.1, (fo,)).astype(np.float32)
    x = rng.normal(size=(40, 11)).astype(np.float32)
    return spec_kw, params, x


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize(
    "dtypes,tol",
    [((torch.bfloat16, jnp.bfloat16), 1e-5),
     ((torch.float32, jnp.float32), 1e-6)],
    ids=["bf16", "fp32"],
)
def test_apply_mlp(bias, dtypes, tol):
    spec_kw, params, x = _mlp_case(bias)
    got = tmlp.apply_mlp({k: t32(v) for k, v in params.items()},
                         tmlp.MLPSpec(**spec_kw), t32(x), dtypes[0])
    want = jmlp.apply_mlp({k: jnp.asarray(v) for k, v in params.items()},
                          jmlp.MLPSpec(**spec_kw), jnp.asarray(x), dtypes[1])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_mlp_layer_dims_and_init():
    kw = dict(input_dim=11, output_dim=3, net_depth=6, net_width=16)
    spec = tmlp.MLPSpec(**kw)
    assert spec.layer_dims() == jmlp.MLPSpec(**kw).layer_dims()
    p = tmlp.init_mlp(spec, torch.Generator().manual_seed(0))
    for i, (fi, fo) in enumerate(spec.layer_dims()):
        assert tuple(p[f"w{i}"].shape) == (fi, fo)
        assert float(p[f"w{i}"].abs().max()) <= np.sqrt(6.0 / (fi + fo))
        assert not bool(p[f"b{i}"].any())
    again = tmlp.init_mlp(spec, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_trunc_exp_forward_and_clamped_grad():
    x = np.linspace(-20.0, 20.0, 81, dtype=np.float32)
    xt = t32(x).requires_grad_(True)
    y = t_trunc_exp(xt)
    g = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    y.backward(t32(g))
    jy, vjp = jax.vjp(j_trunc_exp, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(np32(y), np.asarray(jy), rtol=1e-6)
    np.testing.assert_allclose(np32(xt.grad), np.asarray(jg), rtol=1e-6)
    # the backward clamps: beyond +-15 the grad is g * e^{+-15}
    assert np.isclose(float(xt.grad[-1]), g[-1] * np.exp(15.0), rtol=1e-6)


def test_psnr_ssim():
    rng = np.random.default_rng(4)
    a = rng.random((48, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(
        float(tmet.psnr(t32(a), t32(b))),
        float(jmet.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(tmet.ssim(t32(a), t32(b))),
        float(jmet.ssim(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-6,
    )


def test_depth2img_matches():
    d = np.random.default_rng(5).random((20, 30)).astype(np.float32)
    np.testing.assert_array_equal(t_depth2img(d), j_depth2img(d))
    flat = np.full((4, 5), 0.7, np.float32)
    np.testing.assert_array_equal(t_depth2img(flat), j_depth2img(flat))


def test_cameras_match_synthetic_rig():
    eye = np.array([0.8, -0.5, 0.6])
    up = np.array([0.0, 0.0, 1.0])
    np.testing.assert_array_equal(
        tcam.look_at(eye, np.zeros(3), up), j_look_at(eye, np.zeros(3), up)
    )
    K = tcam.intrinsics(64, 48)
    assert K[0, 0] == K[1, 1] == np.float32(0.9 * 64)
    assert (K[0, 2], K[1, 2]) == (32.0, 24.0)
    poses = tcam.orbit_poses(4, radius=1.2)
    assert poses.shape == (4, 3, 4)
    np.testing.assert_allclose(np.linalg.norm(poses[:, :, 3], axis=-1), 1.2,
                               rtol=1e-6)
