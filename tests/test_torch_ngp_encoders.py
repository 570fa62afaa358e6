"""Port parity of the hash and brick encoders and the NGP field.

Small layouts with both dense and hashed levels, fp32 and bf16 tables.
Forward rtol 1e-4 / atol 1e-5 (``tests/test_hash.py``,
``tests/test_brick.py``); table gradients against ``jax.grad`` (the hash
encoder's autodiff, the brick encoder's custom VJP) to 1e-5 in fp32 and
within one bf16 ulp for a bf16 hash table (whose gradient is cast to bf16
once).  The field: fp32 MLPs at 1e-5; bf16 MLPs at 1e-5, the tolerance of
the MLP test in ``tests/test_torch_ops.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import np32, t32

from taichi_nerfs_torch import config as tconfig
from taichi_nerfs_torch.models import ngp as tngp
from taichi_nerfs_torch.ops import brick_encoder as tbrick
from taichi_nerfs_torch.ops import hash_encoder as thash
from taichi_nerfs_torch.utils.convert import ngp_params_from_numpy
from taichi_nerfs_tpu import config as jconfig
from taichi_nerfs_tpu.models import ngp as jngp
from taichi_nerfs_tpu.ops import brick_encoder as jbrick
from taichi_nerfs_tpu.ops import hash_encoder as jhash


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


def _hash_cfg(F, dtype="float32"):
    kw = dict(levels=4, feature_per_level=F, log2_T=11, base_res=4,
              max_res=32, table_dtype=dtype)
    return tconfig.HashGridConfig(**kw), jconfig.HashGridConfig(**kw)


def _brick_cfg(F, dtype="float32"):
    kw = dict(levels=4, feature_per_level=F, log2_rows=9, base_res=4,
              max_res=32, table_dtype=dtype)
    return tconfig.BrickGridConfig(**kw), jconfig.BrickGridConfig(**kw)


def _positions(seed, m=3000):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    x[:20] = rng.integers(0, 2, (20, 3))  # cube corners and faces
    return x


def test_layouts_match():
    for F in (2, 4):
        tc, jc = _hash_cfg(F)
        assert dataclasses.asdict(thash.build_layout(tc)) == \
            dataclasses.asdict(jhash.build_layout(jc))
        tc, jc = _brick_cfg(F)
        tl = tbrick.build_brick_layout(tc)
        assert dataclasses.asdict(tl) == \
            dataclasses.asdict(jbrick.build_brick_layout(jc))
        assert any(tl.dense) and not all(tl.dense)
    # the flagship sizes
    for tc, jc in ((tconfig.BrickGridConfig(), jconfig.BrickGridConfig()),):
        assert dataclasses.asdict(tbrick.build_brick_layout(tc)) == \
            dataclasses.asdict(jbrick.build_brick_layout(jc))
    assert dataclasses.asdict(thash.build_layout(tconfig.HashGridConfig())) \
        == dataclasses.asdict(jhash.build_layout(jconfig.HashGridConfig()))


def test_hash_indices_bit_exact_for_negative_cells():
    """Positions outside [0, 1] give negative int32 cells, which the JAX
    code casts to uint32 before hashing: same table rows."""
    tc, jc = _hash_cfg(2)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.5, 2.5, (2000, 3)).astype(np.float32)
    jl = jhash.build_layout(jc)
    table = rng.uniform(0, 1, (2, jl.n_entries)).astype(np.float32)
    want = np.asarray(jhash.hash_encode(jnp.asarray(table), jnp.asarray(x),
                                        jl))
    got = thash.hash_encode(t32(table), t32(x), thash.build_layout(tc))
    np.testing.assert_allclose(np32(got), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("F,dtype", [(2, "float32"), (4, "float32"),
                                     (2, "bfloat16")])
def test_hash_encode_and_grad(F, dtype):
    tc, jc = _hash_cfg(F, dtype)
    jl, tl = jhash.build_layout(jc), thash.build_layout(tc)
    rng = np.random.default_rng(2)
    table = rng.uniform(0, 1, (F, jl.n_entries)).astype(np.float32)
    x = _positions(3)
    # a mean-style cotangent keeps the table gradients O(1)
    cot = 0.1 * rng.normal(size=(x.shape[0], jl.out_dim)).astype(np.float32)
    bf = dtype == "bfloat16"

    def jf(tab):
        if bf:
            tab = tab.astype(jnp.bfloat16)
        return jhash.hash_encode(tab, jnp.asarray(x), jl)

    want = np.asarray(jf(jnp.asarray(table)))
    jg = np.asarray(jax.grad(lambda t: jnp.sum(jf(t) * cot))(
        jnp.asarray(table)))
    tt = t32(table).requires_grad_()
    got = thash.hash_encode(tt.to(torch.bfloat16) if bf else tt, t32(x), tl)
    np.testing.assert_allclose(np32(got), want, rtol=1e-4, atol=1e-5)
    (tg,) = torch.autograd.grad(torch.sum(got * t32(cot)), tt)
    assert tg.dtype == torch.float32
    if bf:
        assert np.all(np.abs(np32(tg) - jg) <= _bf16_ulp(jg)), \
            np.max(np.abs(np32(tg) - jg) / _bf16_ulp(jg))
    else:
        np.testing.assert_allclose(np32(tg), jg, rtol=0, atol=1e-5)


@pytest.mark.parametrize("F,dtype", [(2, "float32"), (4, "float32"),
                                     (4, "bfloat16")])
def test_brick_encode_and_grad(F, dtype):
    tc, jc = _brick_cfg(F, dtype)
    jl, tl = jbrick.build_brick_layout(jc), tbrick.build_brick_layout(tc)
    params = jax.device_get(jbrick.init_brick_params(jax.random.PRNGKey(0),
                                                     jl))
    x = _positions(4)
    x[20:40] += 0.3  # outside the cube: clamped
    rng = np.random.default_rng(5)
    cot = 0.1 * rng.normal(size=(x.shape[0], jl.out_dim)).astype(np.float32)

    def jf(p):
        return jbrick.brick_encode(p, jnp.asarray(x), jl)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(jf(jp))
    jg = jax.grad(lambda p: jnp.sum(jf(p) * cot))(jp)
    tp = {k: t32(v).requires_grad_() for k, v in params.items()}
    got = tbrick.brick_encode(tp, t32(x), tl)
    np.testing.assert_allclose(np32(got), want, rtol=1e-4, atol=1e-5)
    tg = torch.autograd.grad(torch.sum(got * t32(cot)),
                             (tp["corners"], tp["bricks"]))
    for a, b in zip(tg, (jg["corners"], jg["bricks"])):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(np32(a), np.asarray(b), rtol=0,
                                   atol=1e-5)
    assert float(torch.abs(tg[0]).max()) > 0  # dense levels reached
    assert float(torch.abs(tg[1]).max()) > 0  # hashed levels reached


def _tiny_model(enc, mlp_dtype, table_dtype="float32"):
    kw = dict(
        scale=0.5, pos_encoder_type=enc, grid_size=32, xyz_net_width=16,
        rgb_net_width=16, mlp_dtype=mlp_dtype,
    )
    hk = dict(levels=4, feature_per_level=2, log2_T=11, base_res=4,
              max_res=32, table_dtype=table_dtype)
    bk = dict(levels=4, feature_per_level=4, log2_rows=9, base_res=4,
              max_res=32, table_dtype=table_dtype)
    tm = tconfig.ModelConfig(grid=tconfig.HashGridConfig(**hk),
                             brick=tconfig.BrickGridConfig(**bk), **kw)
    jm = jconfig.ModelConfig(grid=jconfig.HashGridConfig(**hk),
                             brick=jconfig.BrickGridConfig(**bk), **kw)
    return tm, jm


@pytest.mark.parametrize("enc", ["hash", "brick"])
@pytest.mark.parametrize("mlp_dtype", ["float32", "bfloat16"])
def test_ngp_density_and_forward(enc, mlp_dtype):
    tm, jm = _tiny_model(enc, mlp_dtype)
    jp = jngp.init_ngp_params(jax.random.PRNGKey(1), jm)
    tp = ngp_params_from_numpy(jax.device_get(jp))
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


def test_ngp_init_shapes_and_triplane_raises():
    """The port's params have the JAX params' tree and shapes for every
    encoder; the tri-plane encoder (which raised until it was ported)
    too, at its default ``TriPlaneConfig``."""
    for enc in ("hash", "brick", "triplane"):
        tm, jm = _tiny_model(enc, "float32")
        jp = jax.device_get(jngp.init_ngp_params(jax.random.PRNGKey(0), jm))
        tp = tngp.init_ngp_params(tm, torch.Generator().manual_seed(0))
        j_shapes = jax.tree_util.tree_map(np.shape, jp)
        t_shapes = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                        if isinstance(v, dict) else tuple(v.shape))
                    for k, v in tp.items()}
        assert t_shapes == j_shapes
    assert t_shapes["triplane_table"] == (3, 1024**2, 4)
