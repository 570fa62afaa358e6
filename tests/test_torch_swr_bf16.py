"""Port parity: the bf16 path of the pyramid (sweep, resamples, bake, render).

The same numpy inputs go through the JAX package and the port, the volume
rounded to bf16 before either sees it where the case takes a bf16 volume:

* the plain sweep (``chunk_sweep_reference`` and autograd through it)
  against the JAX ``chunk_sweep`` in Pallas interpret mode, over {bf16,
  fp32 volume} x {fp32, bf16 operands} x {linear, cubic}: frames within
  1e-5 and ``d vol``, in the volume's dtype, within 1e-5 relative norm
  (both measured within 6e-7; the plain version without one of the bf16
  roundings the Pallas kernel makes, of the pass-1 product, ``dx2`` or
  ``t``, is 7.7e-4 off in the frames or 1.5e-3 in ``d vol`` or more); and
  a clamp-binding cubic case for every pair;
* the resamples of ``ops/warp.py`` with bf16 operands, against JAX's;
* ``bake(..., dtype=torch.bfloat16)`` against the JAX ``bake(..., bf16)``
  (a lean last level, and a split grid) and its gradient through a sum of
  squares, within 2e-2;
* ``render_swr`` on a bf16 grid with each ``resample_dtype``, through the
  sweep (JAX ``sweep_impl="pallas_interpret"``) and the slab scan (JAX
  ``"xla"``: per-sample shading, a split ``sigma_res``, the distortion
  loss, a windowed resample): frames within 2e-2 and level gradients
  within 2e-2 relative norm.

The kernels' bf16 variants are held against these plain versions on the
card by ``tests/test_torch_swr_sweep_bwd.py``'s
``test_bf16_kernels_match_reference_on_card`` (this file imports JAX,
which the card's machine lacks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (
    jax_tree,
    np32,
    numpy_pyramid_params,
    rand_sweep_inputs,
    t32,
)

from taichi_nerfs_torch.models import ngp as tngp
from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.ops import swr_sweep as tsw
from taichi_nerfs_torch.ops import warp as twarp
from taichi_nerfs_torch.render import swr as tswr
from taichi_nerfs_torch.train import swr_step as tst
from taichi_nerfs_torch.utils.convert import pyramid_params_from_numpy
from taichi_nerfs_tpu.data.synthetic import look_at
from taichi_nerfs_tpu.models import pyramid as jpyr
from taichi_nerfs_tpu.ops import warp as jwarp
from taichi_nerfs_tpu.ops.swr_pallas import chunk_sweep as j_chunk_sweep
from taichi_nerfs_tpu.render import swr as jswr

# the plain sweep against the Pallas kernel: frames (max abs) and d vol
# (relative norm); the bake, render and gradients through bf16 chains
SWEEP_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = ["float32", "bfloat16"]
PAIRS = [(v, o) for v in DTYPES for o in DTYPES]
PAIR_IDS = [f"vol_{v}-ops_{o}" for v, o in PAIRS]


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _f32(x):
    """A JAX or torch array of any float dtype as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ sweep


def _sweep_both(vol_dtype, op_dtype, kind, seed, **shape):
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=seed, **shape)
    g = np.random.default_rng(seed + 9).normal(
        size=(vol.shape[0], vol.shape[2] + 2, nq, nq)).astype(np.float32)
    jv = jnp.asarray(vol, getattr(jnp, vol_dtype))
    frames, vjp = jax.vjp(
        lambda v: j_chunk_sweep(v, jnp.asarray(rs), jnp.asarray(z_rel),
                                jnp.asarray(ch), nq, getattr(jnp, op_dtype),
                                True, kind), jv)
    (jd,) = vjp(jnp.asarray(g))
    tv = t32(vol).to(getattr(torch, vol_dtype)).requires_grad_(True)
    out = tsw.chunk_sweep(tv, t32(rs), t32(z_rel), t32(ch), nq, kind,
                          dtype=getattr(torch, op_dtype))
    out.backward(t32(g))
    return (np32(out), np.asarray(frames)), (tv.grad, jd)


@pytest.mark.parametrize("kind", ["linear", "cubic"])
@pytest.mark.parametrize("vol_dtype,op_dtype", PAIRS, ids=PAIR_IDS)
def test_sweep_matches_pallas_bf16(vol_dtype, op_dtype, kind):
    (got, want), (td, jd) = _sweep_both(vol_dtype, op_dtype, kind, seed=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=SWEEP_TOL)
    # d vol in the volume's dtype, as the Pallas backward returns it
    assert td.dtype == getattr(torch, vol_dtype)
    assert jd.dtype == getattr(jnp, vol_dtype)
    assert _rel_norm(_f32(td), _f32(jd)) <= SWEEP_TOL


@pytest.mark.parametrize("vol_dtype,op_dtype", PAIRS, ids=PAIR_IDS)
def test_sweep_bf16_clamp_binds(vol_dtype, op_dtype):
    """The seed-3 inputs drive cubic-resampled sigma below 0
    (``tests/test_torch_swr_sweep_bwd.py:test_cubic_clamp_binds``): the
    clamp gate with each dtype pair."""
    (got, want), (td, jd) = _sweep_both(vol_dtype, op_dtype, "cubic",
                                        seed=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=SWEEP_TOL)
    assert _rel_norm(_f32(td), _f32(jd)) <= SWEEP_TOL


def test_bf16_operands_round_where_pallas_rounds():
    """A bf16-valued fp32 volume with fp32 operands computes what the bf16
    volume computes (the volume is exact in fp32), and bf16 operands on an
    fp32 volume leave its gradient fp32 (the slab's rounding passes the
    cotangent through, as the Pallas backward's dvol is fp32 there)."""
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=1)
    args = [t32(a) for a in (rs, z_rel, ch)]
    v16 = t32(vol).bfloat16()
    a = tsw.chunk_sweep_reference(v16, *args, nq, "cubic")
    b = tsw.chunk_sweep_reference(v16.float(), *args, nq, "cubic")
    assert torch.equal(a, b)
    v = t32(vol).requires_grad_(True)
    tsw.chunk_sweep_reference(v, *args, nq, "cubic",
                              dtype=torch.bfloat16).sum().backward()
    assert v.grad.dtype == torch.float32
    # with bf16 operands some gradient is not a bf16 value
    assert not torch.equal(v.grad, v.grad.bfloat16().float())


def test_kernel_checks_take_a_bf16_volume_only():
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=2, F=8)
    a = dict(vol_cs=t32(vol).bfloat16(), rs_par=t32(rs), z_rel=t32(z_rel),
             ch_par=t32(ch), nq=nq, kind="cubic")
    tsw._check_kernel_args(**a, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tsw._check_kernel_args(**dict(a, vol_cs=t32(vol).half()))
    with pytest.raises(TypeError):
        tsw._check_kernel_args(**a, dtype=torch.float16)


# ------------------------------------------------------------------ warp


@pytest.mark.parametrize(
    "x_dtype,dtype", [("bfloat16", None), ("float32", "bfloat16"),
                      ("bfloat16", "bfloat16")],
    ids=["bf16_x", "bf16_dtype", "bf16_both"])
@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_resample_matmul_dtype_matches_jax(x_dtype, dtype, kind):
    """Weights in ``dtype or x.dtype``, fp32 accumulation, an fp32 result
    cast to ``dtype`` only when it is given."""
    x = np.random.default_rng(6).normal(size=(3, 40, 5)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, x_dtype))
    want = jwarp.resample_matmul(
        jx, jnp.float32(-1.7), jnp.float32(0.83), 37, 1,
        getattr(jnp, dtype) if dtype else None, kind=kind)
    got = twarp.resample_matmul(
        t32(x).to(getattr(torch, x_dtype)), -1.7, 0.83, 37, 1, kind=kind,
        dtype=getattr(torch, dtype) if dtype else None)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=1e-5)


def test_batched_and_windowed_resamples_take_bf16_operands():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, 10)).astype(np.float32)
    start = np.array([-1.3, 2.2], np.float32)
    step = np.array([0.7, 1.15], np.float32)
    want = jwarp.resample_matmul_batched(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(start), jnp.asarray(step),
        9, 1, kind="cubic")
    got = twarp.resample_matmul_batched(
        t32(x).bfloat16(), t32(start), t32(step), 9, 1, kind="cubic")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=0,
                               atol=1e-5)
    y = rng.normal(size=(4, 256, 8)).astype(np.float32)
    want = jwarp.resample_matmul_windowed(
        jnp.asarray(y, jnp.bfloat16), jnp.float32(40.2), jnp.float32(0.31),
        144, 1, 64, jnp.bfloat16)
    got = twarp.resample_matmul_windowed(
        t32(y).bfloat16(), torch.tensor(40.2), torch.tensor(0.31), 144, 1,
        64, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=1e-2)


def test_trunc_exp_keeps_bf16_both_ways():
    x = torch.tensor([-20.0, -1.0, 0.5, 3.0, 20.0],
                     dtype=torch.bfloat16).requires_grad_(True)
    y = tngp.trunc_exp(x)
    assert y.dtype == torch.bfloat16
    y.backward(torch.ones_like(y))
    assert x.grad.dtype == torch.bfloat16
    want = torch.exp(torch.clamp(x.detach().float(), -15, 15))
    torch.testing.assert_close(x.grad.float(), want, rtol=1e-2, atol=0)


# ------------------------------------------------------------------ bake

BAKE_CASES = {
    # three levels, the last one lean (the R=512 record's shape, smaller)
    "lean": dict(resolutions=(4, 8, 16), features=4,
                 level_features=(4, 4, 2)),
    "split": dict(resolutions=(8, 16), features=4, sigma_res=32),
}


def _bake_case(case):
    kw = dict(BAKE_CASES[case], rgb_width=16, scale=0.5, sigma_bias=-1.0,
              deferred=True)
    jcfg, tcfg = jpyr.PyramidConfig(**kw), tpyr.PyramidConfig(**kw)
    lf = kw.get("level_features") or (kw["features"],) * len(
        kw["resolutions"])
    tree = numpy_pyramid_params(kw["resolutions"], lf, 16, 2, seed=4,
                                blob=3.0)
    if jcfg.split:
        tree["sigma_level"] = (1e-2 * np.random.default_rng(5).normal(
            size=(32,) * 3)).astype(np.float32)
    jp = jax_tree(tree)
    if jcfg.split:
        jp["sigma_level"] = jnp.asarray(tree["sigma_level"])
    return jcfg, tcfg, tree, jp


@pytest.mark.parametrize("case", list(BAKE_CASES))
def test_bake_bf16_matches_jax(case):
    """The bf16 chain of both packages, then the gradient of a sum of
    squares of the baked grid(s) through it."""
    jcfg, tcfg, tree, jp = _bake_case(case)

    def jloss(p):
        out = jpyr.bake(p, jcfg, jnp.bfloat16)
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(jnp.square(o.astype(jnp.float32))) for o in out)

    want = jpyr.bake(jp, jcfg, jnp.bfloat16)
    jg = jax.grad(jloss)(jp)
    tp = tst._trainable(pyramid_params_from_numpy(tree))
    got = tpyr.bake(tp, tcfg, torch.bfloat16)
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got_t, want_t):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=BF16_TOL,
                                   atol=BF16_TOL)
    loss = sum((o.float() ** 2).sum() for o in got_t)
    leaves = tst.tree_leaves(tp)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(leaves)
    for k, (a, b) in enumerate(zip(grads, jleaves)):
        if a is None:  # the rgb MLP does not enter the bake
            assert not np.any(np.asarray(b)), k
            continue
        assert a.dtype == torch.float32
        assert _rel_norm(np32(a), b) <= BF16_TOL, k


# ------------------------------------------------------------------ render

OBLIQUE = dict(wh=(24, 24), f=0.9, eye=(0.8, 0.5, -1.1))
NARROW = dict(wh=(16, 16), f=6.0, eye=(0.1, 0.05, -1.3), lat_pad=2)
# (config, view, render kwargs, JAX sweep_impl)
RENDER_CASES = {
    "sweep_linear": ({}, OBLIQUE, {}, "pallas_interpret"),
    "sweep_cubic": ({}, OBLIQUE, dict(resample_kind="cubic"),
                    "pallas_interpret"),
    "per_sample": (dict(deferred=False), OBLIQUE, {}, "xla"),
    "split": (dict(sigma_res=32), OBLIQUE, {}, "xla"),
    "distortion": ({}, OBLIQUE, dict(want_distortion=True), "xla"),
    "window8": ({}, NARROW, dict(slab_window=8), "xla"),
}


@pytest.mark.parametrize("rs_dtype", DTYPES)
@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_bf16_grid_matches_jax(case, rs_dtype, monkeypatch):
    """A bf16 bake rendered by both packages with ``resample_dtype``: the
    outputs, and the level gradients of a fixed linear functional of them
    through the render and the bake."""
    cfg_kw, view, kw, impl = RENDER_CASES[case]
    view = dict(view)
    wh, f, eye = view.pop("wh"), view.pop("f"), view.pop("eye")
    base = dict(resolutions=(8, 16), features=4, rgb_width=16, scale=0.5,
                sigma_bias=0.0, deferred=True)
    jcfg = jpyr.PyramidConfig(**dict(base, **cfg_kw))
    tcfg = tpyr.PyramidConfig(**dict(base, **cfg_kw))
    tree = numpy_pyramid_params((8, 16), (4, 4), 16, 2, seed=0, blob=2.0)
    if jcfg.split:
        tree["sigma_level"] = (1e-2 * np.random.default_rng(100).normal(
            size=(32,) * 3)).astype(np.float32)
    jp = jax_tree(tree)
    if jcfg.split:
        jp["sigma_level"] = jnp.asarray(tree["sigma_level"])
    pose = look_at(np.array(eye), np.zeros(3), np.array([0.0, 0.0, 1.0]))
    K = np.array([[f * wh[0], 0, wh[0] / 2], [0, f * wh[0], wh[1] / 2],
                  [0, 0, 1]], np.float32)
    kw = dict(kw, **view, n_chunks=4, resample_dtype=rs_dtype)
    rng = np.random.default_rng(11)
    n = wh[0] * wh[1]
    w_rgb = rng.normal(size=(n, 3)).astype(np.float32)
    w_op = rng.normal(size=(n,)).astype(np.float32)

    def j_render(p):
        return jswr.render_swr(p, jpyr.bake(p, jcfg, jnp.bfloat16), jcfg,
                               pose, K, wh, sweep_impl=impl, **kw)

    def j_loss(p):
        out = j_render(p)
        return jnp.sum(out["rgb"] * w_rgb) + jnp.sum(out["opacity"] * w_op)

    want = j_render(jp)
    jg = jax.grad(j_loss)(jp)
    calls = []
    real = tswr.chunk_sweep
    monkeypatch.setattr(tswr, "chunk_sweep",
                        lambda *a, **k: calls.append(a[0].dtype)
                        or real(*a, **k))
    tp = tst._trainable(pyramid_params_from_numpy(tree))
    grid = tpyr.bake(tp, tcfg, torch.bfloat16)
    got = tswr.render_swr(tp, grid, tcfg, pose, K, wh, **kw)
    # the sweep route reads the bf16 grid as it is; the scan never sweeps
    assert calls == ([torch.bfloat16] if impl != "xla" else [])
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(np32(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=BF16_TOL, err_msg=k)
    assert float(got["opacity"].detach().max()) > 0.5
    loss = (got["rgb"] * t32(w_rgb)).sum() + (got["opacity"]
                                              * t32(w_op)).sum()
    leaves = list(tp["levels"]) + ([tp["sigma_level"]] if jcfg.split
                                   else [])
    jleaves = list(jg["levels"]) + ([jg["sigma_level"]] if jcfg.split
                                    else [])
    grads = torch.autograd.grad(loss, leaves)
    for k, (a, b) in enumerate(zip(grads, jleaves)):
        assert _rel_norm(np32(a), b) <= BF16_TOL, k


def test_unknown_resample_dtype_raises():
    cfg = tpyr.PyramidConfig(resolutions=(8, 16), features=4, rgb_width=16,
                             deferred=True)
    tp = pyramid_params_from_numpy(
        numpy_pyramid_params((8, 16), (4, 4), 16, 2, seed=0))
    pose = look_at(np.array(OBLIQUE["eye"]), np.zeros(3),
                   np.array([0.0, 0.0, 1.0]))
    K = np.array([[14.4, 0, 8], [0, 14.4, 8], [0, 0, 1]], np.float32)
    with pytest.raises(ValueError, match="resample_dtype"):
        tswr.render_swr(tp, tpyr.bake(tp, cfg), cfg, pose, K, (16, 16),
                        n_chunks=4, resample_dtype="float16")
