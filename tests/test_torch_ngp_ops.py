"""Port parity of the NGP path's small ops: config, bit math, rays,
compositing and the distortion loss, each against its JAX counterpart on
the same numpy inputs.  The bit math is bit-exact; rays 1e-6; compositing
rtol 1e-3 / atol 2e-5 (``tests/test_composite.py``) and its gradient 1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import np32, t32

from taichi_nerfs_torch import config as tconfig
from taichi_nerfs_torch.ops import composite as tcomp
from taichi_nerfs_torch.ops import distortion as tdist
from taichi_nerfs_torch.ops import math as tmath
from taichi_nerfs_torch.ops import rays as trays
from taichi_nerfs_tpu.ops import composite as jcomp
from taichi_nerfs_tpu.ops import distortion as jdist
from taichi_nerfs_tpu.ops import math as jmath
from taichi_nerfs_tpu.ops import rays as jrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("argv", [
    [],
    ["--encoder_type", "hash", "--half_opt"],
    ["--scale", "1.0", "--brick_shape", "4x8", "--random_bg",
     "--batch_size", "1024", "--distortion_loss_w", "1e-3"],
    ["--deployment", "--ray_sampling_strategy", "same_image"],
], ids=["defaults", "hash-half", "scale1-4x8", "deployment"])
def test_config_from_opts_matches_opt(argv):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from opt import config_from_opts, get_opts

    hp = get_opts(["--root_dir", "synthetic://sphere"] + argv)
    want = config_from_opts(hp)
    got = tconfig.config_from_opts(hp)
    assert repr(got).replace("taichi_nerfs_torch", "X") == repr(want).replace(
        "taichi_nerfs_tpu", "X")
    assert got.model.cascades == want.model.cascades


def test_flagship_config():
    from taichi_nerfs_tpu import config as jconfig

    for enc in ("brick", "hash"):
        assert repr(tconfig.config_for_scene(0.5, enc)) == repr(
            jconfig.config_for_scene(0.5, enc)).replace(
                "taichi_nerfs_tpu", "taichi_nerfs_torch")
    assert repr(tconfig.deployment_model_config(0.5)) == repr(
        jconfig.deployment_model_config(0.5)).replace(
            "taichi_nerfs_tpu", "taichi_nerfs_torch")


# ------------------------------------------------------------------ math


def test_morton_and_invert_bit_exact():
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 1024, (5000, 3)).astype(np.int32)
    want = np.asarray(jmath.morton3d(jnp.asarray(coords)))
    got = tmath.morton3d(torch.as_tensor(coords)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(tmath.morton3d_np(coords), want)
    codes = rng.integers(0, 2**30, 5000).astype(np.int32)
    np.testing.assert_array_equal(
        tmath.morton3d_invert(torch.as_tensor(codes)).numpy(),
        np.asarray(jmath.morton3d_invert(jnp.asarray(codes))))
    # arbitrary uint32 words (the top bits included) through expand_bits
    words = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        tmath.expand_bits(torch.as_tensor(words.view(np.int32))).numpy(),
        np.asarray(jmath.expand_bits(jnp.asarray(words))).astype(np.int64))


def test_mul_u32_wraps_like_uint32():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, 10000, dtype=np.uint64).astype(np.uint32)
    for p in (1, 2654435761, 805459861, 0xFFFFFFFF):
        want = a * np.uint32(p)  # numpy uint32 wraps
        got = tmath.mul_u32(torch.as_tensor(a.astype(np.int64)), p)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a negative int32 becomes its uint32 value, as the JAX cast does
    neg = torch.tensor([-1, -2, -(2**31)], dtype=torch.int32)
    np.testing.assert_array_equal(
        tmath.as_u32(neg).numpy(),
        np.asarray(jnp.asarray([-1, -2, -(2**31)], jnp.int32).astype(
            jnp.uint32)).astype(np.int64))


def test_frexp_mip_and_calc_dt_bit_exact():
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.uniform(-10, 10, 3000), 2.0 ** rng.integers(-20, 20, 200),
        -(2.0 ** rng.integers(-20, 20, 200)), [0.0, -0.0, 1.0, 0.5],
    ]).astype(np.float32)
    np.testing.assert_array_equal(
        tmath.frexp_exponent(t32(x)).numpy(),
        np.asarray(jmath.frexp_exponent(jnp.asarray(x))))
    xyz = rng.uniform(-3, 3, (3000, 3)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.2, 3000).astype(np.float32)
    for cascades in (1, 3):
        np.testing.assert_array_equal(
            tmath.mip_from_pos(t32(xyz), cascades).numpy(),
            np.asarray(jmath.mip_from_pos(jnp.asarray(xyz), cascades)))
        np.testing.assert_array_equal(
            tmath.mip_from_dt(t32(dt), 128, cascades).numpy(),
            np.asarray(jmath.mip_from_dt(jnp.asarray(dt), 128, cascades)))
    t = rng.uniform(0, 4, 3000).astype(np.float32)
    for f in (0.0, 1 / 256):
        np.testing.assert_array_equal(
            tmath.calc_dt(t32(t), f, 128, 1.0).numpy(),
            np.asarray(jmath.calc_dt(jnp.asarray(t), f, 128, 1.0)))


def test_bitfield_bit_exact_including_bit_31():
    rng = np.random.default_rng(3)
    dens = rng.uniform(0, 1, 32 * 64).astype(np.float32)
    dens[31] = 0.9  # word 0, bit 31: the sign bit of the int32 word
    dens[0:31] = 0.1
    want = np.asarray(jmath.packbits_u32(jnp.asarray(dens), 0.5))
    got = tmath.packbits_u32(t32(dens), 0.5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert int(got[0]) < 0 and want[0] == 2**31  # only bit 31 of word 0
    idx = np.concatenate([[31, 30, 0], rng.integers(0, dens.size, 3000)])
    np.testing.assert_array_equal(
        tmath.bitfield_test(got, torch.as_tensor(idx)).numpy(),
        np.asarray(jmath.bitfield_test(jnp.asarray(want), jnp.asarray(idx))))
    assert bool(tmath.bitfield_test(got, torch.tensor([31]))[0])
    assert not bool(tmath.bitfield_test(got, torch.tensor([30]))[0])
    np.testing.assert_array_equal(
        tmath.bitfield_to_u8(got).numpy(),
        np.asarray(jmath.bitfield_to_u8(jnp.asarray(want))))


def test_grid_coords():
    np.testing.assert_array_equal(tmath.grid_coords(8).numpy(),
                                  np.asarray(jmath.grid_coords(8)))
    np.testing.assert_array_equal(tmath.grid_coords_np(8),
                                  jmath.grid_coords_np(8))


# ------------------------------------------------------------------ rays


def test_ray_directions_and_rays():
    K = np.array([[40.0, 0, 15.5], [0, 42.0, 12.0], [0, 0, 1]], np.float32)
    want = np.asarray(jrays.get_ray_directions(24, 32, K))
    np.testing.assert_allclose(np32(trays.get_ray_directions(24, 32, K)),
                               want, atol=1e-6)
    np.testing.assert_allclose(trays.get_ray_directions_np(24, 32, K),
                               jrays.get_ray_directions_np(24, 32, K),
                               atol=1e-6)
    d, uv = trays.get_ray_directions(24, 32, K, flatten=False,
                                     return_uv=True)
    jd, juv = jrays.get_ray_directions(24, 32, K, flatten=False,
                                       return_uv=True)
    np.testing.assert_allclose(np32(d), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(np32(uv), np.asarray(juv))
    rng = np.random.default_rng(4)
    dirs = rng.normal(size=(500, 3)).astype(np.float32)
    pose = rng.normal(size=(3, 4)).astype(np.float32)
    poses = rng.normal(size=(500, 3, 4)).astype(np.float32)
    for c2w in (pose, poses):
        o, dd = trays.get_rays(t32(dirs), t32(c2w))
        jo, jdd = jrays.get_rays(jnp.asarray(dirs), jnp.asarray(c2w))
        np.testing.assert_allclose(np32(o), np.asarray(jo), atol=1e-6)
        np.testing.assert_allclose(np32(dd), np.asarray(jdd), atol=1e-6)


def test_axisangle_and_aabb():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(np32(trays.axisangle_to_R(t32(v))),
                               np.asarray(jrays.axisangle_to_R(
                                   jnp.asarray(v))), atol=1e-6)
    np.testing.assert_allclose(np32(trays.axisangle_to_R(t32(v[0]))),
                               np.asarray(jrays.axisangle_to_R(
                                   jnp.asarray(v[0]))), atol=1e-6)
    o = rng.uniform(-1.5, 1.5, (2000, 3)).astype(np.float32)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np32(trays.ray_aabb_intersect(t32(o), t32(d), 0.5)),
        np.asarray(jrays.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d),
                                            0.5)), atol=1e-6)


def test_pose_helpers():
    rng = np.random.default_rng(6)
    poses = rng.normal(size=(6, 3, 4))
    pts = rng.normal(size=(20, 3))
    for a, b in zip(trays.center_poses(poses, pts),
                    jrays.center_poses(poses, pts)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(trays.create_spheric_poses(1.2, 0.1, 7),
                               jrays.create_spheric_poses(1.2, 0.1, 7),
                               atol=1e-6)


# ------------------------------------------------------------------ composite


def _composite_inputs(seed=7, n=64, s=48):
    rng = np.random.default_rng(seed)
    sig = rng.uniform(0, 30, (n, s)).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, s, 3)).astype(np.float32)
    deltas = rng.uniform(0.001, 0.02, (n, s)).astype(np.float32)
    ts = np.cumsum(deltas, axis=1).astype(np.float32)
    counts = rng.integers(0, s + 1, n)
    valid = np.arange(s)[None, :] < counts[:, None]
    return sig, rgb, deltas, ts, valid


def test_composite_train_and_grad():
    sig, rgb, deltas, ts, valid = _composite_inputs()
    j = jcomp.composite_train(*(jnp.asarray(a) for a in
                                (sig, rgb, deltas, ts, valid)), 1e-4)
    tsig, trgb = t32(sig).requires_grad_(), t32(rgb).requires_grad_()
    t = tcomp.composite_train(tsig, trgb, t32(deltas), t32(ts),
                              torch.as_tensor(valid), 1e-4)
    for name in ("opacity", "depth", "rgb", "ws"):
        np.testing.assert_allclose(np32(getattr(t, name)),
                                   np.asarray(getattr(j, name)),
                                   rtol=1e-3, atol=2e-5)
    assert int(t.vr_samples) == int(j.vr_samples)
    bg = np.array([0.2, 0.7, 1.0], np.float32)
    rng = np.random.default_rng(8)
    gt = rng.uniform(0, 1, (sig.shape[0], 3)).astype(np.float32)

    def jloss(s_, c_):
        r = jcomp.composite_train(s_, c_, jnp.asarray(deltas),
                                  jnp.asarray(ts), jnp.asarray(valid), 1e-4)
        out = jcomp.apply_background(r.rgb, r.opacity, jnp.asarray(bg))
        return jnp.mean((out - gt) ** 2) + jnp.mean(r.depth)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(sig), jnp.asarray(rgb))
    out = tcomp.apply_background(t.rgb, t.opacity, t32(bg))
    loss = torch.mean((out - t32(gt)) ** 2) + torch.mean(t.depth)
    tg = torch.autograd.grad(loss, (tsig, trgb))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(np32(a), np.asarray(b), rtol=0, atol=1e-5)


def test_composite_test_round():
    sig, rgb, deltas, ts, valid = _composite_inputs(seed=9)
    rng = np.random.default_rng(10)
    state = [rng.uniform(0, 0.9, 64).astype(np.float32),
             rng.uniform(0, 2, 64).astype(np.float32),
             rng.uniform(0, 1, (64, 3)).astype(np.float32)]
    j = jcomp.composite_test_round(
        *(jnp.asarray(a) for a in (sig, rgb, deltas, ts, valid)), 1e-4,
        *(jnp.asarray(a) for a in state))
    t = tcomp.composite_test_round(
        t32(sig), t32(rgb), t32(deltas), t32(ts), torch.as_tensor(valid),
        1e-4, *(t32(a) for a in state))
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_allclose(np32(a), np.asarray(b), rtol=1e-3,
                                   atol=2e-5)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


def test_distortion_loss_and_grad():
    sig, _, deltas, ts, valid = _composite_inputs(seed=11)
    rng = np.random.default_rng(12)
    ws = rng.uniform(0, 0.2, sig.shape).astype(np.float32)

    def jf(w):
        return jnp.sum(jdist.distortion_loss(w, jnp.asarray(deltas),
                                             jnp.asarray(ts),
                                             jnp.asarray(valid)))

    tw = t32(ws).requires_grad_()
    tl = tdist.distortion_loss(tw, t32(deltas), t32(ts),
                               torch.as_tensor(valid))
    np.testing.assert_allclose(
        np32(tl), np.asarray(jdist.distortion_loss(
            jnp.asarray(ws), jnp.asarray(deltas), jnp.asarray(ts),
            jnp.asarray(valid))), rtol=1e-5, atol=1e-7)
    (g,) = torch.autograd.grad(tl.sum(), tw)
    np.testing.assert_allclose(np32(g), np.asarray(jax.grad(jf)(
        jnp.asarray(ws))), rtol=1e-5, atol=1e-6)
