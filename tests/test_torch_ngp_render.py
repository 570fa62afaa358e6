"""Port parity of the NGP renderer, the training step and its pieces.

At a tiny configuration (grid 32^3, 4 hash, brick or tri-plane levels,
16-wide fp32 MLPs; or the svox grid of ``tests/test_voxel_grid.py``), from
identical params, bitfield and draws (the JAX draws reproduced from the JAX
functions' own key splits):

* ``render_train``, dense and packed with a ``pack_cap`` below the valid
  count (so truncation runs): rgb, depth and opacity to 1e-5, every
  parameter leaf's gradient to 1e-4 relative norm;
* ``render_image``: rgb to 1e-4, ``total_samples`` equal;
* one ``train_step``: loss to 1e-5 relative, each updated leaf to 1e-5
  relative norm, ``rm_samples`` equal;
* the shared Adam against ``optax.adam`` on ``cosine_decay_schedule`` for
  5 steps (1e-6), the dataset's camera directions (1e-6), and the model
  file (the JAX ``utils/checkpoint.py`` file, read and written by both
  packages; one step resumed from it in each, to the one-step tolerances).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import np32, t32

from taichi_nerfs_torch import config as tconfig
from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset as TDS
from taichi_nerfs_torch.render import renderer as trend
from taichi_nerfs_torch.train import state as tstate
from taichi_nerfs_torch.train import step as tstep
from taichi_nerfs_torch.utils import convert as tconv
from taichi_nerfs_tpu import config as jconfig
from taichi_nerfs_tpu.data.synthetic import SyntheticSphereDataset as JDS
from taichi_nerfs_tpu.data.synthetic import look_at
from taichi_nerfs_tpu.models.registry import get_model as jget_model
from taichi_nerfs_tpu.ops.math import packbits_u32
from taichi_nerfs_tpu.ops.rays import get_ray_directions, get_rays
from taichi_nerfs_tpu.render import renderer as jrend
from taichi_nerfs_tpu.train import state as jstate
from taichi_nerfs_tpu.train import step as jstep


def _configs(enc="hash", random_bg=False, batch=256):
    """Port and JAX configs of the tiny model with encoder ``enc``; ``enc
    == "svox"``: the svox family (grid 48, radius 1.05 / 48, SH degree
    1)."""
    m = dict(scale=0.5, pos_encoder_type=enc, grid_size=32, xyz_net_width=16,
             rgb_net_width=16, mlp_dtype="float32")
    if enc == "svox":
        m.update(name="svox", pos_encoder_type="hash", voxel_grid_size=48,
                 voxel_radius=1.05 / 48, voxel_sh_degree=1)
    hk = dict(levels=4, feature_per_level=2, log2_T=11, base_res=4,
              max_res=32)
    bk = dict(levels=4, feature_per_level=4, log2_rows=9, base_res=4,
              max_res=32)
    pk = dict(levels=4, feature_per_level=2, base_res=4, max_res=32)
    r = dict(exp_step_factor=0.0, train_sample_cap=256, test_chunk_samples=16,
             white_bg=True, random_bg=random_bg)
    t = dict(batch_size=batch, max_steps=200, warmup_steps=40,
             update_interval=8)
    out = []
    for c in (tconfig, jconfig):
        out.append(c.Config(
            model=c.ModelConfig(grid=c.HashGridConfig(**hk),
                                brick=c.BrickGridConfig(**bk),
                                triplane=c.TriPlaneConfig(**pk), **m),
            render=c.RenderConfig(**r), train=c.TrainConfig(**t)))
    return out


def _ball_bitfield(g=32, seed=0):
    """Occupied: a noisy ball of radius ~0.3 (morton order)."""
    from taichi_nerfs_tpu.ops.math import grid_coords_np, morton3d_np

    rng = np.random.default_rng(seed)
    c = grid_coords_np(g)
    centers = ((c + 0.5) / g * 2 - 1) * 0.5
    occ = (np.linalg.norm(centers, axis=1) < 0.3) | (rng.uniform(size=g**3)
                                                      < 0.02)
    dens = np.zeros(g**3, np.float32)
    dens[morton3d_np(c)] = occ
    words = np.asarray(packbits_u32(jnp.asarray(dens), 0.5))
    return words, torch.tensor(words.view(np.int32))


def _camera_rays(w=24, h=24, eye=(0.9, 0.7, 0.6)):
    K = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]],
                 np.float32)
    pose = look_at(np.array(eye), np.zeros(3),
                   np.array([0.0, 0.0, 1.0])).astype(np.float32)
    o, d = get_rays(get_ray_directions(h, w, K), jnp.asarray(pose))
    return np.asarray(o), np.asarray(d)


def _params(jcfg, seed=1):
    jp = jget_model(jcfg.model.name).init_params(jax.random.PRNGKey(seed),
                                                 jcfg.model)
    return jp, tstate.trainable(tconv.ngp_params_from_numpy(
        jax.device_get(jp)))


def _rel(a, b):
    a, b = np32(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("enc,pack,random_bg", [
    ("hash", None, False), ("hash", "trunc", True), ("brick", None, False),
    ("brick", "trunc", False),
], ids=["hash-dense", "hash-packed-trunc-randbg", "brick-dense",
        "brick-packed-trunc"])
def test_render_train_and_grads(enc, pack, random_bg):
    tcfg, jcfg = _configs(enc, random_bg)
    jp, tp = _params(jcfg)
    words, bf = _ball_bitfield()
    o, d = _camera_rays()
    n = o.shape[0]
    key = jax.random.PRNGKey(5)
    noise = np.random.default_rng(3).uniform(size=n).astype(np.float32)
    _, k_bg = jax.random.split(key)
    bg = t32(jax.random.uniform(k_bg, (3,))) if random_bg else None
    cap = 128
    # the valid count at this cap, to put pack_cap below it
    probe = trend.render_train(tp, tcfg.model, tcfg.render, bf, t32(o),
                               t32(d), cap, t_noise=t32(noise), bg=bg)
    n_valid = int(probe["rm_samples"])
    pack_cap = None if pack is None else int(0.8 * n_valid)
    assert n_valid > 1000

    def jloss(p):
        r = jrend.render_train(p, jcfg.model, jcfg.render, jnp.asarray(words),
                               jnp.asarray(o), jnp.asarray(d), key, cap,
                               pack_cap, t_noise=jnp.asarray(noise))
        return jnp.mean(r["rgb"] ** 2) + jnp.mean(r["depth"]), r

    (_, jr), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tr = trend.render_train(tp, tcfg.model, tcfg.render, bf, t32(o), t32(d),
                            cap, pack_cap, t_noise=t32(noise), bg=bg)
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_allclose(np32(tr[k]), np.asarray(jr[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tr["counts"].numpy(),
                                  np.asarray(jr["counts"]))
    assert int(tr["vr_samples"]) == int(jr["vr_samples"])
    loss = torch.mean(tr["rgb"] ** 2) + torch.mean(tr["depth"])
    leaves = tstate.tree_leaves(tp)
    tg = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(tg, jleaves):
        assert _rel(a, b) <= 1e-4
    if pack is not None:  # truncation ran: samples past the cap are dropped
        dense = trend.render_train(tp, tcfg.model, tcfg.render, bf, t32(o),
                                   t32(d), cap, None, t_noise=t32(noise),
                                   bg=bg)
        gap = torch.abs(dense["opacity"] - tr["opacity"]).detach()
        assert float(gap.max()) > 1e-3


def test_pack_indices_match_nonzero():
    rng = np.random.default_rng(4)
    valid = rng.uniform(size=(50, 40)) < 0.3
    for cap in (10, int(valid.sum()), 2 * int(valid.sum())):
        (want,) = jnp.nonzero(jnp.asarray(valid).reshape(-1), size=cap,
                              fill_value=valid.size)
        got = trend.pack_indices(torch.as_tensor(valid), cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("enc", ["hash", "brick", "triplane"])
def test_render_image(enc):
    tcfg, jcfg = _configs(enc)
    jp, tp = _params(jcfg, seed=2)
    words, bf = _ball_bitfield(seed=1)
    o, d = _camera_rays(w=20, h=16, eye=(0.2, -1.1, 0.4))
    j = jrend.render_image(jp, jcfg, jnp.asarray(words), jnp.asarray(o),
                           jnp.asarray(d), chunk=128)
    t = trend.render_image(tp, tcfg, bf, t32(o), t32(d), chunk=128)
    np.testing.assert_allclose(np32(t["rgb"]), np.asarray(j["rgb"]), rtol=0,
                               atol=1e-4)
    assert int(t["total_samples"]) == int(j["total_samples"])
    assert t["host_reads"] >= t["rounds"] > 0


def _jax_draws(jst, jcfg, random_bg, n_img=3, n_pix=16 * 16):
    """The JAX train step's draws from ``jst.rng``, from its own key
    splits, as the port's ``StepDraws``."""
    _, k_batch, k_render = jax.random.split(jst.rng, 3)
    k_img, k_pix = jax.random.split(k_batch)
    B = jcfg.train.batch_size
    img = jax.random.randint(k_img, (B,), 0, n_img)
    pix = jax.random.randint(k_pix, (B,), 0, n_pix)
    k_noise, k_bg = jax.random.split(k_render)
    noise = jax.random.uniform(k_noise, (B,))
    bg = t32(jax.random.uniform(k_bg, (3,))) if random_bg else None
    return tstep.StepDraws(torch.tensor(np.asarray(img)).long(),
                           torch.tensor(np.asarray(pix)).long(),
                           t32(noise), bg)


def _jax_state(jcfg, jp, words):
    jst = jstate.create_train_state(jcfg)
    return jst._replace(params=jp, opt_state=jstate.make_optimizer(
        jcfg).init(jp), occupancy=jst.occupancy._replace(
            bitfield=jnp.asarray(words)))


def _assert_same_step(tnew, tm, jnew, jm):
    """One port step against one JAX step: the tolerances of
    ``test_one_train_step``."""
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    assert int(tm["rm_samples"]) == int(jm["rm_samples"])
    assert int(tm["counts_max"]) == int(jm["counts_max"])
    for a, b in zip(tstate.tree_leaves(tnew.params),
                    jax.tree_util.tree_leaves(jnew.params)):
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("enc", ["hash", "brick", "triplane"])
def test_one_train_step(enc):
    tcfg, jcfg = _configs(enc, random_bg=(enc == "hash"))
    scene = JDS(n_images=3, img_wh=(16, 16))
    jp, tp = _params(jcfg, seed=3)
    words, bf = _ball_bitfield(seed=2)
    jst = _jax_state(jcfg, jp, words)
    draws = _jax_draws(jst, jcfg, random_bg=(enc == "hash"))
    pack_cap = 4096
    jnew, jm = jstep.train_step(jst, scene.as_batch(), jcfg, 128, pack_cap)
    occ = tconv.occupancy_from_numpy(np.zeros((1, 32**3)),
                                     np.zeros((1, 32**3)), words)
    ts = tstate.TrainState(tp, tstate.make_optimizer(tcfg).init(tp), occ)
    data = tstep.Batch(t32(scene.rays), t32(scene.poses),
                       t32(scene.directions))
    tnew, tm = tstep.train_step(ts, data, tcfg, 128, pack_cap, draws)
    _assert_same_step(tnew, tm, jnew, jm)
    assert tnew.opt_state.count == 1


def test_adam_matches_optax_cosine():
    """5 steps of the shared Adam against optax.adam on the JAX package's
    cosine schedule, on an NGP-shaped tree."""
    tcfg, jcfg = (c.replace(train=dataclasses.replace(c.train, max_steps=4))
                  for c in _configs("brick"))
    jp, _ = _params(jcfg)
    tp = tstate.trainable(tconv.ngp_params_from_numpy(jax.device_get(jp)))
    opt = jstate.make_optimizer(jcfg)
    js = opt.init(jp)
    topt = tstate.make_optimizer(tcfg)
    assert (topt.final_ratio, topt.eps) == (1 / 30, 1e-15)
    ts = topt.init(tp)
    rng = np.random.default_rng(0)
    for _ in range(5):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32),
            jax.device_get(jp))
        u, js = opt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        ts = topt.update(tconv.ngp_params_from_numpy(g), ts, tp)
    for a, b in zip(tstate.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(np32(a), np.asarray(b), rtol=0, atol=1e-6)
    assert ts.count == ts.sched_count == 5


def test_dataset_directions_and_batch():
    t = TDS(n_images=2, img_wh=(20, 16))
    j = JDS(n_images=2, img_wh=(20, 16))
    np.testing.assert_allclose(t.directions, j.directions, rtol=0, atol=1e-6)
    b = t.as_batch()
    assert tuple(b.rays.shape) == (2, 320, 3)
    assert tuple(b.directions.shape) == (320, 3)
    np.testing.assert_allclose(b.poses.numpy(), np.asarray(j.poses),
                               atol=1e-6)
    assert "rgb" in t[0] and len(t) == 2


def test_model_file_roundtrip(tmp_path):
    """The JAX checkpoint's params, optimizer state and occupancy load into
    the port; the port's model.npz round-trips with every key of the JAX
    file, each of the same shape and type."""
    from taichi_nerfs_tpu.utils.checkpoint import save_checkpoint

    _, jcfg = _configs("brick")
    jst = jstate.create_train_state(jcfg)
    words, _ = _ball_bitfield()
    jst = jst._replace(occupancy=jst.occupancy._replace(
        bitfield=jnp.asarray(words),
        density_grid=jnp.full_like(jst.occupancy.density_grid, 0.25)))
    path = os.path.join(tmp_path, "model.npz")
    save_checkpoint(path, jst, 7)
    params, occ, step, opt = tconv.load_ngp_npz(path)
    assert step == 7
    for a, b in zip(tstate.tree_leaves(params),
                    jax.tree_util.tree_leaves(jst.params)):
        np.testing.assert_array_equal(np32(a), np.asarray(b))
    np.testing.assert_array_equal(occ.bitfield.numpy().view(np.uint32),
                                  words)
    assert occ.bitfield.dtype == torch.int32
    out = os.path.join(tmp_path, "port.npz")
    tconv.save_ngp_npz(out, tstate.TrainState(params, opt, occ), step=9,
                       seed=jcfg.train.seed)
    with np.load(path) as a, np.load(out) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
            if k not in ("__step__", "rng"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert int(b["__step__"]) == 9
        # the key of jax.random.PRNGKey(seed): the port's draws are torch's
        np.testing.assert_array_equal(b["rng"], [0, jcfg.train.seed])
        assert b["occ/bitfield"].dtype == np.uint32


def _trained_jax_state(jcfg, steps=2):
    """A JAX train state after ``steps`` steps of ``train_step`` on a tiny
    scene (nonzero moments, counts ``steps``), with the scene."""
    scene = JDS(n_images=3, img_wh=(16, 16))
    jp, _ = _params(jcfg, seed=3)
    words, _ = _ball_bitfield(seed=2)
    jst = _jax_state(jcfg, jp, words)
    for _ in range(steps):
        jst, _ = jstep.train_step(jst, scene.as_batch(), jcfg, 128, 4096)
    return jst, scene


@pytest.mark.parametrize("enc", ["hash", "triplane", "svox"])
def test_jax_loads_port_model_file(enc, tmp_path):
    """A model.npz the port writes loads in the JAX ``load_checkpoint``
    into ``create_train_state``'s template, with the port's params,
    moments and counts: for the tri-plane table and svox's fields too."""
    from taichi_nerfs_tpu.utils.checkpoint import load_checkpoint

    tcfg, jcfg = _configs(enc)
    jst, _ = _trained_jax_state(jcfg)
    mu, nu = (tconv.ngp_params_from_numpy(jax.device_get(x))
              for x in (jst.opt_state[0].mu, jst.opt_state[0].nu))
    ts = tstate.TrainState(
        tstate.trainable(tconv.ngp_params_from_numpy(
            jax.device_get(jst.params))),
        tstate.AdamState(2, 5, mu, nu),
        tconv.occupancy_from_numpy(*(np.asarray(x) for x in (
            jst.occupancy.density_grid, jst.occupancy.count_grid,
            jst.occupancy.bitfield))))
    path = os.path.join(tmp_path, "model.npz")
    tconv.save_ngp_npz(path, ts, step=5, seed=tcfg.train.seed)
    loaded, step = load_checkpoint(path, jstate.create_train_state(jcfg))
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(loaded.params),
                    jax.tree_util.tree_leaves(jst.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    adam, sched = loaded.opt_state
    assert (int(adam.count), int(sched.count)) == (2, 5)
    for a, b in zip(jax.tree_util.tree_leaves((adam.mu, adam.nu)),
                    jax.tree_util.tree_leaves((jst.opt_state[0].mu,
                                               jst.opt_state[0].nu))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(loaded.occupancy.bitfield),
                                  np.asarray(jst.occupancy.bitfield))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(loaded.rng)), [0, tcfg.train.seed])


@pytest.mark.parametrize("enc", ["hash", "brick", "triplane"])
def test_resumed_step_matches_jax(enc, tmp_path):
    """A port resume of a JAX-written model.npz carries Adam's moments and
    both counts, and one resumed port step equals one resumed JAX step on
    the same draws (the tolerances of ``test_one_train_step``)."""
    from taichi_nerfs_tpu.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    tcfg, jcfg = _configs(enc, random_bg=(enc == "hash"))
    jst, scene = _trained_jax_state(jcfg)
    path = os.path.join(tmp_path, "model.npz")
    save_checkpoint(path, jst, 2)
    jres, _ = load_checkpoint(path, jstate.create_train_state(jcfg))
    params, occ, step, opt = tconv.load_ngp_npz(path)
    assert step == 2 and (opt.count, opt.sched_count) == (2, 2)
    for a, b in zip(tstate.tree_leaves((opt.mu, opt.nu)),
                    jax.tree_util.tree_leaves((jst.opt_state[0].mu,
                                               jst.opt_state[0].nu))):
        np.testing.assert_array_equal(np32(a), np.asarray(b))
    assert float(max(np.abs(np32(x)).max()
                     for x in tstate.tree_leaves(opt.nu))) > 0
    ts = tstate.TrainState(tstate.trainable(params), opt, occ)
    draws = _jax_draws(jres, jcfg, random_bg=(enc == "hash"))
    jnew, jm = jstep.train_step(jres, scene.as_batch(), jcfg, 128, 4096)
    data = tstep.Batch(t32(scene.rays), t32(scene.poses),
                       t32(scene.directions))
    tnew, tm = tstep.train_step(ts, data, tcfg, 128, 4096, draws)
    _assert_same_step(tnew, tm, jnew, jm)
    assert (tnew.opt_state.count, tnew.opt_state.sched_count) == (3, 3)
