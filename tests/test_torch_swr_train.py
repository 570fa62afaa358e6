"""Port parity: the training slice (loss, Adam, data, trainer, entry point).

* ``make_swr_loss`` against the JAX package's, with identical params, crop,
  random background and TV window, the JAX sweep in Pallas interpret mode:
  loss within 1e-5 relative, per-level gradients within a relative norm of
  2e-4 (the render parity tolerance; the rgb MLP's bf16 operand rounding is
  the largest difference between the two).
* The hand-written Adam against the JAX optimizer fed the same gradients
  across a ``grow_swr_state`` and a light resume: params and moments within
  1e-6.
* The synthetic ground truth against the JAX package's at 32^2.
* Port counterparts of ``tests/test_swr_train.py``'s training tests, in
  cubic (the record recipe's kind; linear and the slab scan's options are
  in ``tests/test_torch_swr_scan.py``), the npz round trip through both
  packages, save/load state, and ``python -m taichi_nerfs_torch.train``.
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
from taichi_nerfs_torch.train import swr_step as tst
from taichi_nerfs_torch.train.metrics import psnr as t_psnr
from taichi_nerfs_torch.utils.convert import (
    load_pyramid_npz,
    pyramid_params_from_numpy,
    save_pyramid_npz,
)
from taichi_nerfs_tpu.data import synthetic as jsyn
from taichi_nerfs_tpu.models import pyramid as jpyr
from taichi_nerfs_tpu.train import swr_step as jst

SMALL = dict(resolutions=(8, 16), features=4, rgb_width=16, scale=0.5,
             deferred=True)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def sphere():
    return tsyn.SyntheticSphereDataset(n_images=8, img_wh=(32, 32))


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("random_bg", [True, False], ids=["random_bg",
                                                          "white_bg"])
def test_loss_and_grads_match_jax(random_bg):
    res = (8, 16, 32)
    tree = numpy_pyramid_params(res, (4, 4, 4), 16, 2, seed=5, blob=3.0)
    cfg_kw = dict(resolutions=res, features=4, rgb_width=16, scale=0.5,
                  sigma_bias=-1.0, deferred=True)
    jm, tm = jpyr.PyramidConfig(**cfg_kw), tpyr.PyramidConfig(**cfg_kw)
    common = dict(crop=24, n_chunks=8, tv_w=5e-3, sigma_l1=1e-3,
                  alpha_w=0.2, random_bg=random_bg, resample_kind="cubic")
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
    k_tv = jax.random.PRNGKey(3)
    # the JAX loss's own random draws, handed to the port as arguments
    bg = np.asarray(jax.random.uniform(jax.random.fold_in(k_tv, 17),
                                       (24 * 24, 3)))
    rf = res[-1]
    s0 = int(jax.random.randint(jax.random.fold_in(k_tv, 0), (), 0,
                                rf - tst.tv_window(rf) + 1))
    jloss = jst.make_swr_loss(
        jnp.asarray(img), jnp.asarray(pose), jnp.asarray(K),
        jnp.asarray(crop_xy, jnp.int32), k_tv, jm, jc, axis, flip,
        lat_size=lat,
    )
    (jl, jmse), jg = jax.value_and_grad(jloss, has_aux=True)(jax_tree(tree))
    params = tst._trainable(pyramid_params_from_numpy(tree))
    tloss = tst.make_swr_loss(
        torch.as_tensor(img), pose, K, crop_xy, tm, tc, axis, flip,
        bg=t32(bg) if random_bg else None, tv_starts=(s0,), lat_size=lat,
    )
    tl, tmse = tloss(params)
    grads = torch.autograd.grad(tl, tst.tree_leaves(params))
    tl, tmse = float(tl.detach()), float(tmse.detach())
    assert abs(tl - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(tmse - float(jmse)) <= 1e-5 * abs(float(jmse))
    for lv, (a, b) in enumerate(zip(grads, jg["levels"])):
        assert _rel_norm(np32(a), b) <= 2e-4, lv
    assert float(np.abs(np.asarray(jg["levels"][-1])).max()) > 0


# ------------------------------------------------------------------ adam


def test_adam_matches_jax_across_growth_and_light_resume():
    """Same gradient sequence into both optimizers: 3 steps, grow from 2 to
    3 levels (the new level copied across), 3 steps, a light resume (Adam
    restarts at count 0, the schedule keeps its count), 3 steps."""
    full = jpyr.PyramidConfig(resolutions=(4, 8, 16), features=4,
                              rgb_width=8, deferred=True)
    tcfg_kw = dict(lr=3e-2, max_steps=12, resample_kind="cubic")
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
        pairs = [(tp, jp), (ts_.mu, adam.mu), (ts_.nu, adam.nu)]
        for t_tree, j_tree in pairs:
            for a, b in zip(tst.tree_leaves(t_tree),
                            jax.tree_util.tree_leaves(j_tree)):
                np.testing.assert_allclose(np32(a), np.asarray(b), rtol=0,
                                           atol=1e-6)
        assert ts_.count == int(adam.count)
        assert ts_.sched_count == int(js[1].count)

    jp, js, ts_ = steps(3, jp, js, ts_)
    check(jp, js, ts_)
    # growth from 2 to 3 levels: the JAX package inits the new level from
    # its key; the port's new level takes the same values
    jst_state = jst.grow_swr_state(jst.SwrTrainState(jp, js, None), full, jc,
                                   jax.random.PRNGKey(1))
    jp, js = jst_state.params, jst_state.opt_state
    tstate = tst.grow_swr_state(tst.SwrTrainState(tp, ts_),
                                tpyr.PyramidConfig(**dataclasses.asdict(full)),
                                tc)
    with torch.no_grad():
        tstate.params["levels"][2].copy_(t32(jp["levels"][2]))
    tp, ts_ = tstate.params, tstate.opt_state
    assert len(tp["levels"]) == 3 and ts_.count == 3
    jp, js, ts_ = steps(3, jp, js, ts_)
    check(jp, js, ts_)
    # light resume, as both trainers' load_state build it
    js = jopt.init(jp)
    js = (js[0], js[1]._replace(count=jnp.asarray(6, jnp.int32)))
    ts_ = topt.init(tp, sched_count=6)
    jp, js, ts_ = steps(3, jp, js, ts_)
    check(jp, js, ts_)
    assert ts_.count == 3 and ts_.sched_count == 9


# ------------------------------------------------------------------ data


@pytest.mark.parametrize(
    "kw",
    [dict(n_images=3, img_wh=(32, 32)),
     dict(root_dir="synthetic://lego?views=2&res=32")],
    ids=["sphere", "lego"],
)
def test_synthetic_gt_matches_jax(tmp_path, kw):
    """Poses, GT rgb and GT alpha at 32^2; 1e-4: both integrate in fp32
    with their own exp/sqrt (measured differences are ~1e-5 at most)."""
    got = tsyn.SyntheticSphereDataset(**kw)
    want = jsyn.SyntheticSphereDataset(cache_dir=str(tmp_path), **kw)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.K, want.K)
    np.testing.assert_allclose(got.rays, want.rays, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.alphas, want.alphas, rtol=0, atol=1e-4)
    assert 0.05 < got.alphas.mean() < 0.95
    np.testing.assert_array_equal(got[1]["rgb"], got.rays[1])


@pytest.mark.parametrize(
    "spec",
    ["", "lego", "synthetic://checker?views=7&res=48",
     "synthetic://lego?views=100&res=800&radius=1.15&steps=512",
     "/data/nsvf/Synthetic_NeRF/Lego", "synthetic://unknown"],
)
def test_spec_parser_matches_jax(spec):
    assert tsyn.parse_synthetic_spec(spec) == jsyn._parse_synthetic_spec(spec)


def test_synthetic_test_split_and_inside_rig():
    te = tsyn.SyntheticSphereDataset("synthetic://checker?views=40&res=16",
                                     split="test")
    assert len(te) == 10 and te.img_wh == (16, 16)
    # the shell's rig sits inside the grid (its GT is held to JAX's in
    # tests/test_torch_swr_inside_train.py)
    shell = tsyn.SyntheticSphereDataset("synthetic://shell?views=2&res=16")
    assert all(tst.is_inside(p, 0.5) for p in shell.poses)


# ------------------------------------------------------------------ trainer


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


def test_swr_training_improves(sphere):
    trainer = _trainer(sphere)
    first = None
    for _ in range(40):
        m = trainer.run_step()
        if first is None:
            first = float(m["loss"])
    last_psnr = float(m["psnr"])
    first_psnr = -10 * np.log10(first)
    assert last_psnr > first_psnr + 4, (first_psnr, last_psnr)
    out = trainer.render(sphere.poses[0])
    rgb = np32(out["rgb"]).reshape(32, 32, 3)
    gt = sphere.rays[0].reshape(32, 32, 3)
    assert -10 * np.log10(np.mean((rgb - gt) ** 2) + 1e-12) > 14


def test_swr_progressive_training(sphere):
    trainer = _trainer(sphere, mcfg=dict(resolutions=(8, 16, 32)),
                       prog_steps=(8, 8))
    assert len(trainer.state.params["levels"]) == 1
    first, seen = None, set()
    for _ in range(40):
        m = trainer.run_step()
        seen.add(len(trainer.state.params["levels"]))
        if first is None:
            first = float(m["loss"])
    assert seen == {1, 2, 3}
    # one Adam count and one schedule count span all phases
    assert trainer.state.opt_state.count == 40
    assert trainer.state.opt_state.sched_count == 40
    assert float(m["psnr"]) > -10 * np.log10(first) + 4
    assert np.isfinite(np32(trainer.render(sphere.poses[0])["rgb"])).all()


def test_swr_quality_floor_cpu():
    """The record recipe (cubic, alpha 0.2, random bg, TV 5e-4) at the
    scale of the JAX package's test_swr_quality_floor_cpu, same 17.3 dB
    floor over 2 held-out views (19.4 dB measured on the CPU)."""
    spec = "synthetic://lego?views=16&res=64"
    tr_ds = tsyn.SyntheticSphereDataset(spec, split="train")
    trainer = tst.SwrTrainer(
        tpyr.PyramidConfig(resolutions=(16, 32), features=8, deferred=True),
        tst.SwrTrainConfig(crop=64, lr=2e-2, max_steps=300, n_chunks=8,
                           tv_w=5e-4, alpha_w=0.2, random_bg=True,
                           resample_kind="cubic"),
        tr_ds.rays, tr_ds.poses, tr_ds.K, tr_ds.img_wh, alphas=tr_ds.alphas,
        device="cpu",
    )
    for _ in range(300):
        trainer.run_step()
    te = tsyn.SyntheticSphereDataset(spec, split="test")
    w, h = te.img_wh
    ps = [float(t_psnr(trainer.render(te[i]["pose"], img_wh=(w, h))["rgb"],
                       t32(te[i]["rgb"]))) for i in range(2)]
    assert np.all(np.isfinite(ps)), ps
    assert np.mean(ps) > 17.3, ps


def test_npz_round_trip_through_both_packages(sphere, tmp_path):
    tr = _trainer(sphere, max_steps=10, prog_steps=(3,))
    for _ in range(10):
        tr.run_step()
    path = str(tmp_path / "model_pyramid.npz")
    save_pyramid_npz(path, tr.state.params)
    # the port reads it back exactly, and a fresh trainer jumps to full depth
    back = load_pyramid_npz(path)
    for a, b in zip(tst.tree_leaves(back), tst.tree_leaves(tr.state.params)):
        assert torch.equal(a, b.detach())
    tr2 = _trainer(sphere, max_steps=10, prog_steps=(3,))
    assert len(tr2.state.params["levels"]) == 1
    tr2.load_npz(path)
    assert len(tr2.state.params["levels"]) == 2
    np.testing.assert_array_equal(np32(tr2.render(sphere.poses[0])["rgb"]),
                                  np32(tr.render(sphere.poses[0])["rgb"]))
    # the JAX trainer reads it too
    jtr = jst.SwrTrainer(jpyr.PyramidConfig(**SMALL),
                         jst.SwrTrainConfig(crop=32, max_steps=10,
                                            n_chunks=4, prog_steps=(3,)),
                         sphere.rays, sphere.poses, sphere.K, sphere.img_wh)
    jtr.load_npz(path)
    for a, b in zip(jtr.state.params["levels"], tr.state.params["levels"]):
        np.testing.assert_array_equal(np.asarray(a), np32(b))
    for k, v in tr.state.params["rgb_mlp"].items():
        np.testing.assert_array_equal(np.asarray(jtr.state.params["rgb_mlp"][
            k]), np32(v))


@pytest.mark.parametrize("light", [True, False], ids=["light", "full"])
def test_swr_trainer_save_load_state(sphere, tmp_path, light):
    """Resume: step, phase and random streams restored; light restarts
    Adam (count 0) at the saved schedule count, full resumes exactly."""
    kw = dict(mcfg=dict(resolutions=(4, 8), rgb_width=8, rgb_depth=1),
              crop=16, max_steps=40, n_chunks=2, prog_steps=(4,),
              random_bg=True, tv_w=3e-3)
    tr = _trainer(sphere, **kw)
    for _ in range(8):  # crosses the phase boundary at step 4
        tr.run_step()
    path = str(tmp_path / "state.pt")
    tr.save_state(path, light=light)
    tr2 = _trainer(sphere, **kw)
    tr2.load_state(path)
    assert tr2.step == tr.step == 8
    assert tr2._phase_idx == tr._phase_idx == 1
    tol = 1e-2 if light else 0.0  # bf16 round trip
    for a, b in zip(tst.tree_leaves(tr.state.params),
                    tst.tree_leaves(tr2.state.params)):
        np.testing.assert_allclose(np32(b), np32(a), rtol=tol, atol=tol)
    opt = tr2.state.opt_state
    assert opt.sched_count == 8 and opt.count == (0 if light else 8)
    m1, m2 = tr.run_step(), tr2.run_step()
    assert np.isfinite(float(m2["loss"]))
    if not light:  # same crop, background and TV window: the same step
        assert float(m1["loss"]) == float(m2["loss"])
        for a, b in zip(tst.tree_leaves(tr.state.params),
                        tst.tree_leaves(tr2.state.params)):
            assert torch.equal(a, b)


@pytest.mark.parametrize(
    "over",
    [dict(cam_carve=0.1), dict(mesh=2), dict(inside=True)],
    ids=["cam_carve", "mesh", "inside_camera"],
)
def test_out_of_scope_training_options_raise(sphere, over, tmp_path):
    """``cam_carve``, an inside camera (ROADMAP item 10.5) and a device
    mesh (item 12.1) train: the mesh as two gloo ranks of
    ``SwrTrainer(mesh=...)`` (3 steps, losses finite, every rank's params
    bitwise equal, rank 0 renders)."""
    over = dict(over)
    mcfg = tpyr.PyramidConfig(**dict(SMALL, **over.pop("mcfg", {})))
    mesh = over.pop("mesh", None)
    poses = sphere.poses.copy()
    if over.pop("inside", False):
        poses[0, :, 3] = [0.05, 0.0, -0.2]
    tcfg = tst.SwrTrainConfig(**dict(dict(crop=32, resample_kind="cubic",
                                          n_chunks=4), **over))
    if mesh is not None:
        import torch_parallel_ranks as ranks

        from taichi_nerfs_torch.parallel import launch

        rig = dict(mcfg=mcfg, tcfg=tcfg, images=sphere.rays, poses=poses,
                   K=sphere.K, img_wh=sphere.img_wh, alphas=None)
        outs = launch(ranks.swr_trainer_rank, 2, device="cpu",
                      backend="gloo", rendezvous_dir=str(tmp_path),
                      args=(torch.get_num_threads(), rig, 3))
        assert np.all(np.isfinite(outs[0]["losses"]))
        assert outs[0]["losses"] == outs[1]["losses"]
        for a, b in zip(outs[0]["params"], outs[1]["params"], strict=True):
            assert torch.equal(a, b)
        assert outs[0]["render_finite"]
        return
    tr = tst.SwrTrainer(mcfg, tcfg, sphere.rays, poses, sphere.K,
                        sphere.img_wh, device="cpu")
    assert tr._inside[0] == (poses[0, 2, 3] == -0.2)
    assert (tr.sigma_keep is not None) == (tcfg.cam_carve > 0)
    draw = tr.draw()._replace(i=0)
    if tr._inside[0]:
        draw = draw._replace(face=int(np.argmax(tr.face_shares(0, (0, 0)))))
    assert np.isfinite(float(tr.run_step(draw)["loss"]))
    assert bool(torch.isfinite(tr.render(poses[0])["rgb"]).all())


def test_train_entry_point(tmp_path, monkeypatch):
    """``python -m taichi_nerfs_torch.train``: train (the last steps under
    the profiler), npz, eval, PNGs and the manifest, in train.py's layout
    and schema."""
    from taichi_nerfs_torch.train.__main__ import main

    monkeypatch.chdir(tmp_path)
    argv = ["--root_dir", "synthetic://sphere?views=4&res=32",
            "--dataset_name", "synthetic", "--model_name", "pyramid",
            "--pyramid_levels", "8,16", "--features", "4",
            "--resample_kind", "cubic", "--random_bg", "--alpha_w", "0.1",
            "--max_steps", "12", "--prog_steps", "4", "--exp_name", "tiny",
            "--device", "cpu"]
    manifest = main(argv + ["--profile_dir", str(tmp_path / "prof")])
    assert (tmp_path / "prof" / "trace.json").is_file()
    out = tmp_path / "results" / "tiny"
    for f in ("model_pyramid.npz", "rgb_000.png", "depth_000.png",
              "model_pyramid.manifest.json"):
        assert (out / f).is_file(), f
    saved = json.loads((out / "model_pyramid.manifest.json").read_text())
    assert saved == manifest
    assert saved["argv"][:3] == ["python", "-m", "taichi_nerfs_torch.train"]
    assert saved["views_finite"] == 8 and saved["steps"] == 12
    cfg = json.loads(saved["config"])
    assert cfg["tcfg"]["prog_steps"] == [4] and cfg["tcfg"]["crop"] == 32
    assert len(load_pyramid_npz(str(out / "model_pyramid.npz"))["levels"]) \
        == 2
    # --dataset_name nsvf reads files from --root_dir (none here)
    with pytest.raises(OSError):
        main(argv[:2] + ["--model_name", "pyramid", "--dataset_name", "nsvf",
                         "--device", "cpu"])
