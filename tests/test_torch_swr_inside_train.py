"""Port parity: training inside and mixed rigs, and camera carving.

* ``camera_keep_mask`` and ``apply_sigma_keep`` (fp32, bf16 and a split
  grid) against the JAX package's;
* the face-masked loss of an inside crop and its gradients against JAX
  ``make_swr_loss(inside=True)`` (``sweep_impl="xla"``) at a fixed crop,
  face, background and TV window, with ``near``, ``cam_carve``, the
  opacity and distortion terms: loss within 1e-5 relative, level
  gradients within 2e-4 relative norm; a crop whose pixels sit on a face
  diagonal (the first axis takes them in both);
* ``SwrTrainer`` on a mixed rig: the same images, crops, faces, slope
  bounds, warps and slab windows as the JAX trainer draws, a loss that
  falls, and the trainer's and ``PyramidRenderer``'s carved frames of an
  inside pose against the JAX trainer's render of the same params;
* the ``shell`` scene's ground truth against JAX's, and a CPU run of the
  train entry on it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_tree, np32, numpy_pyramid_params, t32

from taichi_nerfs_torch.data import synthetic as tsyn
from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.render.serve import PyramidRenderer
from taichi_nerfs_torch.train import swr_step as tst
from taichi_nerfs_torch.utils.convert import (
    pyramid_params_from_numpy,
    save_pyramid_npz,
)
from taichi_nerfs_tpu.data import synthetic as jsyn
from taichi_nerfs_tpu.data.synthetic import look_at
from taichi_nerfs_tpu.models import pyramid as jpyr
from taichi_nerfs_tpu.render import swr as jswr
from taichi_nerfs_tpu.train import swr_step as jst

LOSS_TOL, GRAD_TOL, TOL = 1e-5, 2e-4, 2e-4
RES, FEAT = (16, 32), 4
MODEL = dict(resolutions=RES, features=FEAT, rgb_width=16, scale=0.5,
             sigma_bias=0.0, deferred=True)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _pose(eye, target):
    return look_at(np.asarray(eye, np.float64),
                   np.asarray(target, np.float64), np.array([0.0, 0.0, 1.0]))


def _K(w, f):
    return np.array([[f * w, 0, w / 2], [0, f * w, w / 2], [0, 0, 1]],
                    np.float32)


def _tree(seed=0):
    """Random levels with a density shell of radius 0.35."""
    tree = numpy_pyramid_params(RES, (FEAT,) * len(RES), 16, 2, seed=seed)
    c = (np.arange(RES[-1]) + 0.5) / RES[-1] - 0.5
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt(xx**2 + yy**2 + zz**2)
    tree["levels"][-1][..., 0] += (3.0 * np.exp(-((r - 0.35) / 0.08) ** 2)
                                   ).astype(np.float32)
    return tree


# ------------------------------------------------------------- carving


def test_camera_keep_mask_matches_jax():
    poses = np.stack([_pose((0.1, 0.05, -0.2), (0, 0, 0.3)),
                      _pose((0.3, -0.2, 0.1), (1, 0, 0)),
                      _pose((0.2, 0.3, -1.3), (0, 0, 0))])
    for res, carve, scale in ((16, 0.1, 0.5), (32, 0.25, 0.5),
                              (24, 0.3, 1.0)):
        got = tst.camera_keep_mask(poses, res, carve, scale)
        want = jst.camera_keep_mask(poses, res, carve, scale)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < got.size


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "split"])
def test_apply_sigma_keep_matches_jax(dtype):
    rng = np.random.default_rng(0)
    keep = (rng.uniform(size=(8, 8, 8)) > 0.3).astype(np.float32)
    if dtype == "split":
        sigma = rng.normal(size=(8, 8, 8)).astype(np.float32)
        feats = rng.normal(size=(4, 4, 4, 3)).astype(np.float32)
        want = jst.apply_sigma_keep((jnp.asarray(sigma), jnp.asarray(feats)),
                                    jnp.asarray(keep))
        got = tst.apply_sigma_keep((t32(sigma), t32(feats)), t32(keep))
        assert isinstance(got, tuple)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np32(a), np.asarray(b))
        return
    grid = rng.normal(size=(8, 8, 8, 4)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jst.apply_sigma_keep(jnp.asarray(grid, jdt), jnp.asarray(keep))
    got = tst.apply_sigma_keep(t32(grid).to(tdt), t32(keep))
    assert got.dtype == tdt  # a bf16 bake stays bf16
    np.testing.assert_array_equal(np32(got.float()),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------------- loss


def _loss_both(pose, K, img, crop_xy, face, slope_bounds, carve, tc_kw,
               c=24):
    """JAX and port loss and level gradients for one inside crop."""
    a, positive = face
    flip = not positive
    k_tv = jax.random.PRNGKey(5)
    bg = np.asarray(jax.random.uniform(jax.random.fold_in(k_tv, 17),
                                       (c * c, 3)))
    rf = RES[-1]
    s0 = int(jax.random.randint(jax.random.fold_in(k_tv, 0), (), 0,
                                rf - tst.tv_window(rf) + 1))
    keep = tst.camera_keep_mask(pose[None], RES[-1], carve) if carve else None
    kw = dict(crop=c, n_chunks=4, **tc_kw)
    jc = jst.SwrTrainConfig(sweep_impl="xla", cam_carve=carve, **kw)
    tc = tst.SwrTrainConfig(cam_carve=carve, **kw)
    warp = "gather"
    tree = _tree()
    jl = jst.make_swr_loss(
        jnp.asarray(img), jnp.asarray(pose), jnp.asarray(K),
        jnp.asarray(crop_xy, jnp.int32), k_tv, jpyr.PyramidConfig(**MODEL),
        jc, a, flip, inside=True, warp=warp,
        sigma_keep=None if keep is None else jnp.asarray(keep),
        slope_bounds=(None if slope_bounds is None
                      else jnp.asarray(slope_bounds)))
    (jloss, jmse), jg = jax.value_and_grad(jl, has_aux=True)(jax_tree(tree))
    params = tst._trainable(pyramid_params_from_numpy(tree))
    tl = tst.make_swr_loss(
        torch.as_tensor(img), pose, K, crop_xy, tpyr.PyramidConfig(**MODEL),
        tc, a, flip, bg=t32(bg), tv_starts=(s0,), warp=warp, inside=True,
        sigma_keep=None if keep is None else t32(keep),
        slope_bounds=slope_bounds)
    loss, mse = tl(params)
    grads = torch.autograd.grad(loss, params["levels"])
    return ((float(loss.detach()), float(mse.detach()), grads),
            (float(jloss), float(jmse), jg["levels"]))


def _image(w, seed=0):
    return np.random.default_rng(seed).uniform(size=(w, w, 4)).astype(
        np.float32)


@pytest.mark.parametrize("case", ["tight", "cone", "carve_near"])
def test_inside_loss_and_grads_match_jax(case):
    w, c = 40, 24
    K = _K(w, 0.7)
    pose = _pose((0.3, 0.25, 0.2), (-0.4, -0.4, -0.3))
    crop_xy = (7, 11)
    dom, pos, faces, _ = jswr.pixel_faces(pose, K, (w, w))
    tc_kw = dict(random_bg=True, alpha_w=0.2, distortion_w=1e-3,
                 tv_w=5e-4, sigma_l1=1e-5)
    carve = 0.0
    if case == "carve_near":
        tc_kw["near"] = 0.08
        carve = 0.12
    checked = 0
    for face in faces:
        sb = jswr.face_slope_bounds(pose, K, (c, c), face[0],
                                    1.0 if face[1] else -1.0,
                                    crop_xy=crop_xy)
        if case == "cone":
            sb = None
        elif sb is None:
            continue
        (tl, tm, tg), (jl, jm, jg) = _loss_both(
            pose, K, _image(w), crop_xy, face, sb, carve, tc_kw)
        assert abs(tl - jl) <= LOSS_TOL * abs(jl), (face, tl, jl)
        assert abs(tm - jm) <= LOSS_TOL * abs(jm), (face, tm, jm)
        for g, j in zip(tg, jg):
            assert bool(torch.isfinite(g).all())
            assert _rel_norm(np32(g), j) <= GRAD_TOL, face
        checked += 1
    assert checked >= 2


def test_face_mask_ties_go_to_the_first_axis():
    """An axis-aligned camera whose crop corners lie on the x / z face
    diagonal: the tied pixels belong to face +x (the first axis) in both
    packages, so the +x and +z losses match JAX's."""
    w = 9
    K = np.array([[4.0, 0, 4.5], [0, 4.0, 4.5], [0, 0, 1]], np.float32)
    pose = np.array([[1, 0, 0, 0.05], [0, 1, 0, -0.02], [0, 0, 1, 0.03]],
                    np.float32)
    mask_x = tst.face_mask(pose, t32(K), w, 0, False)
    mask_z = tst.face_mask(pose, t32(K), w, 2, False)
    assert float(mask_x.sum()) > 0 and float(mask_z.sum()) > 0
    assert float((mask_x * mask_z).sum()) == 0  # each pixel one face
    for face in ((0, True), (2, True)):
        (tl, tm, _), (jl, jm, _) = _loss_both(
            pose, K, _image(w, 1), (0, 0), face, None, 0.0,
            dict(random_bg=True), c=w)
        assert abs(tl - jl) <= LOSS_TOL * abs(jl), face
        assert abs(tm - jm) <= LOSS_TOL * abs(jm), face


# ------------------------------------------------------------- trainer


@pytest.fixture(scope="module")
def mixed_rig():
    """4 shell views from inside the cube and 2 from outside, at 32^2."""
    inside = tsyn.SyntheticSphereDataset("synthetic://shell?views=4&res=32",
                                         device="cpu")
    outside = tsyn.SyntheticSphereDataset(
        n_images=2, img_wh=(32, 32), variant="checker", device="cpu")
    rays = np.concatenate([inside.rays, outside.rays])
    poses = np.concatenate([inside.poses, outside.poses])
    alphas = np.concatenate([inside.alphas, outside.alphas])
    return rays, poses, alphas, inside.K


def test_mixed_rig_draws_match_jax(mixed_rig, monkeypatch):
    """The port's trainer picks the JAX trainer's image, crop, face, slope
    bounds, warp and slab window at every step (the JAX step is replaced by
    a recorder)."""
    rays, poses, alphas, K = mixed_rig
    kw = dict(crop=16, n_chunks=4, cam_carve=0.1, near=0.05)
    seen = []

    def record(state, gt, pose, K_, crop_xy, mcfg, tcfg, axis, flip,
               slab_window=0, lat_size=0, inside=False, warp="matmul",
               sigma_keep=None, slope_bounds=None):
        seen.append((tuple(int(x) for x in np.asarray(crop_xy)), axis, flip,
                     inside, warp, slab_window,
                     None if slope_bounds is None
                     else np.asarray(slope_bounds).tolist()))
        return state, {"loss": 0.0}

    monkeypatch.setattr(jst, "swr_train_step", record)
    jtr = jst.SwrTrainer(jpyr.PyramidConfig(**MODEL),
                         jst.SwrTrainConfig(**kw), rays, poses, K, (32, 32),
                         seed=3)
    ttr = tst.SwrTrainer(tpyr.PyramidConfig(**MODEL),
                         tst.SwrTrainConfig(**kw), rays, poses, K, (32, 32),
                         seed=3, device="cpu")
    assert ttr._inside == jtr._inside == [True] * 4 + [False] * 2
    np.testing.assert_array_equal(np32(ttr.sigma_keep),
                                  np.asarray(jtr.sigma_keep))
    got = []
    for _ in range(24):
        jtr.run_step()
        d = ttr.draw()
        pl = ttr.plan(d)
        got.append((d.crop_xy, pl.axis, pl.flip, pl.inside, pl.warp,
                    pl.slab_window,
                    None if pl.slope_bounds is None
                    else pl.slope_bounds.tolist()))
    assert got == seen
    kinds = {g[3] for g in got}
    assert kinds == {True, False}


def test_mixed_rig_trains_and_renders_carved(mixed_rig, tmp_path):
    """A mixed rig with cam_carve and near trains (the loss on fixed draws
    falls); the trainer's frame of an inside pose and an outside one, and
    PyramidRenderer's with the same carving, match the JAX trainer's
    render of the same params."""
    rays, poses, alphas, K = mixed_rig
    kw = dict(crop=16, n_chunks=4, cam_carve=0.1, near=0.05, lr=3e-2,
              random_bg=True, alpha_w=0.2, tv_w=5e-4, max_steps=30)
    tr = tst.SwrTrainer(tpyr.PyramidConfig(**MODEL), tst.SwrTrainConfig(**kw),
                        rays, poses, K, (32, 32), alphas=alphas, seed=1,
                        device="cpu")
    draws = [tr.draw() for _ in range(4)]
    assert {tr._inside[d.i] for d in draws} == {True, False}

    def fixed_loss():
        with torch.no_grad():
            return sum(float(tr.loss_fn(d)(tr.state.params)[0])
                       for d in draws)

    before = fixed_loss()
    losses = [float(tr.run_step()["loss"]) for _ in range(30)]
    assert np.all(np.isfinite(losses))
    assert fixed_loss() < before

    path = str(tmp_path / "model_pyramid.npz")
    save_pyramid_npz(path, tr.state.params)
    jtr = jst.SwrTrainer(jpyr.PyramidConfig(**MODEL),
                         jst.SwrTrainConfig(sweep_impl="xla", **kw), rays,
                         poses, K, (32, 32), alphas=alphas)
    jtr.load_npz(path)
    rend = PyramidRenderer(tr.state.params, tr.cur_mcfg, K, (32, 32),
                           cam_carve=0.1, carve_poses=poses, near=0.05)
    for pose in (poses[0], poses[5]):
        want = jtr.render(pose, img_wh=(32, 32))
        got = tr.render(pose)
        served = rend.render(pose, lat_cap="auto")
        for k in ("rgb", "depth", "opacity"):
            np.testing.assert_allclose(np32(got[k]), np.asarray(want[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
            # the renderer sweeps 16 chunks, the trainer tcfg.n_chunks
            np.testing.assert_allclose(np32(served[k]), np32(got[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="carve_poses"):
        PyramidRenderer(tr.state.params, tr.cur_mcfg, K, (32, 32),
                        cam_carve=0.1)


# -------------------------------------------------------- scene, entry


def test_shell_ground_truth_matches_jax(tmp_path):
    got = tsyn.SyntheticSphereDataset("synthetic://shell?views=3&res=24",
                                      device="cpu")
    want = jsyn.SyntheticSphereDataset("synthetic://shell?views=3&res=24",
                                       cache_dir=str(tmp_path),
                                       gt_backend="numpy")
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_allclose(got.rays, want.rays, atol=1e-5)
    np.testing.assert_allclose(got.alphas, want.alphas, atol=1e-5)
    assert all(tst.is_inside(p, 0.5) for p in got.poses)
    assert np.linalg.norm(got.poses[:, :, 3], axis=-1).max() <= 0.15 + 1e-6


def test_train_entry_runs_an_inside_rig(tmp_path, monkeypatch, capsys):
    """``python -m taichi_nerfs_torch.train`` on the shell scene: it counts
    the inside cameras, turns random backgrounds on, carves, trains and
    evaluates from inside."""
    from taichi_nerfs_torch.train.__main__ import main

    monkeypatch.chdir(tmp_path)
    manifest = main([
        "--root_dir", "synthetic://shell?views=4&res=16",
        "--dataset_name", "synthetic", "--model_name", "pyramid",
        "--pyramid_levels", "8,16", "--features", "4",
        "--near_margin", "0.05", "--cam_carve", "0.1",
        "--max_steps", "3", "--exp_name", "tiny", "--eval_views", "1",
        "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "pyramid: 4/4 training cameras are inside the grid" in out
    cfg = json.loads(manifest["config"])["tcfg"]
    assert cfg["random_bg"] and cfg["cam_carve"] == 0.1
    assert cfg["near"] == 0.05
    assert manifest["views_finite"] == 1
