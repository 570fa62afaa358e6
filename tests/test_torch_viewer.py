"""Port parity of the viewer (``viewer/gui.py``), headless.

* ``OrbitCamera``: the pose after ``orbit``, ``scale``, ``pan`` and
  ``reset`` equals the JAX camera's within 1e-6;
* ``NGPGUI`` without a display hands its frames to ``frame_callback``: an
  NGP frame equals ``render_image`` at the camera's pose (whose parity
  with the JAX renderer ``test_torch_ngp_render.py`` holds), the depth mode
  too, and a pyramid frame comes through ``render_fn``
  (``SwrTrainer.render``);
* ``--gui`` through the train entry on the CPU returns after its frames.
"""

import numpy as np
import pytest
import torch
from test_torch_ngp_render import _ball_bitfield, _configs, _params
from torch_port_helpers import np32, t32

from taichi_nerfs_torch.ops.rays import get_ray_directions, get_rays
from taichi_nerfs_torch.render.renderer import render_image
from taichi_nerfs_torch.utils.viz import depth2img
from taichi_nerfs_torch.viewer import gui as tgui
from taichi_nerfs_tpu.data.synthetic import look_at
from taichi_nerfs_tpu.viewer import gui as jgui

_K = np.array([[20.0, 0, 12], [0, 20.0, 10], [0, 0, 1]], np.float32)
_WH = (24, 20)


@pytest.fixture(autouse=True)
def headless(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)


def _poses():
    return np.stack([look_at(np.array(e), np.zeros(3),
                             np.array([0.0, 0.0, 1.0]))
                     for e in ((0.9, 0.7, 0.6), (-1.0, 0.4, 0.3))]
                    ).astype(np.float32)


def test_orbit_camera_matches_jax():
    poses = _poses()
    cams = [m.OrbitCamera(_K, _WH, poses, r=1.7) for m in (jgui, tgui)]
    moves = [("orbit", (0.05, 0.0)), ("orbit", (-0.2, 0.3)),
             ("scale", (0.5,)), ("pan", (100, -150)), ("pan", (3, 4, 5)),
             ("reset", (poses[1],)), ("orbit", (0.1, 0.1)), ("reset", ()),
             ("scale", (-2.0,))]
    for name, args in moves:
        for c in cams:
            getattr(c, name)(*args)
        np.testing.assert_allclose(cams[1].pose, cams[0].pose, rtol=0,
                                   atol=1e-6, err_msg=name)
    assert cams[1].pose.shape == (3, 4)


def test_headless_ngp_frames_match_render_image():
    tcfg, jcfg = _configs("hash")
    _, tp = _params(jcfg, seed=2)
    _, bf = _ball_bitfield(seed=1)
    frames = []
    g = tgui.NGPGUI(tcfg, tp, bf, _K, _WH, _poses(), radius=1.3,
                    frame_callback=frames.append)
    out = g.render(max_frames=2)
    assert len(out) == len(frames) == 2
    w, h = _WH
    assert out[1].shape == (h, w, 3) and out[1].dtype == np.uint8
    # the camera after the two frames' orbits renders the last frame
    pose = g.cam.pose.astype(np.float32)
    rays_o, rays_d = get_rays(get_ray_directions(h, w, _K), t32(pose))
    with torch.no_grad():
        want = render_image(tp, tcfg, bf, rays_o, rays_d)
    rgb = (np.clip(np32(want["rgb"]).reshape(h, w, 3), 0, 1) * 255
           ).astype(np.uint8)
    np.testing.assert_array_equal(out[1], rgb)
    assert g.mean_samples == int(want["total_samples"]) / (w * h) > 0
    assert g.dt > 0
    # the depth mode, at the same camera
    g.img_mode = 1
    d = g.render_frame()
    np.testing.assert_array_equal(
        d, depth2img(np32(want["depth"]).reshape(h, w)))


def test_headless_pyramid_frame_through_render_fn():
    """A tiny pyramid trainer's frames through ``render_fn``, as the train
    entry wires ``SwrTrainer.render``; the first equals ``render`` at the
    same pose."""
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.models.pyramid import PyramidConfig
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig, SwrTrainer

    ds = SyntheticSphereDataset("synthetic://sphere?views=2&res=16",
                                split="train", device="cpu")
    trainer = SwrTrainer(
        PyramidConfig(resolutions=(8, 16), features=4, deferred=True),
        SwrTrainConfig(crop=16, n_chunks=4, resample_kind="cubic"),
        ds.rays, ds.poses, ds.K, ds.img_wh, device="cpu")
    trainer.fit(2)
    calls, frames = [], []

    def render_fn(pose, K, wh):
        calls.append(pose)
        return trainer.render(pose, K=K, img_wh=wh)

    g = tgui.NGPGUI(None, trainer.state.params, None, ds.K, ds.img_wh,
                    ds.poses, frame_callback=frames.append,
                    render_fn=render_fn)
    out = g.render(max_frames=3)
    assert len(out) == len(frames) == len(calls) == 3
    assert not np.array_equal(calls[0], calls[1])  # the camera orbits
    w, h = ds.img_wh
    want = trainer.render(calls[0], K=ds.K, img_wh=(w, h))
    rgb = (np.clip(np32(want["rgb"]).reshape(h, w, 3), 0, 1) * 255
           ).astype(np.uint8)
    np.testing.assert_array_equal(out[0], rgb)
    assert g.mean_samples == 0.0  # the pyramid reports no sample count


def test_train_entry_gui_pyramid(tmp_path, monkeypatch, capsys):
    import taichi_nerfs_torch.train.__main__ as entry

    monkeypatch.chdir(tmp_path)
    manifest = entry.main([
        "--root_dir", "synthetic://sphere?views=4&res=16",
        "--dataset_name", "synthetic", "--model_name", "pyramid",
        "--pyramid_levels", "8,16", "--features", "4", "--max_steps", "2",
        "--exp_name", "tiny", "--eval_views", "1", "--device", "cpu",
        "--gui"])
    assert manifest["views_finite"] == 1
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("frame ")]
    assert len(lines) == 8, lines  # the headless loop's default


def test_headless_without_cv2_even_with_a_display(monkeypatch):
    """Without ``cv2`` (as on a machine with no OpenCV) the loop runs
    headless whatever ``DISPLAY`` says."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setenv("DISPLAY", ":0")
    calls = []
    g = tgui.NGPGUI(None, None, None, _K, _WH, _poses(),
                    render_fn=lambda pose, K, wh: calls.append(pose) or {
                        "rgb": torch.zeros(wh[1] * wh[0], 3)})
    frames = g.render(max_frames=2)
    assert len(frames) == len(calls) == 2
    assert frames[0].shape == (_WH[1], _WH[0], 3)
