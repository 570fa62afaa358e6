"""Port parity of the deployment exports (``utils/export.py``).

* ``deployment_dict``: the keys and arrays of the JAX dict for the same
  params and bitfield (equal);
* ``export_native`` and ``export_aot_weights``: every ``.bin`` file
  byte-equal to the JAX package's, ``config.json`` equal as parsed JSON;
* ``export_pyramid_native``: ``grid.bin`` within fp16 rounding of the JAX
  file (the two bakes round differently), every other file byte-equal;
* ``load_tagged_binary`` reads what the JAX package wrote, and the reverse;
* the native runner (``native/``, built in a temporary directory) renders
  the port's export within ``test_native.py:test_native_render_matches_jax``'s
  tolerance of the port's ``render_image``;
* ``--deployment --encoder_type hash`` through the train entry on the CPU
  writes ``deployment.npy`` with the JAX keys; with the brick encoder the
  entry raises ``ValueError`` before training, where the JAX
  ``deployment_dict`` fails with ``KeyError``.
"""

import ctypes
import json
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ngp_render import _ball_bitfield
from test_torch_port_rules import _tiny_ngp_entry
from torch_port_helpers import jax_tree, np32, numpy_pyramid_params, t32

from taichi_nerfs_torch import config as tconfig
from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.utils import export as texp
from taichi_nerfs_torch.utils.convert import (
    ngp_params_from_numpy,
    pyramid_params_from_numpy,
)
from taichi_nerfs_tpu import config as jconfig
from taichi_nerfs_tpu.models import ngp as jngp
from taichi_nerfs_tpu.models import pyramid as jpyr
from taichi_nerfs_tpu.utils import export as jexp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(enc="hash", seed=5):
    kw = dict(scale=0.5, pos_encoder_type=enc, grid_size=32,
              xyz_net_width=16, rgb_net_width=16, mlp_dtype="float32")
    hk = dict(levels=4, feature_per_level=2, log2_T=11, base_res=4,
              max_res=32)
    bk = dict(levels=4, feature_per_level=4, log2_rows=9, base_res=4,
              max_res=32)
    tm = tconfig.ModelConfig(grid=tconfig.HashGridConfig(**hk),
                             brick=tconfig.BrickGridConfig(**bk), **kw)
    jm = jconfig.ModelConfig(grid=jconfig.HashGridConfig(**hk),
                             brick=jconfig.BrickGridConfig(**bk), **kw)
    jp = jax.device_get(jngp.init_ngp_params(jax.random.PRNGKey(seed), jm))
    return tm, jm, jp, ngp_params_from_numpy(jp)


def _poses(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3, 4)).astype(np.float32)


_K = np.array([[36.0, 0, 20], [0, 36.0, 20], [0, 0, 1]], np.float32)


def test_deployment_dict_matches_jax():
    tm, jm, jp, tp = _model()
    words, bf = _ball_bitfield()
    poses = _poses()
    want = jexp.deployment_dict(jp, jm, jnp.asarray(words), poses)
    got = texp.deployment_dict(tp, tm, bf, poses)
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert (a.dtype, a.shape) == (b.dtype, b.shape), k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _files(d):
    return sorted(os.listdir(d))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_export_native_byte_equal(tmp_path):
    tm, jm, jp, tp = _model()
    words, bf = _ball_bitfield()
    poses = _poses(25)
    rc = tconfig.RenderConfig(exp_step_factor=0.0, t_threshold=1e-4)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jexp.export_native(jp, jm, jnp.asarray(words), poses, _K, (40, 32), jd,
                       render_cfg=rc)
    texp.export_native(tp, tm, bf, poses, _K, (40, 32), td, render_cfg=rc)
    assert _files(td) == _files(jd) == [
        "config.json", "density_bitfield.bin", "hash_embedding.bin",
        "pose.bin", "rgb_weights.bin", "sigma_weights.bin"]
    for name in _files(jd):
        if name == "config.json":
            with open(os.path.join(jd, name)) as a, \
                    open(os.path.join(td, name)) as b:
                assert json.load(b) == json.load(a)
        else:
            assert _bytes(os.path.join(td, name)) == \
                _bytes(os.path.join(jd, name)), name


def test_export_aot_weights_byte_equal(tmp_path):
    tm, jm, jp, tp = _model(seed=6)
    words, bf = _ball_bitfield(seed=1)
    poses = _poses(4, seed=1)
    dirs = np.random.default_rng(2).normal(size=(64, 3)).astype(np.float32)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jexp.export_aot_weights(
        jexp.deployment_dict(jp, jm, jnp.asarray(words), poses), jd,
        pose_index=2, directions=dirs)
    texp.export_aot_weights(texp.deployment_dict(tp, tm, bf, poses), td,
                            pose_index=2, directions=dirs)
    assert _files(td) == _files(jd)
    assert "directions.bin" in _files(td)
    for name in _files(jd):
        assert _bytes(os.path.join(td, name)) == \
            _bytes(os.path.join(jd, name)), name


def test_export_pyramid_native(tmp_path):
    res, feats = (8, 16), (4, 4)
    tree = numpy_pyramid_params(res, feats, 16, 2, seed=3, blob=2.0)
    kw = dict(resolutions=res, features=4, rgb_width=16, deferred=True)
    jc, tc = jpyr.PyramidConfig(**kw), tpyr.PyramidConfig(**kw)
    pose = _poses(1, seed=4)[0]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jexp.export_pyramid_native(jax_tree(tree), jc, pose, _K, (40, 40), jd)
    texp.export_pyramid_native(pyramid_params_from_numpy(tree), tc, pose,
                               _K, (40, 40), td)
    assert _files(td) == _files(jd)
    for name in _files(jd):
        if name == "grid.bin":
            a = texp.load_tagged_binary(os.path.join(td, name))
            b = jexp.load_tagged_binary(os.path.join(jd, name))
            assert a.dtype == b.dtype == np.float16
            assert a.shape == b.shape == (16**3 * 4,)
            # one fp16 rounding step at the value's magnitude
            ulp = np.spacing(np.abs(b).astype(np.float16)).astype(np.float32)
            assert np.all(np.abs(a.astype(np.float32) - b.astype(np.float32))
                          <= ulp), name
            assert np.mean(a == b) > 0.9
        elif name == "config.json":
            with open(os.path.join(jd, name)) as x, \
                    open(os.path.join(td, name)) as y:
                assert json.load(y) == json.load(x)
        else:
            assert _bytes(os.path.join(td, name)) == \
                _bytes(os.path.join(jd, name)), name
    split = tpyr.PyramidConfig(resolutions=res, features=4, rgb_width=16,
                               deferred=True, sigma_res=32)
    with pytest.raises(NotImplementedError, match="split"):
        texp.export_pyramid_native({}, split, pose, _K, (8, 8), td)


@pytest.mark.parametrize("arr", [
    np.arange(7, dtype=np.float32), np.arange(5, dtype=np.uint32),
    np.float16([1.5, -2.25, 0.0, 65504.0]), np.arange(-3, 3, dtype=np.int16),
    np.arange(4, dtype=np.int32), np.arange(4, dtype=np.uint16),
], ids=lambda a: str(a.dtype))
def test_tagged_binary_both_ways(arr, tmp_path):
    assert texp.DTYPE_TAGS == jexp.DTYPE_TAGS
    for write, read in ((jexp.save_tagged_binary, texp.load_tagged_binary),
                        (texp.save_tagged_binary, jexp.load_tagged_binary)):
        p = str(tmp_path / "t.bin")
        write(p, arr)
        back = read(p)
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)
    with pytest.raises(ValueError, match="unsupported"):
        texp.save_tagged_binary(p, np.zeros(2, np.float64))


# ------------------------------------------------------- the native runner


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """``native/`` built into a temporary directory (never
    ``native/build``, which ``test_native.py`` uses)."""
    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        pytest.skip("needs cmake and ninja")
    build = str(tmp_path_factory.mktemp("native_build"))
    subprocess.run(["cmake", "-S", os.path.join(REPO, "native"), "-B", build,
                    "-G", "Ninja"], check=True, capture_output=True)
    subprocess.run(["ninja", "-C", build], check=True, capture_output=True)
    so = ctypes.CDLL(os.path.join(build, "libtnerf_c.so"))
    so.tnerf_load.restype = ctypes.c_void_p
    so.tnerf_load.argtypes = [ctypes.c_char_p]
    so.tnerf_render.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    return so


def test_native_runner_renders_the_port_export(native_lib, tmp_path):
    """The port's ``export_native`` of a hash model on an all-occupied grid,
    rendered by the C++ runner, against the port's ``render_image``: PSNR
    above 30 dB, as ``test_native.py`` holds the runner to the JAX
    renderer."""
    from taichi_nerfs_torch.ops.rays import get_ray_directions, get_rays
    from taichi_nerfs_torch.ops.math import packbits_u32
    from taichi_nerfs_torch.render.renderer import render_image

    tm, _, _, tp = _model()
    rc = tconfig.RenderConfig(exp_step_factor=0.0, t_threshold=1e-4,
                              white_bg=True)
    bitfield = packbits_u32(torch.ones(32**3), 0.5)
    w = h = 40
    K = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]],
                 np.float32)
    pose = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -1.4]],
                    np.float32)
    out = str(tmp_path / "export")
    texp.export_native(tp, tm, bitfield, pose[None], K, (w, h), out,
                       render_cfg=rc, pose_index=0)
    rays_o, rays_d = get_rays(get_ray_directions(h, w, K), t32(pose))
    with torch.no_grad():
        want = np32(render_image(tp, tconfig.Config(model=tm, render=rc),
                                 bitfield, rays_o, rays_d, chunk=2048)
                    ["rgb"]).reshape(h, w, 3)
    handle = native_lib.tnerf_load(out.encode())
    assert handle
    buf = (ctypes.c_float * (w * h * 3))()
    p = (ctypes.c_float * 12)(*pose.reshape(-1))
    assert native_lib.tnerf_render(handle, p, buf, 4) == 0
    got = np.ctypeslib.as_array(buf).reshape(h, w, 3)
    mse = float(np.mean((got - want) ** 2))
    assert -10.0 * np.log10(mse + 1e-12) > 30.0, mse
    assert np.std(want) > 1e-3  # not a blank frame


# ---------------------------------------------------------- train entry


_ARGV = ["--root_dir", "synthetic://sphere?views=4&res=24",
         "--dataset_name", "synthetic", "--max_steps", "4",
         "--batch_size", "128", "--exp_name", "tiny", "--eval_views", "1",
         "--device", "cpu", "--deployment"]


def test_train_entry_deployment(monkeypatch, tmp_path):
    entry = _tiny_ngp_entry(monkeypatch)
    monkeypatch.chdir(tmp_path)
    res = entry.main(_ARGV + ["--encoder_type", "hash",
                              "--deployment_model_path", "dep"])
    assert res["steps"] == 5 and np.isfinite(res["last_loss"])
    dep = np.load(tmp_path / "dep" / "deployment.npy",
                  allow_pickle=True).item()
    _, jm, jp, _ = _model()
    want = jexp.deployment_dict(jp, jm, jnp.zeros(32**3 // 32, jnp.uint32),
                                _poses())
    assert set(dep) == set(want)
    assert dep["poses"].shape == (4, 3, 4)
    # the deployment model: 4 hashed levels of 4 features (2^11 rows at
    # this size), 16-wide MLPs
    assert dep["model.hash_encoder.params"].size == 4 * 4 * 2**11
    assert dep["model.rgb_net.params"].size == (16 + 16) * 16 + 16 * 16
    assert dep["model.density_bitfield"].dtype == np.uint8


def test_train_entry_deployment_needs_the_hash_encoder(monkeypatch,
                                                       tmp_path):
    """The brick encoder (the default): the port refuses before training;
    the JAX ``deployment_dict`` raises ``KeyError`` on the same params."""
    entry = _tiny_ngp_entry(monkeypatch)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="--encoder_type hash"):
        entry.main(_ARGV)
    assert not (tmp_path / "results").exists()  # nothing trained
    _, jm, jp, _ = _model("brick")
    with pytest.raises(KeyError, match="hash_table"):
        jexp.deployment_dict(jp, jm, jnp.zeros(32**3 // 32, jnp.uint32),
                             _poses())


@pytest.mark.parametrize("deploy", [False, True], ids=["tiny", "deployment"])
def test_params_from_deployment_inverts_the_dict(deploy):
    """The params rebuilt from a ``deployment.npy`` payload equal the ones
    exported, leaf for leaf (the tiny model and the deployment model, whose
    rgb chain has one hidden layer)."""
    tm, _, _, tp = _model()
    if deploy:
        tm = tconfig.deployment_model_config(0.5)
        from taichi_nerfs_torch.models.ngp import init_ngp_params

        tp = init_ngp_params(tm, torch.Generator().manual_seed(3))
    _, bf = _ball_bitfield()
    dep = texp.deployment_dict(tp, tm, bf, _poses())
    back = texp.params_from_deployment(dep, tm)
    from taichi_nerfs_torch.train.state import tree_leaves

    assert set(back) == set(tp)
    a, b = tree_leaves(back), tree_leaves(tp)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        assert torch.equal(x, y)
