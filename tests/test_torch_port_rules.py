"""Rules of the PyTorch port: no JAX, and no silent out-of-scope paths."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_helpers import numpy_pyramid_params

from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.render import swr as tswr
from taichi_nerfs_torch.render.serve import PyramidRenderer
from taichi_nerfs_torch.utils.convert import pyramid_params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "taichi_nerfs_torch")
FORBIDDEN = ("jax", "optax", "taichi_nerfs_tpu")


def _package_files():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)


def _modules():
    for path in _package_files():
        if path.endswith(".py"):
            rel = os.path.relpath(path, REPO)[: -len(".py")]
            mod = rel.replace(os.sep, ".")
            yield mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


def test_package_imports_without_jax():
    """Every module of the port imports with jax, optax and the JAX
    package made unimportable."""
    code = (
        "import importlib, sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
        + f"for m in {sorted(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "import taichi_nerfs_torch.render.serve\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_file_of_the_package_names_jax():
    offenders = []
    for path in _package_files():
        with open(path, encoding="utf-8") as f:
            for n, line in enumerate(f, 1):
                if (
                    "import jax" in line
                    or "from jax" in line
                    or "optax" in line
                    or "taichi_nerfs_tpu" in line
                ):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{n}")
    assert not offenders, offenders


@pytest.fixture(scope="module")
def tiny():
    kw = dict(resolutions=(8, 16), features=4, rgb_width=16, deferred=True)
    cfg = tpyr.PyramidConfig(**kw)
    params = pyramid_params_from_numpy(
        numpy_pyramid_params((8, 16), (4, 4), 16, 2, seed=0)
    )
    grid = tpyr.bake(params, cfg)
    K = np.array([[14.4, 0, 8], [0, 14.4, 8], [0, 0, 1]], np.float32)
    from taichi_nerfs_torch.data.cameras import look_at

    pose = look_at(np.array([0.3, 0.2, -1.3]), np.zeros(3),
                   np.array([0.0, 0.0, 1.0]))
    return cfg, params, grid, pose, K


@pytest.mark.parametrize(
    "kw",
    [
        dict(inside=True),
        dict(debug_frames=True),
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_out_of_scope_render_options_raise(tiny, kw):
    cfg, params, grid, pose, K = tiny
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tswr.render_swr(params, grid, cfg, pose, K, (16, 16), n_chunks=4,
                        **kw)


def test_renderer_raises_for_inside_camera_and_cam_carve(tiny):
    cfg, params, _, pose, K = tiny
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PyramidRenderer(params, cfg, K, (16, 16), cam_carve=0.5)
    rend = PyramidRenderer(params, cfg, K, (16, 16))
    inside = pose.copy()
    inside[:, 3] = [0.05, 0.0, -0.2]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rend.render(inside)
    out = rend.render(pose)  # an outside camera renders
    assert bool(torch.isfinite(out["rgb"]).all())


def test_renderer_refuses_tf32(tiny, monkeypatch):
    cfg, params, _, pose, K = tiny
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="tf32"):
        PyramidRenderer(params, cfg, K, (16, 16)).render(pose)


# ------------------------------------------------------------ train entry

_NGP_ARGV = ["--root_dir", "synthetic://sphere?views=4&res=24",
             "--dataset_name", "synthetic", "--model_name", "ngp"]


@pytest.mark.parametrize("extra", [
    ["--model_name", "svox"],
    ["--encoder_type", "triplane"],
    ["--deployment"],
    ["--gui"],
    ["--num_devices", "2"],
    ["--dataset_name", "nsvf"],
], ids=["svox", "triplane", "deployment", "gui", "num_devices", "nsvf"])
def test_train_entry_out_of_scope_raises(extra):
    from taichi_nerfs_torch.train.__main__ import main

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(_NGP_ARGV + extra)


def test_ngp_registry_and_trainer_mesh_raise():
    from taichi_nerfs_torch.models.registry import get_model
    from taichi_nerfs_torch.train.loop import Trainer

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model("svox")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(None, None, None, None, mesh=object())


def test_train_entry_ngp_cpu_run(tmp_path, monkeypatch):
    """One CPU run of ``python -m taichi_nerfs_torch.train --model_name
    ngp`` at a tiny size: it trains, writes model.npz and the PNGs, and
    reports the evaluation."""
    import dataclasses

    import taichi_nerfs_torch.train.__main__ as entry
    from taichi_nerfs_torch.utils.convert import load_ngp_npz

    real = entry.config_from_opts

    def tiny(hp):
        cfg = real(hp)
        return cfg.replace(
            model=cfg.model.replace(
                grid_size=16, xyz_net_width=16, rgb_net_width=16,
                brick=dataclasses.replace(cfg.model.brick, levels=2,
                                          log2_rows=10, max_res=32)),
            render=dataclasses.replace(cfg.render, train_sample_cap=64,
                                       test_chunk_samples=16),
            train=dataclasses.replace(cfg.train, warmup_steps=4,
                                      update_interval=2),
        )

    monkeypatch.setattr(entry, "config_from_opts", tiny)
    monkeypatch.chdir(tmp_path)
    res = entry.main(_NGP_ARGV + ["--max_steps", "6", "--batch_size", "128",
                                  "--exp_name", "tiny", "--eval_views", "2",
                                  "--device", "cpu"])
    out = tmp_path / "results" / "tiny"
    for name in ("model.npz", "rgb_000.png", "depth_000.png"):
        assert (out / name).exists(), name
    assert len(res["psnr"]) == 2 and np.all(np.isfinite(res["psnr"]))
    params, occ, step, opt = load_ngp_npz(str(out / "model.npz"))
    assert opt.count == opt.sched_count == step
    assert step == 7 and set(params) == {"brick", "rgb_mlp", "xyz_mlp"}
    assert occ.bitfield.shape == (16**3 // 32,)


# ------------------------------------------------- no silent CPU fallback


@pytest.fixture
def no_card(monkeypatch):
    """A machine without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_ckpt(tmp_path):
    from taichi_nerfs_torch.utils.convert import save_pyramid_npz

    path = str(tmp_path / "model_pyramid.npz")
    save_pyramid_npz(path, pyramid_params_from_numpy(
        numpy_pyramid_params((8, 16), (4, 4), 16, 2, seed=0)))
    return path


def _serve(tmp_path, extra, monkeypatch):
    from taichi_nerfs_torch.render import serve

    serve.main(["--ckpt_path", _tiny_ckpt(tmp_path), "--img_wh", "16", "16",
                "--n_views", "1", "--out_dir", str(tmp_path / "serve")]
               + extra)
    return (tmp_path / "serve" / "rgb_000.png").is_file()


def _train(tmp_path, extra, monkeypatch):
    import taichi_nerfs_torch.train.__main__ as entry

    monkeypatch.chdir(tmp_path)
    entry.main(["--root_dir", "synthetic://sphere?views=4&res=16",
                "--dataset_name", "synthetic", "--model_name", "pyramid",
                "--pyramid_levels", "8,16", "--features", "4",
                "--resample_kind", "cubic", "--max_steps", "2",
                "--exp_name", "tiny", "--eval_views", "1"] + extra)
    return (tmp_path / "results" / "tiny" / "model_pyramid.npz").is_file()


def _trainer(tmp_path, extra, monkeypatch):
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig, SwrTrainer

    ds = SyntheticSphereDataset("synthetic://sphere?views=2&res=16",
                                split="train", device="cpu")
    trainer = SwrTrainer(
        tpyr.PyramidConfig(resolutions=(8, 16), features=4, deferred=True),
        SwrTrainConfig(crop=16, n_chunks=4, resample_kind="cubic"),
        ds.rays, ds.poses, ds.K, ds.img_wh, **extra)
    return trainer.device == torch.device("cpu")


_ENTRIES = {  # how each entry point runs, and how it asks for the CPU
    "serve": (_serve, [], ["--device", "cpu"]),
    "train": (_train, [], ["--device=cpu"]),
    "SwrTrainer": (_trainer, {}, {"device": "cpu"}),
}


@pytest.mark.parametrize("name", sorted(_ENTRIES))
def test_entry_points_raise_without_a_card_by_default(name, no_card,
                                                      tmp_path, monkeypatch):
    """Without a CUDA device, the entry points refuse to start unless the
    CPU is asked for, and the message says how to ask."""
    run, default, _ = _ENTRIES[name]
    with pytest.raises(RuntimeError, match="no CUDA device.*cpu"):
        run(tmp_path, default, monkeypatch)


@pytest.mark.parametrize("name", sorted(_ENTRIES))
def test_entry_points_run_on_the_cpu_when_asked(name, no_card, tmp_path,
                                                monkeypatch):
    run, _, cpu = _ENTRIES[name]
    assert run(tmp_path, cpu, monkeypatch)


@pytest.mark.parametrize("argv,want", [
    ([], ("cuda", [])),
    (["--device", "cpu", "--lr", "1"], ("cpu", ["--lr", "1"])),
    (["--lr", "1", "--device=cpu"], ("cpu", ["--lr", "1"])),
    (["--device", "cuda:1"], ("cuda:1", [])),
], ids=["default", "spaced", "equals", "index"])
def test_train_entry_takes_device_out_of_argv(argv, want):
    from taichi_nerfs_torch.train.__main__ import _split_device

    assert _split_device(argv) == want


def test_package_has_no_cpu_fallback():
    """No module picks the CPU because the card is missing."""
    offenders = []
    for path in _package_files():
        with open(path, encoding="utf-8") as f:
            for n, line in enumerate(f, 1):
                if "is_available() else" in line:
                    offenders.append(f"{os.path.relpath(path, REPO)}:{n}")
    assert not offenders, offenders
