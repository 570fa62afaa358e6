"""The port's serving and deployment scripts on the CPU, at tiny sizes.

``scripts/torch_eval_fps.py``, ``torch_viewer_bench.py``,
``torch_native_bench.py`` and ``torch_export_lego_nsvf.py`` run with
``--device cpu`` and print their lines; each raises without a card when
``--device cpu`` is not given.  The NSVF scene they write loads back
through ``data/nsvf.py`` (poses within 1e-5, pixels within half a level of
the rendered views).  On the card, ``chip_smoke.py``'s ``aot`` phase runs
the two timing scripts at full width.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_helpers import numpy_pyramid_params

from taichi_nerfs_torch.utils.convert import (
    pyramid_params_from_numpy,
    save_pyramid_npz,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("torch_eval_fps", "torch_viewer_bench", "torch_native_bench",
           "torch_export_lego_nsvf")


def _script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny record-width pyramid (rgb MLP 64 wide, as the scripts build
    the record configuration from the levels) with a density blob."""
    path = str(tmp_path_factory.mktemp("ckpt") / "model_pyramid.npz")
    tree = numpy_pyramid_params((8, 16), (4, 4), 64, 2, seed=0, blob=8.0)
    save_pyramid_npz(path, pyramid_params_from_numpy(tree))
    return path


def test_eval_fps_on_cpu(ckpt):
    """As a user runs it: a fresh process, capped and uncapped lines."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_eval_fps.py"),
         "--ckpt", ckpt, "--res", "16", "--frames", "1",
         "--resample_kind", "cubic", "--early_exit", "1e-4", "--device",
         "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("R=16 16x16 capped(1.25R): ")
    assert lines[1].startswith("R=16 16x16 uncapped: ")
    assert all("ms/frame" in x and "fps) on cpu" in x for x in lines)


def test_eval_fps_plain_sweep_and_bf16_operands(ckpt, capsys):
    assert _script("torch_eval_fps").main(
        ["--ckpt", ckpt, "--res", "16", "--frames", "1", "--sweep_impl",
         "reference", "--resample_dtype", "bfloat16", "--device",
         "cpu"]) == 0
    assert capsys.readouterr().out.count("ms/frame") == 2


def test_viewer_bench_on_cpu(ckpt, capsys, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert _script("torch_viewer_bench").main(
        ["--ckpt", ckpt, "--res", "16", "--frames", "1", "--device",
         "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("VIEWER: 1 frames in ")
    assert "lat_cap 36, kind cubic, device cpu" in out[-1]


@pytest.mark.parametrize("lat_cap,want", [("none", "lat_cap uncapped"),
                                          ("24", "lat_cap 24")])
def test_viewer_bench_lattice_caps(ckpt, capsys, monkeypatch, lat_cap,
                                   want):
    monkeypatch.delenv("DISPLAY", raising=False)
    _script("torch_viewer_bench").main(
        ["--ckpt", ckpt, "--res", "16", "--frames", "1", "--lat_cap",
         lat_cap, "--kind", "linear", "--early_exit", "0", "--device",
         "cpu"])
    assert want in capsys.readouterr().out


def test_export_lego_nsvf_loads_back(tmp_path, capsys):
    from taichi_nerfs_torch.data.nsvf import NSVFDataset
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset

    spec = "synthetic://lego?views=4&res=16"
    root = str(tmp_path / "Synthetic_NSVF" / "legoproxy")
    assert _script("torch_export_lego_nsvf").main(
        [root, "--spec", spec, "--device", "cpu"]) == 0
    assert f"wrote 4 train + 8 test views to {root}" in capsys.readouterr(
    ).out
    want = SyntheticSphereDataset(root_dir=spec, split="train")
    got = NSVFDataset(root, split="train", downsample=16 / 800)
    assert got.img_wh == (16, 16)
    np.testing.assert_allclose(got.poses, want.poses, atol=1e-5)
    np.testing.assert_allclose(got.K, want.K, atol=1e-5)
    np.testing.assert_allclose(got.rays[..., :3], want.rays[..., :3],
                               atol=0.5 / 255 + 1e-6)


def test_export_lego_nsvf_default_spec_is_the_jax_scripts():
    """The default writes the JAX script's scene: 100 views at 800x800."""
    args = _script("torch_export_lego_nsvf").parser().parse_args([])
    assert args.spec == "synthetic://lego?views=100&res=800"
    assert args.out_root.endswith(os.path.join("Synthetic_NSVF",
                                               "legoproxy"))


def test_native_bench_on_cpu(ckpt, tmp_path, capsys):
    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        pytest.skip("needs cmake and ninja")
    assert _script("torch_native_bench").main(
        ["--pyramid_ckpt", ckpt, "--frames", "1", "--ngp_steps", "2",
         "--res", "24x16", "--build_dir", str(tmp_path / "build"),
         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ngp(deployment-config) 24x16: " in out
    assert "pyramid(R=16) 24x16: " in out


def test_native_bench_raises_when_the_runner_fails(tmp_path):
    mod = _script("torch_native_bench")
    runner = tmp_path / "runner"
    runner.write_text("#!/bin/sh\necho broken >&2\nexit 3\n")
    runner.chmod(0o755)
    with pytest.raises(RuntimeError, match="the runner failed"):
        mod.run_bench(str(runner), lambda wh: str(tmp_path), "fam", 1,
                      [(8, 8)])


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_raises_without_a_card(name, ckpt, tmp_path, monkeypatch):
    """Without ``--device cpu`` every script asks for the card, and a
    missing card is an error, never a quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"torch_eval_fps": ["--ckpt", ckpt],
            "torch_viewer_bench": ["--ckpt", ckpt],
            "torch_native_bench": ["--build_dir", str(tmp_path)],
            "torch_export_lego_nsvf": [str(tmp_path / "Synthetic_x")]}[name]
    with pytest.raises(RuntimeError, match="--device cpu"):
        _script(name).main(argv)
