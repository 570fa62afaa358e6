"""The port's record, profiling and oracle scripts and its shell recipes on
the CPU, at tiny sizes, against the JAX scripts.

* the lego volume field (``data/synthetic.py:lego_density`` /
  ``lego_albedo``) against the JAX package's numpy versions, and
  ``render_gt_image(variant="lego")`` against JAX's numpy integrator;
* ``scripts/torch_voxel_ceiling.py`` and ``torch_swr_inside_fidelity.py``
  against ``voxel_ceiling.py`` and ``swr_inside_fidelity.py`` run here:
  the same images and the same printed PSNRs, for ``shell`` and ``lego``;
* ``torch_quality_run.py`` paused by its wall and resumed, its manifest's
  config against the JAX script's for the same argv, and
  ``torch_publish_record.py`` on what it wrote;
* both profilers at a reduced configuration, every piece printed;
* the six ``scripts/torch_train_*.sh`` recipes: their python argv equals
  the JAX recipes', and it parses to the same namespace in both packages;
* every new script raises without a card unless ``--device cpu`` is given.

On the card, ``chip_smoke.py``'s ``scripts`` phase runs each script at full
width.
"""

import functools
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import np32, t32

from taichi_nerfs_tpu.data import synthetic as jsyn
from taichi_nerfs_tpu.render import swr as jswr
from taichi_nerfs_torch.data import synthetic as tsyn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gt_cache(tmp_path_factory):
    """The JAX scripts' GT cache, shared by this module's tests."""
    return str(tmp_path_factory.mktemp("gt_cache"))


def _jax_main(name, argv, monkeypatch, gt_cache):
    """Run ``scripts/<name>.py`` (the JAX script) in this process, its GT
    cache in ``gt_cache``."""
    monkeypatch.setattr(jsyn, "SyntheticSphereDataset", functools.partial(
        jsyn.SyntheticSphereDataset, cache_dir=gt_cache))
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    _script(name).main()


# ------------------------------------------------------------- lego field


def _lego_points():
    """4096 seeded points in the cube, then 256 points 5 mm above the seam
    where the red and the yellow brick meet (x = 0.03): their top faces
    lie in one plane, so both bricks' SDFs are the same top-face distance
    bit for bit, and the part argmin ties."""
    rng = np.random.default_rng(0)
    seam = rng.uniform(0.0, 1.0, (256, 2)) * [0.006, 0.07] + [0.027, -0.09]
    return np.concatenate([
        rng.uniform(-0.5, 0.5, (4096, 3)),
        np.concatenate([seam, np.full((256, 1), -0.25)], axis=1),
    ]).astype(np.float32)


def test_lego_fields_match_jax():
    """Density and albedo at 4,352 points against the JAX package's numpy
    versions (``xp=np``): both compute in fp32 with their own exp / sqrt,
    so within 1e-5 (density relative to its 60 peak)."""
    x = _lego_points()
    parts = np.stack(jsyn._lego_sdf_parts(x[4096:], np))
    srt = np.sort(parts, axis=0)
    assert np.all(srt[0] == srt[1])  # the seam's points tie
    np.testing.assert_allclose(np32(tsyn.lego_density(t32(x))),
                               jsyn.lego_density(x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np32(tsyn.lego_albedo(t32(x))),
                               jsyn.lego_albedo(x), rtol=0, atol=1e-5)


def test_render_gt_image_lego_matches_jax():
    """``render_gt_image(variant="lego")`` integrates the lego volume field
    as JAX's numpy integrator does: 16x16, 64 steps, rgb and alpha within
    1e-5."""
    from taichi_nerfs_torch.data.cameras import look_at

    c2w = look_at(np.array([0.9, 0.3, 0.7]), np.array([0.0, 0.0, -0.12]),
                  np.array([0.0, 0.0, 1.0]))
    K = np.array([[14.4, 0, 8], [0, 14.4, 8], [0, 0, 1]], np.float32)
    got = tsyn.render_gt_image(c2w, K, 16, 16, n_steps=64, variant="lego",
                               want_alpha=True)
    want = jsyn.render_gt_image(c2w, K, 16, 16, n_steps=64, variant="lego",
                                want_alpha=True)
    assert 0.05 < want[1].mean() < 0.95
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


# ----------------------------------------------------------------- oracles


def _capture_jax_ceiling(monkeypatch):
    """Record the outputs of the JAX ceiling's jitted ``integrate``."""
    got, real_jit = [], jax.jit

    def jit(f, *a, **k):
        fn = real_jit(f, *a, **k)
        if getattr(f, "__name__", "") != "integrate":
            return fn

        def wrapped(*args):
            out = fn(*args)
            got.append(np.asarray(out))
            return out
        return wrapped

    monkeypatch.setattr(jax, "jit", jit)
    return got


def _capture_jax_inside(monkeypatch):
    """Record the JAX inside renders' rgb; restore ``swr.pyr``, which the
    JAX script replaces for good, when the test ends."""
    got, real = [], jswr.render_swr_inside
    monkeypatch.setattr(jswr, "pyr", jswr.pyr)

    def render(*a, **k):
        out = real(*a, **k)
        got.append(np.clip(np.asarray(out["rgb"]), 0, 1))
        return out

    monkeypatch.setattr(jswr, "render_swr_inside", render)
    return got


_PSNR = re.compile(r"psnr = ([0-9.]+)")


@pytest.mark.parametrize("variant", ["shell", "lego"])
@pytest.mark.parametrize("name", ["voxel_ceiling", "swr_inside_fidelity"])
def test_oracle_matches_the_jax_script(name, variant, tmp_path, monkeypatch,
                                       capsys, gt_cache):
    """R=16, one 16x16 view: the port's image within 1e-4 of the JAX
    script's (both fp32; measured ~3e-6) and the printed PSNR within 0.01
    dB; ``--save`` writes the PNGs."""
    argv = ["--variant", variant, "--res", "16", "--img", "16", "--n_views",
            "1"]
    capture = (_capture_jax_ceiling if name == "voxel_ceiling"
               else _capture_jax_inside)(monkeypatch)
    _jax_main(name, argv, monkeypatch, gt_cache)
    want = np.concatenate(capture)[:256]
    want_psnr = [float(x) for x in _PSNR.findall(capsys.readouterr().out)]
    save = str(tmp_path / "out")
    got = _script(f"torch_{name}").main(argv + ["--device", "cpu", "--save",
                                                save])
    got_psnr = [float(x) for x in _PSNR.findall(capsys.readouterr().out)]
    assert len(got) == 1 and got[0].shape == (256, 3)
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-4)
    assert len(want_psnr) == len(got_psnr) == 1
    assert abs(got_psnr[0] - want_psnr[0]) <= 0.01
    pngs = sorted(p.name for p in tmp_path.glob("out_*.png"))
    assert pngs == (["out_v0.png"] if name == "voxel_ceiling"
                    else ["out_gt_v0.png", "out_swr_v0.png"])


# -------------------------------------------------------- the record run

_RECORD_ARGV = ["--views", "2", "--pyramid_levels", "4,8,16", "--features",
                "4", "--fine_features", "2", "--total_steps", "3",
                "--eval_views", "1"]


def _fake_clock(monkeypatch, mod):
    """The script's clock advances one second a reading, so a ``--wall``
    stops training after a fixed number of steps."""
    n = [0]

    def tick():
        n[0] += 1
        return float(n[0])

    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        time=tick, strftime=time.strftime))


def test_quality_run_pauses_resumes_and_publishes(tmp_path, monkeypatch,
                                                  capsys):
    """Invocation 1 stops at its wall short of ``--total_steps`` and saves
    the step, the phase and the host stream (the JAX trainer's draws:
    image, crop x, crop y a step); invocation 2 resumes there, finishes,
    evaluates and writes the model and the manifest;
    ``torch_publish_record.py`` copies the manifest and writes three PNGs,
    all under the working directory."""
    monkeypatch.chdir(tmp_path)
    argv = _RECORD_ARGV + ["--scene", "sphere", "--res", "256", "--state",
                           "q.pt", "--device", "cpu"]
    run = _script("torch_quality_run")
    _fake_clock(monkeypatch, run)
    assert run.main(argv + ["--wall", "3"]) == 0
    out = capsys.readouterr().out
    k = int(re.search(r"PAUSED at step (\d+)/3", out).group(1))
    assert 1 <= k < 3
    d = torch.load("q.pt", weights_only=True)
    assert d["step"] == k
    assert d["phase"] == sum(end <= k - 1 for end in (1, 2))  # prog (1, 1)
    rng = np.random.RandomState(23)
    for _ in range(k):
        rng.randint(2), rng.randint(1), rng.randint(1)
    want = rng.get_state()
    assert d["host_rng"][2:] == [want[2], want[3], want[4]]
    assert np.array_equal(d["host_rng"][1], want[1])
    assert "params_bf16" in d and "adam" not in d  # the light checkpoint

    run = _script("torch_quality_run")
    assert run.main(argv) == 0
    out = capsys.readouterr().out
    assert f"resumed at step {k}" in out and "TRAIN DONE: 3 steps" in out
    assert re.search(r"^RECORD: eval_psnr=[0-9.]+ ", out, re.M)
    assert re.search(
        r"^launches: swr_sweep_fwd=0 swr_sweep_bwd=0 band_warp=0$", out,
        re.M)
    with open("results/model_pyramid.manifest.json") as f:
        man = json.load(f)
    assert man["steps"] == 3 and man["views_finite"] == 1
    assert np.isfinite(man["eval_psnr"]) and man["argv"] == argv
    assert os.path.isfile("results/model_pyramid.npz")

    pub = _script("torch_publish_record")
    assert pub.main(["--state", "q.pt", "--device", "cpu"]) == 0
    assert "published view 0 renders" in capsys.readouterr().out
    recs = tmp_path / "docs" / "records"
    assert sorted(p.name for p in recs.iterdir()) == [
        "lego_proxy.manifest.json", "lego_proxy_depth.png",
        "lego_proxy_gt.png", "lego_proxy_rgb.png"]
    with open(recs / "lego_proxy.manifest.json") as f:
        assert json.load(f) == man


def test_quality_run_manifest_config_is_the_jax_scripts(tmp_path,
                                                        monkeypatch,
                                                        gt_cache):
    """The same argv (``--eval_now``: the configs are built, nothing
    trains) gives the JAX script's ``config`` blob and ``config_sha1``, and
    a manifest with its keys."""
    argv = _RECORD_ARGV + ["--res", "16", "--eval_now", "--scene", "sphere"]
    mans = {}
    for pkg in ("jax", "torch"):
        os.makedirs(tmp_path / pkg)
        monkeypatch.chdir(tmp_path / pkg)
        state = ["--state", str(tmp_path / pkg / "q.st")]
        if pkg == "jax":
            _jax_main("quality_run", argv + state, monkeypatch, gt_cache)
        else:
            _script("torch_quality_run").main(argv + state
                                              + ["--device", "cpu"])
        with open("results/model_pyramid.manifest.json") as f:
            mans[pkg] = json.load(f)
    assert set(mans["torch"]) == set(mans["jax"])
    assert mans["torch"]["config"] == mans["jax"]["config"]
    assert mans["torch"]["config_sha1"] == mans["jax"]["config_sha1"]


# --------------------------------------------------------------- profilers


def _tiny_ngp_config(real):
    import dataclasses

    from torch_parallel_ranks import tiny_ngp_config

    cfg = tiny_ngp_config(real())
    return cfg.replace(train=dataclasses.replace(cfg.train, batch_size=256))


_PIECES = {
    "torch_profile_swr": [
        "full step", "full step defer", "defer crop 24", "bake fwd+bwd",
        "sweep fwd (16)", "sweep fwd win", "sweep fwd+bwd",
        "sweep fwd+bwd w", "full step no-reg", "adam (dummy g)"] + [
        f"render {wh}^2 {tag}" for wh in (16, 32)
        for tag in ("cap fp32", "cap defer", "capdef bf", "capdef bf skp")],
    "torch_profile_parity": ["march_rays", "render_train fwd",
                             "render_train fwd+bwd", "trainer.run_step"],
}


@pytest.mark.parametrize("name", sorted(_PIECES))
def test_profiler_prints_every_piece(name, monkeypatch, capsys):
    """``--reps 1`` at a reduced configuration: every piece of the JAX
    script prints its median and spread."""
    mod = _script(name)
    if name == "torch_profile_swr":
        monkeypatch.setattr(mod, "LEVELS", (8, 16))
        monkeypatch.setattr(mod, "FEATURES", 4)
        monkeypatch.setattr(mod, "CROP", 16)
        monkeypatch.setattr(mod, "N_CHUNKS", 4)
        monkeypatch.setattr(mod, "IMG", 32)
        monkeypatch.setattr(mod, "BIG_CROPS", (24,))
        monkeypatch.setattr(mod, "FRAME_SIZES", (16, 32))
    else:
        monkeypatch.setattr(mod, "config", functools.partial(
            _tiny_ngp_config, mod.config))
        monkeypatch.setattr(mod, "N_VIEWS", 2)
        monkeypatch.setattr(mod, "RES", 16)
        monkeypatch.setattr(mod, "SETTLE", 4)
    assert mod.main(["--reps", "1", "--device", "cpu"]) == 0
    timed = re.findall(r"^(.+?) +median +[0-9.]+ ms \(min [0-9.]+, max "
                       r"[0-9.]+, 1 runs\)", capsys.readouterr().out, re.M)
    assert timed == _PIECES[name]


# ------------------------------------------------------------ shell recipes

_RECIPES = ("train_360_v2_garden", "train_from_video", "train_lego_proxy",
            "train_ngp_dataset", "train_nsvf_deploy", "train_nsvf_lego")


def _python_calls(script, extra, tmp_path):
    """Each ``python`` command line the recipe runs (a stand-in ``python``
    on PATH logs its argv and PYTHONPATH and returns 0)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    fake = bin_dir / "python"
    fake.write_text(
        f"#!{sys.executable}\nimport json, os, sys\n"
        "with open(os.environ['ARGV_LOG'], 'a') as f:\n"
        "    f.write(json.dumps([sys.argv[1:], "
        "os.environ.get('PYTHONPATH', '')]) + '\\n')\n")
    fake.chmod(0o755)
    log = tmp_path / f"{os.path.basename(script)}.log"
    env = {k: v for k, v in os.environ.items()
           if k not in ("DATA_DIR", "MAX_STEPS", "PYTHONPATH")}
    env.update(PATH=f"{bin_dir}{os.pathsep}{env['PATH']}", ARGV_LOG=str(log))
    subprocess.run(["bash", script] + extra, env=env, cwd=tmp_path,
                   check=True, timeout=60)
    with open(log) as f:
        return [json.loads(line) for line in f]


class _Parsed(Exception):
    pass


def _namespace(main, argv, monkeypatch):
    """The namespace ``main(argv)``'s ``ArgumentParser`` parses."""
    import argparse

    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(vars(real(self, args, namespace)))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(_Parsed) as e:
            main(argv)
    return e.value.args[0]


@pytest.mark.parametrize("name", _RECIPES)
def test_shell_recipe_is_the_jax_recipe(name, tmp_path, monkeypatch):
    """``bash -n`` passes; the python argv (after ``"$@"`` and the
    ``${VAR:-default}`` expansions) is the JAX recipe's with the port's
    modules, PYTHONPATH starts at this checkout, and the argv parses to
    the same namespace in the port's parsers and in JAX's."""
    from opt import get_opts

    import taichi_nerfs_tpu.data.colmap2nerf as jc2n
    import taichi_nerfs_torch.data.colmap2nerf as tc2n
    from taichi_nerfs_torch.train.__main__ import _parse

    script = os.path.join(REPO, "scripts", f"torch_{name}.sh")
    subprocess.run(["bash", "-n", script], check=True, timeout=60)
    extra = (["clip.mp4", "work"] if name == "train_from_video"
             else ["--max_steps", "7"])
    got = _python_calls(script, extra, tmp_path)
    want = _python_calls(os.path.join(REPO, "scripts", f"{name}.sh"), extra,
                         tmp_path)
    assert len(got) == len(want) >= 1
    for (g, path), (w, _) in zip(got, want):
        assert os.path.realpath(path.split(os.pathsep)[0]) == \
            os.path.realpath(REPO)
        if w[0] == "train.py":
            assert g[:2] == ["-m", "taichi_nerfs_torch.train"]
            assert g[2:] == w[1:]
            device, hp = _parse(g[2:])
            assert device == "cuda"
            assert vars(hp) == vars(get_opts(w[1:]))
        else:
            assert w[:2] == ["-m", "taichi_nerfs_tpu.data.colmap2nerf"]
            assert g[:2] == ["-m", "taichi_nerfs_torch.data.colmap2nerf"]
            assert g[2:] == w[2:]
            assert (_namespace(tc2n.main, g[2:], monkeypatch)
                    == _namespace(jc2n.main, w[2:], monkeypatch))


# ------------------------------------------------- no silent CPU fallback


@pytest.mark.parametrize("name", [
    "torch_quality_run", "torch_publish_record", "torch_profile_swr",
    "torch_profile_parity", "torch_voxel_ceiling",
    "torch_swr_inside_fidelity"])
def test_record_script_raises_without_a_card(name, tmp_path, monkeypatch):
    """Without ``--device cpu`` every script asks for the card, and a
    missing card is an error, never a quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = {"torch_quality_run": ["--views", "2", "--res", "16"],
            "torch_publish_record": ["--manifest", "none.json",
                                     "--state", "none.pt"]}.get(name, [])
    with pytest.raises(RuntimeError, match="--device cpu"):
        _script(name).main(argv)


def test_publish_manifest_alone_needs_no_card(tmp_path, monkeypatch,
                                              capsys):
    """Without ``--state`` the publication only copies the manifest: no
    card is asked for, and the launch line still prints (no launches)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    man = {"eval_psnr": 30.0, "eval_ssim": 0.9, "train_wall_s": 1.0,
           "views_finite": 1}
    (tmp_path / "m.json").write_text(json.dumps(man))
    assert _script("torch_publish_record").main(
        ["--manifest", "m.json", "--name", "x"]) == 0
    assert re.search(
        r"^launches: swr_sweep_fwd=0 swr_sweep_bwd=0 band_warp=0$",
        capsys.readouterr().out, re.M)
    with open(tmp_path / "docs" / "records" / "x.manifest.json") as f:
        assert json.load(f) == man
    assert os.listdir(tmp_path / "docs" / "records") == ["x.manifest.json"]
