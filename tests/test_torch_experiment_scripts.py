"""The port's experiment scripts on the CPU, at tiny sizes, against the JAX
scripts they port (each loaded by path; nothing of the JAX package or its
scripts changes).

* ``torch_microbench_compact.py``: the three compactions equal the JAX
  script's ``compact_topk`` / ``compact_scatter`` / ``compact_gather`` on
  the same seeded inputs (exact selection);
* ``torch_microbench_gather.py``: the three gathers equal the JAX
  script's, the unpacked bf16 pair bit for bit;
* ``torch_diag_r512.py``: two small checkpoints (one with lean levels) on a
  shrunk lego rig, the images and the printed split against the JAX
  script's;
* ``torch_sweep_swr.py`` and ``torch_eval_deferred.py``: the configurations
  built for every sweep entry and both modes equal the JAX script's field
  by field, and one tiny run of each finishes with finite PSNRs;
* ``torch_parity_trade.py``: the four candidates' brick layouts equal
  JAX's, the ``4x8_bf16`` encoder forward matches JAX's, and a shrunk run
  prints four records with the JAX record's keys;
* ``torch_roofline_parity.py``: a shrunk settle prints every stage, its
  JSON has the JAX record's keys plus ``card``, and it states no TPU rate;
* every script keeps its JAX script's flags and defaults.

On the card, ``chip_smoke.py``'s ``experiments`` phase runs each script at
full width.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import re
import runpy
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_ranks import tiny_ngp_config
from torch_port_helpers import numpy_pyramid_params, t32

import taichi_nerfs_tpu.train.swr_step as jswr_step
from taichi_nerfs_tpu.data import synthetic as jsyn
from taichi_nerfs_tpu.ops import brick_encoder as jbrick
from taichi_nerfs_tpu.render import swr as jswr
from taichi_nerfs_torch.data import synthetic as tsyn
from taichi_nerfs_torch.ops import brick_encoder as tbrick
from taichi_nerfs_torch.utils.convert import ngp_params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the diagnosis' bf16-bake frames against JAX's: tighter than the 2e-2 of
# the bf16-bake render tests (tests/test_torch_swr_bf16.py; measured 1.3e-6)
DIAG_TOL = 1e-4


def _path(name):
    return os.path.join(REPO, "scripts", f"{name}.py")


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  _path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


def _raise_with(*args, **kwargs):
    raise _Captured(args, kwargs)


def _stub_dataset(*args, **kwargs):
    """A stand-in for the JAX synthetic dataset: no GT is rendered."""
    return types.SimpleNamespace(rays=np.zeros((1, 1, 3), np.float32),
                                 poses=np.zeros((1, 3, 4), np.float32),
                                 K=np.eye(3, dtype=np.float32),
                                 img_wh=(1, 1))


# ------------------------------------------------------------ the flags


def _parsed(run, monkeypatch):
    """The namespace the ``ArgumentParser`` in ``run()`` parses."""
    import argparse

    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Captured(vars(real(self, args, namespace)))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(_Captured) as e:
            run()
    return e.value.args[0]


@pytest.mark.parametrize("name", ["sweep_swr", "eval_deferred", "diag_r512",
                                  "roofline_parity", "parity_trade"])
def test_flags_and_defaults_are_the_jax_scripts(name, monkeypatch):
    """The port's parser gives the JAX script's namespace for no argv,
    plus ``--device`` (default ``cuda``)."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    want = _parsed(lambda: runpy.run_path(_path(name),
                                          run_name="__main__"), monkeypatch)
    got = _parsed(lambda: _script(f"torch_{name}").main([]), monkeypatch)
    assert got.pop("device") == "cuda"
    assert got == want


# --------------------------------------------------------- microbenches


def _compact_modules(monkeypatch):
    """Both compaction modules at N=128, K=100, S=16 (~15 occupied a row:
    rows above and below S)."""
    mods = _script("microbench_compact"), _script("torch_microbench_compact")
    for m in mods:
        for k, v in (("N", 128), ("K", 100), ("S", 16)):
            monkeypatch.setattr(m, k, v)
    return mods


@pytest.mark.parametrize("strategy", ["topk", "scatter", "gather"])
def test_compaction_equals_the_jax_scripts(strategy, monkeypatch):
    """Each strategy's ts, dts and counts equal the JAX script's on the
    same seeded inputs (the JAX functions trace with the shrunk sizes)."""
    jmod, tmod = _compact_modules(monkeypatch)
    occ, ts, dts = tmod.make_inputs(np.random.RandomState(0))
    counts = occ.sum(1)
    assert counts.max() > tmod.S > counts.min()
    want = getattr(jmod, f"compact_{strategy}")(jnp.asarray(occ),
                                                jnp.asarray(ts),
                                                jnp.asarray(dts))
    got = getattr(tmod, f"compact_{strategy}")(
        torch.as_tensor(occ), torch.as_tensor(ts), torch.as_tensor(dts))
    for g, w, part in zip(got, want, ("ts", "dts", "counts")):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w)), part


def test_compaction_main_prints_parity_and_times(monkeypatch, capsys):
    _, tmod = _compact_modules(monkeypatch)
    assert tmod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "parity ok (scatter+gather == topk)" in out
    assert re.findall(r"^(\w+): +[0-9.]+ ms$", out, re.M) == [
        "topk", "scatter", "gather"]


def _gather_modules(monkeypatch):
    mods = _script("microbench_gather"), _script("torch_microbench_gather")
    for k, v in (("M", 96), ("C", 8), ("L", 4), ("N_ENTRIES", 4096)):
        for m in mods:
            monkeypatch.setattr(m, k, v)
    monkeypatch.setattr(mods[1], "BRICK_ROWS", 1000)
    return mods


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("strategy", ["f32x2", "bf16_packed", "brick"])
def test_gather_equals_the_jax_scripts(strategy, monkeypatch):
    """Each gather's outputs equal the JAX script's bit for bit (the
    unpacked bf16 pair too, negative and subnormal words included)."""
    jmod, tmod = _gather_modules(monkeypatch)
    t0, t1, packed, idx, table, idx_l = tmod.make_inputs(
        np.random.RandomState(0))
    if strategy == "bf16_packed":  # the sign bit of both halves set
        packed = packed.copy()
        packed.view(np.uint32)[:64] |= 0x80008000
        packed.view(np.uint32)[64:128] &= 0x807F807F
    args = {"f32x2": (t0, t1, idx), "bf16_packed": (packed, idx),
            "brick": (table, idx_l)}[strategy]
    want = getattr(jmod, f"gather_{strategy}")(*map(jnp.asarray, args))
    got = getattr(tmod, f"gather_{strategy}")(*map(torch.as_tensor, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert np.array_equal(_bits(g.numpy()), _bits(w))


def test_gather_main_prints_rates(monkeypatch, capsys):
    _, tmod = _gather_modules(monkeypatch)
    assert tmod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    err = re.search(r"bf16 pack max err: ([0-9.]+) / ([0-9.]+)", out)
    assert 0 < float(err.group(1)) <= 2**-8 and 0 < float(err.group(2))
    assert len(re.findall(r" ms +\(\d+ M rows/s\)$", out, re.M)) == 3


# -------------------------------------------------------------- diag_r512

# 8 held-out lego views at 16x16 (the test split's floor)
_DIAG_SCENE = "synthetic://lego?views=8&res=16"
_DIAG_LINE = re.compile(
    r"^(\w) view (\d+): psnr=([0-9.]+) mse=([0-9.e+-]+) "
    r"edge_mse=([0-9.e+-]+) \((\d+)% px\) interior_mse=([0-9.e+-]+)$", re.M)


def _write_ckpt(path, resolutions, level_features, seed):
    tree = numpy_pyramid_params(resolutions, level_features, 64, 2,
                                seed=seed, blob=3.0)
    np.savez(path, **{f"level_{i}": g for i, g in enumerate(tree["levels"])},
             **{f"rgb_mlp_{k}": v for k, v in tree["rgb_mlp"].items()})


def test_diag_r512_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """Checkpoint a at (8, 16) x F=4, b at (4, 8, 16) with lean levels (4,
    4, 2), views 0 and 1: each bf16-bake render within ``DIAG_TOL`` of the
    JAX script's; the printed psnr and the three MSEs equal up to a flip of
    their last printed digit (0.01 dB, 1 %), the edge share equal; the eight
    PNGs written."""
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    _write_ckpt(a, (8, 16), (4, 4), seed=0)
    _write_ckpt(b, (4, 8, 16), (4, 4, 2), seed=1)
    argv = ["--a", a, "--b", b, "--views", "0,1"]

    jimgs, real = [], jswr.render_swr

    def render(*args, **kw):
        out = real(*args, **kw)
        jimgs.append(np.clip(np.asarray(out["rgb"]), 0, 1))
        return out

    monkeypatch.setattr(jswr, "render_swr", render)
    # both scripts read the port's GT of the shrunk rig (the lego GT of
    # both packages agree: tests/test_torch_record_scripts.py)
    test = tsyn.SyntheticSphereDataset(_DIAG_SCENE, split="test",
                                       device="cpu")
    assert len(test) == 8 and test.img_wh == (16, 16)
    monkeypatch.setattr(jsyn, "SyntheticSphereDataset",
                        lambda url, split: test)
    monkeypatch.setattr(sys, "argv", ["diag_r512.py", *argv, "--out",
                                      str(tmp_path / "jax")])
    _script("diag_r512").main()
    want = {m[:2]: m[2:] for m in _DIAG_LINE.findall(capsys.readouterr().out)}

    mod = _script("torch_diag_r512")
    monkeypatch.setattr(mod, "SCENE", _DIAG_SCENE)
    monkeypatch.setattr(tsyn, "SyntheticSphereDataset",
                        lambda url, split, device: (url == _DIAG_SCENE
                                                    and test))
    got_imgs = mod.main(argv + ["--out", str(tmp_path / "torch"),
                                "--device", "cpu"])
    out = capsys.readouterr().out
    got = {m[:2]: m[2:] for m in _DIAG_LINE.findall(out)}
    assert re.search(
        r"^launches: swr_sweep_fwd=0 swr_sweep_bwd=0 band_warp=0$", out,
        re.M)
    keys = [("a", "0"), ("a", "1"), ("b", "0"), ("b", "1")]
    assert list(got) == list(want) == keys
    assert len(jimgs) == 4
    for (tag, vi), jimg in zip(keys, jimgs):
        img = got_imgs[(tag, int(vi))]
        assert img.shape == (16, 16, 3)
        assert img.std() > 1e-2  # the blob is in view
        np.testing.assert_allclose(img.reshape(-1, 3), jimg.reshape(-1, 3),
                                   rtol=0, atol=DIAG_TOL)
        # the printed numbers, up to a flip of their last digit
        g, w = got[(tag, vi)], want[(tag, vi)]
        assert abs(float(g[0]) - float(w[0])) <= 0.01 + 1e-9
        for k in (1, 2, 4):
            assert abs(float(g[k]) / float(w[k]) - 1) <= 0.01, (tag, vi, k)
        assert g[3] == w[3]  # the band comes from the GT alone
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == sorted(
        f"{t}_v{v}_{kind}.png" for t, v in keys for kind in ("rgb", "err"))


# ----------------------------------------------------- sweep_swr, eval_deferred


def _jax_configs(monkeypatch, fn, *args, **kwargs):
    """The ``(PyramidConfig, SwrTrainConfig)`` a JAX script's function hands
    the JAX trainer (which never runs)."""
    monkeypatch.setattr(jswr_step, "SwrTrainer", _raise_with)
    monkeypatch.setattr(jsyn, "SyntheticSphereDataset", _stub_dataset)
    with pytest.raises(_Captured) as e:
        fn(*args, **kwargs)
    return e.value.args[0][:2]


def _same_configs(got, want):
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def _jax_sweeps(jmod, monkeypatch):
    """The keywords of each ``run_cfg`` call of the JAX script's ``main``
    (its ``run_cfg`` replaced)."""
    calls = []
    monkeypatch.setattr(jmod, "run_cfg",
                        lambda train, test, **cfg: calls.append(cfg)
                        or (0.0, 0.0, 0.0))
    monkeypatch.setattr(jsyn, "SyntheticSphereDataset", _stub_dataset)
    monkeypatch.setattr(sys, "argv", ["sweep_swr.py"])
    jmod.main()
    return calls


@pytest.mark.parametrize("entry", [0, 1])
def test_sweep_swr_configs_are_the_jax_scripts(entry, monkeypatch, capsys):
    """Each shipped entry (its ``steps`` overriding ``--steps``) builds the
    JAX script's ``PyramidConfig`` and ``SwrTrainConfig`` field by
    field."""
    tmod = _script("torch_sweep_swr")
    jmod = _script("sweep_swr")
    run_cfg = jmod.run_cfg
    calls = _jax_sweeps(jmod, monkeypatch)
    names = re.findall(r"^(.+?): eval=", capsys.readouterr().out, re.M)
    assert names == [n for n, _ in tmod.SWEEPS]
    name, over = tmod.SWEEPS[entry]
    cfg = {**tmod.base_config(1900), **over}
    assert cfg == calls[entry] and cfg["steps"] == 3000
    want = _jax_configs(monkeypatch, run_cfg, _stub_dataset(),
                        _stub_dataset(), **cfg)
    _same_configs(tmod.configs(**cfg), want)


@pytest.mark.parametrize("entry", [0, 1])
def test_sweep_swr_entry_trains_and_evaluates(entry):
    """``run_cfg`` of each entry at a tiny size (2 steps through the slab
    scan, distortion on): finite PSNRs and train time."""
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset

    tmod = _script("torch_sweep_swr")
    tmod.LEVELS = (8, 16)
    kw = dict(img_wh=(16, 16), variant="checker", n_steps=64, device="cpu")
    train = SyntheticSphereDataset(n_images=2, **kw)
    test = SyntheticSphereDataset(n_images=2, split="test", **kw)
    cfg = {**tmod.base_config(2), **tmod.SWEEPS[entry][1], "steps": 2,
           "crop": 16, "n_chunks": 4}
    assert cfg["distortion_w"] > 0
    res = tmod.run_cfg(train, test, device="cpu", **cfg)
    assert all(np.isfinite(res)) and res[0] > 5


@pytest.mark.parametrize("deferred", [False, True])
def test_eval_deferred_configs_are_the_jax_scripts(deferred, monkeypatch):
    jmod = _script("eval_deferred")
    want = _jax_configs(monkeypatch, jmod.run, deferred, 3000, crop=128,
                        img=128, sigma_res=0, n_images=24)
    _same_configs(_script("torch_eval_deferred").configs(deferred, 3000),
                  want)


def test_eval_deferred_runs_both_modes(monkeypatch, capsys):
    """Both modes at a tiny size: finite capped and full-lattice PSNRs, a
    step time each, and no sweep kernel on the CPU."""
    tmod = _script("torch_eval_deferred")
    monkeypatch.setattr(tmod, "LEVELS", (8, 16))
    monkeypatch.setattr(tmod, "N_CHUNKS", 4)
    assert tmod.main(["--steps", "2", "--img", "16", "--crop", "16",
                      "--n_images", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    evals = re.findall(r"lat-capped eval: ([0-9.]+)  full-lattice eval: "
                       r"([0-9.]+)", out)
    modes = re.findall(r"^(\w+): eval_psnr=([0-9.]+) train_time=[0-9.]+s "
                       r"\(2 steps, crop 16\) step_median=([0-9.]+)ms$",
                       out, re.M)
    assert [m[0] for m in modes] == ["normal", "deferred"]
    assert all(float(x) > 5 for e in evals for x in e) and len(evals) == 2
    assert out.count(
        "launches: swr_sweep_fwd=0 swr_sweep_bwd=0 band_warp=0") == 2
    assert len(re.findall(r"\| step=[01] \| psnr=", out)) == 4


# ----------------------------------------------------------- parity_trade


def _jax_candidates(monkeypatch):
    jmod = _script("parity_trade")
    got = {}
    monkeypatch.setattr(jmod, "measure", lambda name, cfg, *a: got.update(
        {name: cfg}))
    monkeypatch.setattr(jsyn, "SyntheticSphereDataset", _stub_dataset)
    monkeypatch.setattr(sys, "argv", ["parity_trade.py"])
    jmod.main()
    return got


@pytest.mark.parametrize("name", ["8x4_fp32", "4x8_bf16", "4x8_fp32",
                                  "8x4_bf16"])
def test_parity_trade_layouts_are_the_jax_scripts(name, monkeypatch):
    """Each candidate's brick config and ``build_brick_layout`` equal the
    JAX script's (the rest of the configuration: the parity config)."""
    want = _jax_candidates(monkeypatch)
    got = _script("torch_parity_trade").candidates()
    assert list(got) == list(want)
    g, w = got[name].model.brick, want[name].model.brick
    assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert dataclasses.asdict(tbrick.build_brick_layout(g)) == \
        dataclasses.asdict(jbrick.build_brick_layout(w))
    assert got[name].train.batch_size == want[name].train.batch_size == 8192


def test_parity_trade_bf16_forward_matches_jax(monkeypatch):
    """The ``4x8_bf16`` layout at full size: JAX's initial params through
    ``utils/convert.py``, one encoder forward on 3,000 points within the
    brick forward tolerance of ``tests/test_torch_ngp_encoders.py``
    (rtol 1e-4, atol 1e-5).  Its training differs by design (the port's
    bf16 table gradient accumulates in fp32 for every F)."""
    brick = _script("torch_parity_trade").candidates()["4x8_bf16"] \
        .model.brick
    assert brick.table_dtype == "bfloat16"
    jl = jbrick.build_brick_layout(_jax_candidates(monkeypatch)["4x8_bf16"]
                                   .model.brick)
    params = jax.device_get(jbrick.init_brick_params(jax.random.PRNGKey(0),
                                                     jl))
    x = np.random.default_rng(3).uniform(0, 1, (3000, 3)).astype(np.float32)
    want = np.asarray(jbrick.brick_encode(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jl))
    got = tbrick.brick_encode(ngp_params_from_numpy(params), t32(x),
                              tbrick.build_brick_layout(brick))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def _tiny_config(real):
    cfg = tiny_ngp_config(real())
    return cfg.replace(train=dataclasses.replace(cfg.train, batch_size=256))


def test_parity_trade_main_prints_four_records(tmp_path, monkeypatch,
                                               capsys):
    """A shrunk run (the tiny NGP model, each candidate keeping its levels,
    F and table dtype on a 2^10-row table): four JSON records with the JAX
    record's keys, finite, and the ``--json`` file."""
    tmod = _script("torch_parity_trade")
    monkeypatch.setattr(tmod, "base_config", functools.partial(
        _tiny_config, tmod.base_config))
    for k, v in (("N_VIEWS", 2), ("N_TEST", 1), ("RES", 16), ("N_TIMED", 2)):
        monkeypatch.setattr(tmod, k, v)
    real = tmod.measure

    def shrunk(name, cfg, *a):
        brick = dataclasses.replace(cfg.model.brick, log2_rows=10,
                                    max_res=32)
        return real(name, cfg.replace(model=cfg.model.replace(brick=brick)),
                    *a)

    monkeypatch.setattr(tmod, "measure", shrunk)
    path = str(tmp_path / "trade.json")
    assert tmod.main(["--steps", "4", "--json", path, "--device",
                      "cpu"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    with open(path) as f:
        assert json.load(f) == recs
    keys = {"name", "levels", "F", "table_dtype", "rays_per_s", "step_ms",
            "steps", "eval_psnr", "sample_cap", "pack_cap"}
    assert [r["name"] for r in recs] == ["8x4_fp32", "4x8_bf16", "4x8_fp32",
                                         "8x4_bf16"]
    for r in recs:
        assert set(r) == keys
        assert np.isfinite(r["rays_per_s"]) and np.isfinite(r["eval_psnr"])
        assert r["steps"] == 1 + 16 + 2  # first, 16 to settle, timed


# -------------------------------------------------------- roofline_parity


def test_roofline_parity_prints_every_stage(tmp_path, monkeypatch, capsys):
    """A shrunk settle (the tiny NGP model, 32 steps on 2 views at 32x32,
    one or two repeats a stage): every stage printed and finite, the
    step and both row rates; ``--json`` holds the keys of
    ``docs/roofline_parity.json`` plus ``card``."""
    tmod = _script("torch_roofline_parity")
    monkeypatch.setattr(tmod, "config", functools.partial(
        _tiny_config, tmod.config))
    for k, v in (("N_VIEWS", 2), ("RES", 32), ("STAGE_REPS", (2, 1)),
                 ("REFRESH_REPS", (1, 0)), ("STEP_REPS", 2)):
        monkeypatch.setattr(tmod, k, v)
    path = str(tmp_path / "roof.json")
    assert tmod.main(["--settle_steps", "32", "--json", path, "--device",
                      "cpu"]) == 0
    out = capsys.readouterr().out
    stages = dict(re.findall(r"^stage (\S+) +([0-9.]+) ms$", out, re.M))
    assert list(stages) == ["march", "render_fwd", "render_fwd_bwd",
                            "grid_refresh/16"]
    assert all(np.isfinite(float(v)) and float(v) > 0
               for v in stages.values())
    # rm_s is the march's samples a ray (JAX's script reads a key its
    # metrics lack and prints -1.0)
    rm_s = float(re.search(r"^steady shapes: .* rm_s=([0-9.]+)$", out,
                           re.M).group(1))
    assert 0 < rm_s <= 64  # the tiny config's sample cap
    assert re.search(r"^measured step: +[0-9.]+ ms .* overhead ratio "
                     r"[0-9.]+x$", out, re.M)
    assert re.search(r"^measured row rates on the cpu: \d+M gather, \d+M "
                     r"scatter rows/s", out, re.M)
    with open(path) as f:
        rec = json.load(f)
    with open(os.path.join(REPO, "docs", "roofline_parity.json")) as f:
        jax_keys = set(json.load(f))
    assert set(rec) == jax_keys | {"card"} and rec["card"] is None
    assert rec["settled_step"] == 34 and rec["batch"] == 256


def test_roofline_parity_states_no_tpu_rate():
    with open(_path("torch_roofline_parity")) as f:
        text = f.read()
    for tpu in ("90e6", "58e6", "status_r3"):
        assert tpu not in text
