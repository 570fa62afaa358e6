"""The benchmark's files against its contract: every name resolves to its
file, names and units keep to their characters, no file loads JAX or the
JAX package, the reference loads nothing of the program, and a cell or a
model family added as new files alone runs."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.harness.spec import CHECKOUT, PACKAGE_DIR, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "taichi_nerfs_tpu"}


@pytest.fixture(scope="module")
def spec():
    return Spec(CHECKOUT)


def test_top_level_keys(spec):
    b = spec.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert b["command"][:2] == ["python3", "benchmark/run.py"]
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_resolves(spec):
    configs = {c["name"] for c in spec.bench["configs"]}
    pairs = set()
    for w in spec.bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        t = spec.traffic(w["traffic"])
        assert os.path.exists(spec.code("traffic", f"{t['kind']}.py"))
        cfg = spec.config(w["config"])
        assert os.path.exists(spec.code("systems", f"{cfg['family']}.py"))
        assert set(t["limits"]) and all(v > 0 for v in t["limits"].values())
        assert 1 <= len(w["why"]) <= 200
    used = {w["config"] for w in spec.bench["workloads"]}
    assert used == configs


def test_every_family_has_its_files(spec):
    for c in spec.bench["configs"]:
        fam = spec.config(c["name"])["family"]
        for parts in (("systems",), ("reference",), ("tests", "families")):
            assert os.path.exists(spec.code(*parts, f"{fam}.py")), (fam, parts)


def test_configs(spec):
    files = set()
    for c in spec.bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = spec.config(c["name"])
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200


def test_metrics(spec):
    cells = {w["name"] for w in spec.bench["workloads"]}
    names = set()
    e2e = {m["name"]: m for m in spec.bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in spec.bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in cells:
        reported = {m["name"] for m in spec.end_to_end(cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(cell)
    for m in spec.bench["per_layer"]:
        assert os.path.exists(spec.code("metrics", f"{m['name']}.py"))
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in spec.end_to_end(cell)}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(PACKAGE_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_and_no_program_in_the_reference():
    seen = 0
    for path in _sources():
        tops = set(_imports(path))
        assert not tops & FORBIDDEN, path
        if os.sep + "reference" + os.sep in path:
            assert "taichi_nerfs_torch" not in tops, path
        seen += 1
    assert seen > 10


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_command_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(["benchmark/run.py", "--workload", "pyramid_r256_f8.train",
              "--seed", "1", "--seconds", "1", "--trace", "0"], CHECKOUT, env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "cuda" in p.stderr.lower()


def test_command_fails_without_the_program(tmp_path):
    import shutil

    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PACKAGE_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["benchmark/run.py", "--workload", "pyramid_r256_f8.train",
              "--seed", "1", "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_cell_of_new_files_alone_runs(tmp_path):
    """A cell, a traffic mix and a per-layer metric added as new files and
    BENCHMARK.json entries to a copy of the benchmark, whose own drivers,
    systems and readers run them."""
    import shutil

    from benchmark.harness import session
    from benchmark.tests.tiny import write_root

    root = write_root(str(tmp_path))
    shutil.copytree(PACKAGE_DIR, os.path.join(root, "benchmark"),
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "configs",
                                                  "*.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    t = json.load(open(os.path.join(root, "benchmark", "traffic",
                                    "orbit_uncapped.json")))
    t["orbit"]["elevation"] = [0.5, 0.7]
    json.dump(t, open(os.path.join(root, "benchmark", "traffic",
                                   "orbit_high.json"), "w"))
    with open(os.path.join(root, "benchmark", "metrics",
                           "frames_profiled.view.py"), "w") as f:
        f.write("def read(r):\n    return r.units if r.kind == 'view' "
                "else None\n")
    cell = "pyramid_r256_f8.view_high"
    bench["workloads"].append({"name": cell, "config": "pyramid_r256_f8",
                               "traffic": "orbit_high", "chips": 1,
                               "why": "a dummy cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "frames_profiled.view", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "serving",
        "moves": "frames_per_s", "workloads": [cell]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    spec = Spec(root)
    assert spec.code_dir == os.path.join(root, "benchmark")
    assert spec.traffic("orbit_high")["orbit"]["elevation"] == [0.5, 0.7]
    r = session.run_cell(cell, 5, 0.5, True, "cpu", 0.0, spec)
    assert r["correct"]
    assert r["metrics"]["frames_profiled.view"]["value"] == 2


def _hashes(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _grown_only(old, new):
    """``new`` keeps every entry of ``old`` as it was, but for cells
    appended to a metric's ``workloads``."""
    for key, value in old.items():
        if key not in ("configs", "workloads", "end_to_end", "per_layer"):
            assert new[key] == value, key
            continue
        grown = {e["name"]: e for e in new[key]}
        for e in value:
            g = dict(grown[e["name"]])
            if "workloads" in e:
                assert g["workloads"][:len(e["workloads"])] == e["workloads"]
                g["workloads"] = e["workloads"]
            assert g == e, (key, e["name"])


TWIN = "pyramid_twin"
TWIN_FILES = {
    ("systems", f"{TWIN}.py"):
        '"""The dense pyramid under a second family name."""\n'
        "from benchmark.systems.pyramid import (  # noqa: F401\n"
        "    TrainSession, ViewSession)\n",
    ("reference", f"{TWIN}.py"):
        "from benchmark.reference.pyramid import (  # noqa: F401\n"
        "    PyramidReference)\n",
    ("tests", "families", f"{TWIN}.py"):
        "from benchmark.tests.families.pyramid import (  # noqa: F401\n"
        "    LIMITS, faults, shrink_config, shrink_traffic)\n",
}


def _family_copy(top, family_files):
    """A copy of the benchmark under ``top`` with a family ``TWIN`` added as
    the new files ``family_files`` (path parts under ``benchmark/`` ->
    text), a configuration of it and one training cell; returns the
    copy's code directory, its hashes before the addition, its
    ``BENCHMARK.json`` before and the cell's name."""
    import shutil

    code = os.path.join(top, "benchmark")
    shutil.copytree(PACKAGE_DIR, code,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), top)
    before = _hashes(code)
    with open(os.path.join(top, "BENCHMARK.json")) as f:
        bench = json.load(f)
    old = json.loads(json.dumps(bench))
    for parts, text in family_files.items():
        with open(os.path.join(code, *parts), "w") as f:
            f.write(text)
    base = Spec(top).bench["configs"][0]
    cfg = Spec(top).config(base["name"])
    cfg["family"] = TWIN
    with open(os.path.join(code, "configs", f"{TWIN}.json"), "w") as f:
        json.dump(cfg, f)
    bench["configs"].append(dict(base, name=TWIN,
                                 file=f"benchmark/configs/{TWIN}.json"))
    train = next(w for w in bench["workloads"] if w["config"] == base["name"]
                 and Spec(top).traffic(w["traffic"])["kind"] == "train")
    cell = f"{TWIN}.train"
    bench["workloads"].append(dict(train, name=cell, config=TWIN,
                                   why="the first family's training cell "
                                       "under a second family"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if train["name"] in m.get("workloads", ()):
            m["workloads"].append(cell)
    with open(os.path.join(top, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return code, before, old, cell


def test_a_family_of_new_files_alone_runs(tmp_path):
    """A second model family added as new files and BENCHMARK.json entries
    to a copy of the benchmark: on the CPU its cell runs and agrees with
    the reference, its control fails and each of its faults comes out not
    correct, and no file that was there has changed."""
    import torch

    from benchmark.tests import test_harness_cpu as cpu
    from benchmark.tests.tiny import write_root

    torch.set_num_threads(2)
    src = str(tmp_path / "src")
    code, before, old, cell = _family_copy(src, TWIN_FILES)
    spec = Spec(write_root(str(tmp_path / "tiny"), src, code), code_dir=code)
    assert spec.config(spec.cell(cell)["config"])["family"] == TWIN
    assert spec.system(TWIN).__file__ == os.path.join(
        code, "systems", f"{TWIN}.py")
    cpu.test_cell_runs_and_agrees(spec, cell, False)
    cpu.test_control_fails(spec, cell)
    cpu.test_faults_come_out_not_correct(spec, cell)
    after = _hashes(code)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) >= {
        os.path.join(*p) for p in TWIN_FILES}
    with open(os.path.join(src, "BENCHMARK.json")) as f:
        _grown_only(old, json.load(f))


@pytest.mark.parametrize("lacks", ["its file", "a limit"])
def test_write_root_names_what_a_family_lacks(tmp_path, lacks):
    from benchmark.tests.tiny import write_root

    files = dict(TWIN_FILES)
    family_file = ("tests", "families", f"{TWIN}.py")
    if lacks == "its file":
        del files[family_file]
    else:
        files[family_file] += "LIMITS = {}\n"
    src = str(tmp_path / "src")
    code = _family_copy(src, files)[0]
    with pytest.raises((FileNotFoundError, KeyError)) as e:
        write_root(str(tmp_path / "tiny"), src, code)
    assert os.path.join(code, *family_file) in str(e.value)
