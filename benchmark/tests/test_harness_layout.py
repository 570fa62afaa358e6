"""The benchmark's files against its contract: every name resolves to its
file, names and units keep to their characters, no file loads JAX or the
JAX package, the reference loads nothing of the program, and a cell added
as new files alone runs."""

from __future__ import annotations

import ast
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
                                    "orbit_capped.json")))
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
        if m["name"] in ("frames_per_s", "frame_ms_p95"):
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
