"""Every cell run on the CPU at a tiny size: the traffic drivers, the
program's timed path and the reference agree; the control and each fault
that a cell can have come out not correct."""

from __future__ import annotations

import contextlib
import json
import os

import pytest
import torch

from benchmark.harness import session
from benchmark.harness.spec import CHECKOUT, PACKAGE_DIR, Spec
from benchmark.tests.tiny import write_root

CELLS = [w["name"] for w in json.load(
    open(os.path.join(CHECKOUT, "BENCHMARK.json")))["workloads"]]


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    torch.set_num_threads(2)
    return Spec(write_root(str(tmp_path_factory.mktemp("tiny"))),
                code_dir=PACKAGE_DIR)


def _run(spec, cell, trace=False, seed=2**31 + 9):
    return session.run_cell(cell, seed, 0.4, trace, "cpu", 0.0, spec)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_agrees(spec, cell, trace):
    r = _run(spec, cell, trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    names = {m["name"] for m in (spec.per_layer(cell) if trace
                                 else spec.end_to_end(cell))}
    if not trace:
        assert set(r["metrics"]) == names
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "cpu"


def test_same_seed_same_inputs(spec):
    cell = CELLS[0]
    a, b = _run(spec, cell, seed=77), _run(spec, cell, seed=77)
    assert a["checks"] == b["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(spec, cell):
    from benchmark.control import control_numbers

    nums = control_numbers(spec, cell, 3, "cpu")
    limits = spec.traffic(spec.cell(cell)["traffic"])["limits"]
    assert any(v > float(limits[k]) for k, v in nums.items()), nums


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class _HalfMean:
    """``torch`` for one module, whose ``mean`` of a crop's rows takes the
    first half of them only."""

    def __init__(self, rows):
        self.rows = rows

    def __getattr__(self, name):
        return getattr(torch, name)

    def mean(self, x, *a, **k):
        if x.dim() >= 1 and x.shape[0] == self.rows:
            x = x[: self.rows // 2]
        return torch.mean(x, *a, **k)


def _faults(spec, cell):
    """The faults this cell can have, each a context that plants it."""
    import taichi_nerfs_torch.render.serve as serve
    import taichi_nerfs_torch.train.swr_step as swr_step

    kind = spec.traffic(spec.cell(cell)["traffic"])["kind"]
    if kind == "train":
        crop = spec.config(spec.cell(cell)["config"])["train"]["crop"]

        def unchanged(self, draw=None):
            return {"loss": torch.tensor(0.5), "psnr": torch.tensor(3.0)}

        return {
            "state unchanged": _patched(swr_step.SwrTrainer, "run_step",
                                        unchanged),
            "half the batch": _patched(swr_step, "torch",
                                       _HalfMean(crop * crop)),
        }
    orig = serve.PyramidRenderer.render

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        out["rgb"] = out["rgb"].clone()
        out["rgb"][7] += 0.05
        return out

    def half(self, *a, **k):
        out = orig(self, *a, **k)
        n = out["rgb"].shape[0]
        out["rgb"] = out["rgb"].clone()
        out["rgb"][n // 2:] = 1.0
        return out

    return {"an answer altered": _patched(serve.PyramidRenderer, "render",
                                          altered),
            "half the frame": _patched(serve.PyramidRenderer, "render", half)}


@pytest.mark.parametrize("cell", CELLS)
def test_faults_come_out_not_correct(spec, cell):
    for name, plant in _faults(spec, cell).items():
        with plant:
            r = _run(spec, cell)
        assert not r["correct"], (name, r["checks"])
