"""Every cell run on the CPU at a tiny size: the traffic drivers, the
program's timed path and the reference agree; the control and each fault
that a cell can have come out not correct."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark.harness import session
from benchmark.harness.spec import CHECKOUT, PACKAGE_DIR, Spec
from benchmark.tests.tiny import family, write_root

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


def _faults(spec, cell):
    """The faults this cell can have, each a context that plants it: its
    family's, two or more."""
    name = spec.config(spec.cell(cell)["config"])["family"]
    faults = family(spec, name).faults(spec, cell)
    assert len(faults) >= 2, (name, cell, sorted(faults))
    return faults


@pytest.mark.parametrize("cell", CELLS)
def test_faults_come_out_not_correct(spec, cell):
    for name, plant in _faults(spec, cell).items():
        with plant:
            r = _run(spec, cell)
        assert not r["correct"], (name, r["checks"])
