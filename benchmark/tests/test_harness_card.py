"""On the card: each cell's command as the check runs it, briefly, and the
control at the cell's own size.  Skips without a card (decided inside the
test)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness.spec import CHECKOUT, Spec

CELLS = [w["name"] for w in Spec(CHECKOUT).bench["workloads"]]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_command_on_the_card(cell):
    _need_card()
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 3), "--seconds", "3", "--trace", "1"], cwd=CHECKOUT,
        capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["metrics"] and r["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    _need_card()
    from benchmark.control import control_numbers

    spec = Spec(CHECKOUT)
    limits = spec.traffic(spec.cell(cell)["traffic"])["limits"]
    nums = control_numbers(spec, cell, 31, "cuda")
    assert any(v > float(limits[k]) for k, v in nums.items()), nums
