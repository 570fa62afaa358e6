"""The port's notebooks, executed from their JSON on the CPU.

``notebooks/torch_autodiff.ipynb`` and ``notebooks/torch_pipeline.ipynb``
run cell for cell against the JAX notebooks.  Their first code cell names
the device (the card); here it is replaced by its CPU value and the code
cells run with ``exec`` in one namespace, as ``chip_smoke.py`` runs them on
the card (whose machine has no jupyter).
"""

import json
import os

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each notebook's first code cell on the CPU: the autodiff timing at 2^14
# samples (2^19 on the card)
_CPU_CELL = {"torch_autodiff": 'DEVICE, M = "cpu", 1 << 14',
             "torch_pipeline": 'DEVICE = "cpu"'}


def _code_cells(name):
    with open(os.path.join(REPO, "notebooks", f"{name}.ipynb")) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


@pytest.mark.parametrize("name", sorted(_CPU_CELL))
def test_notebook_runs_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    """Every code cell runs; the first names the card, as the notebook
    ships.  The autodiff gradient agrees with its finite difference within
    1e-2 (fp32 sums over 8192 terms, eps 1e-3); the pipeline's three
    steps give finite metrics."""
    cells = _code_cells(name)
    assert cells[0].splitlines()[-1].startswith(
        _CPU_CELL[name].split("=")[0] + "= \"cuda\"")
    monkeypatch.chdir(tmp_path)
    ns = {}
    for i, src in enumerate([_CPU_CELL[name]] + cells[1:]):
        exec(compile(src, f"{name}.ipynb[{i}]", "exec"), ns)
    out = capsys.readouterr().out
    assert ns["device"] == torch.device("cpu")
    if name == "torch_autodiff":
        assert abs(float(ns["flat"][ns["k"]]) - float(ns["fd"])) < 1e-2
        assert "forward: " in out and "fwd+bwd: " in out
    else:
        assert ns["trainer"].step == 3
        assert all(np.isfinite(float(v)) for v in ns["metrics"].values())
