"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix and the metrics.  A configuration is the JSON file its
entry names; a traffic mix is ``benchmark/traffic/<traffic>.json``, whose
``kind`` names the driver ``benchmark/traffic/<kind>.py``; a configuration's
``family`` names the adapter ``benchmark/systems/<family>.py``; a per-layer
metric is read by ``benchmark/metrics/<metric>.py``.  Data files are read
under the root given, code files under ``<root>/benchmark`` unless another
code directory is given (the tests' tiny cells: data in a temporary root,
the code of this package).
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PACKAGE_DIR)


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root``."""

    def __init__(self, root: str = CHECKOUT, code_dir: str | None = None):
        self.root = root
        self.code_dir = code_dir or os.path.join(root, "benchmark")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        path = os.path.join(self.root, "benchmark", "traffic", f"{name}.json")
        with open(path) as f:
            return json.load(f)

    def _applies(self, metric: dict, cell: str, moves_ok=None) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return moves_ok is None or moves_ok(metric)

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics this cell reports: those listing it, and
        those without a list whose ``moves`` the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if self._applies(m, cell, lambda m: m["moves"] in e2e)]

    def code(self, *parts: str) -> str:
        """The path of a code file under the code directory."""
        return os.path.join(self.code_dir, *parts)

    def module(self, *parts: str):
        """Load a code file by path (its name may hold dots)."""
        path = self.code(*parts)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        name = "benchmark_file_" + hashlib.sha256(
            os.path.abspath(path).encode()).hexdigest()[:16]
        if name in sys.modules:
            return sys.modules[name]
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod

    def driver(self, kind: str):
        return self.module("traffic", f"{kind}.py")

    def system(self, family: str):
        return self.module("systems", f"{family}.py")

    def reader(self, metric: str):
        return self.module("metrics", f"{metric}.py")
