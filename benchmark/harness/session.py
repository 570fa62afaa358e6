"""One run of one cell: what ``benchmark/run.py`` does once the card is
found, and what the harness's tests drive on the CPU.

The cell's traffic kind (``benchmark/traffic/<kind>.py``) sets up, measures
its window and checks the program's outputs against the plain reference; it
returns an :class:`Outcome`.  This module turns that into the result:
the end-to-end metrics with ``--trace 0``, the per-layer metrics (each from
its reader) with ``--trace 1``.
"""

from __future__ import annotations

import gc
import sys
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from . import device as dev
from .spec import Spec


@dataclass
class Run:
    """What a driver is given."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    spec: Spec


@dataclass
class Outcome:
    """What a driver returns.  ``values``: the end-to-end numbers by metric
    name; ``checks``: each number compared, ``name -> (value, limit)``;
    ``reading``: the traced sub-window (:class:`trace.Reading`) or None;
    ``breakdown``: its top device operations and idle gaps; ``build_s``:
    the seconds of set-up in which ``nvcc`` built the program's kernels."""

    attempted: int
    failed: int
    values: Dict[str, float]
    checks: Dict[str, Tuple[float, float]]
    memory_peak: int
    reading: Optional[object] = None
    breakdown: Optional[dict] = None
    build_s: float = 0.0


def release() -> None:
    """Free what the program held on the device."""
    gc.collect()
    try:
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    except ImportError:
        pass


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, spec: Optional[Spec] = None) -> dict:
    """Run cell ``name`` once; returns the result object (see
    ``benchmark/README.md``)."""
    spec = spec or Spec()
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    run = Run(cell, config, traffic, int(seed), float(seconds), bool(trace),
              device, t_start, spec)
    out: Outcome = spec.driver(traffic["kind"]).run(run)
    metrics = {}
    if trace:
        if out.reading is not None:
            for m in spec.per_layer(name):
                value = spec.reader(m["name"]).read(out.reading)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
    else:
        for m in spec.end_to_end(name):
            metrics[m["name"]] = {"value": float(out.values[m["name"]]),
                                  "unit": m["unit"]}
    info = dev.describe(device, int(cell["chips"]))
    info["memory_peak_bytes"] = int(out.memory_peak)
    if trace and out.reading is not None:
        info["busy_s"] = out.reading.busy_s
        info["window_s"] = out.reading.window_s
    checks = {k: {"value": float(v), "limit": float(lim)}
              for k, (v, lim) in out.checks.items()}
    correct = (out.failed == 0 and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": info}
    if trace and out.breakdown is not None:
        result["breakdown"] = out.breakdown
    # the part of setup_s that built kernels (0 once a checkout has them)
    result["build_s"] = float(out.build_s)
    result["checks"] = checks
    return result


def check_lines(result: dict) -> str:
    """The numbers compared, one a line, beside their limits."""
    lines = [f"build_s (nvcc, inside setup_s): {result['build_s']!r}"]
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in result["checks"].items()]
    lines.append(f"correct: {result['correct']} (attempted "
                 f"{result['attempted']}, failed {result['failed']})")
    return "\n".join(lines)


def forbidden_or_exit() -> None:
    """Exit 3, naming them, if JAX or the JAX package were loaded."""
    bad = dev.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        sys.exit(3)
