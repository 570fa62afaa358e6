"""A tiny copy of the benchmark's cells that the CPU can run: the same
drivers, systems and readers on shrunk configurations and mixes, written
to a temporary root."""

from __future__ import annotations

import copy
import json
import os

from benchmark.harness.spec import CHECKOUT

TINY_MODEL = {"resolutions": [8, 16], "level_features": [8, 8]}
TINY_TRAIN = {"crop": 16, "n_chunks": 4}
TINY_SCENE = {"n_views": 4, "img_wh": [24, 24], "gt_steps": 24, "gt_ss": 1}
TINY_VIEW = {"img_wh": [24, 24],
             "orbit": {"views": 6, "radius": 1.2, "rig_seed": 1,
                       "elevation": [0.06, 1.15], "jitter": 0.3},
             "trace_units": 2}
# the CPU runs the plain sweep on both sides: only rounding separates them
TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4,
               "rgb_rms_gap": 1e-5, "grad_diff_median": 1e-4}


def _load(*parts):
    with open(os.path.join(CHECKOUT, *parts)) as f:
        return json.load(f)


def write_root(root: str) -> str:
    """Write ``BENCHMARK.json`` and shrunk configuration and traffic files
    under ``root``; returns it."""
    bench = _load("BENCHMARK.json")
    os.makedirs(os.path.join(root, "benchmark", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "benchmark", "traffic"), exist_ok=True)
    for c in bench["configs"]:
        cfg = _load(c["file"])
        if cfg["family"] == "pyramid":
            cfg["model"].update(TINY_MODEL)
            cfg["train"].update(TINY_TRAIN)
            cfg["scene"].update(TINY_SCENE)
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        t = _load("benchmark", "traffic", f"{w['traffic']}.json")
        t = copy.deepcopy(t)
        if t["kind"] == "view":
            t.update(TINY_VIEW)
        t["trace_units"] = min(int(t["trace_units"]), 2)
        t["limits"] = {k: TINY_LIMITS[k] for k in t["limits"]}
        with open(os.path.join(root, "benchmark", "traffic",
                               f"{w['traffic']}.json"), "w") as f:
            json.dump(t, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
