"""A tiny copy of the benchmark's cells that the CPU can run: the same
drivers, systems and readers on shrunk configurations and mixes, written
to a temporary root.

What a model family's cells shrink to, their tiny limits and the faults
they can have are the family's: ``tests/families/<family>.py`` under the
code directory, found by a configuration's ``family`` as its
``systems/<family>.py`` is.  It defines ``shrink_config(config)``,
``shrink_traffic(traffic)``, ``LIMITS`` (the tiny limit of each limit name
its mixes use) and ``faults(spec, cell)`` (a context that plants each
fault, by name).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os

from benchmark.harness.spec import CHECKOUT, PACKAGE_DIR, Spec


def family(spec: Spec, name: str):
    """The CPU tests' file of model family ``name``; raises
    ``FileNotFoundError`` naming its path where there is none."""
    return spec.module("tests", "families", f"{name}.py")


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _dump(obj, *parts):
    with open(os.path.join(*parts), "w") as f:
        json.dump(obj, f)


def write_root(root: str, src: str = CHECKOUT,
               code_dir: str = PACKAGE_DIR) -> str:
    """Write ``BENCHMARK.json`` and shrunk configuration and traffic files
    of the checkout at ``src`` under ``root``, each shrunk by its family's
    file under ``code_dir``; returns ``root``."""
    spec = Spec(src, code_dir=code_dir)
    bench = spec.bench
    os.makedirs(os.path.join(root, "benchmark", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "benchmark", "traffic"), exist_ok=True)
    families = {}
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        families[c["name"]] = fam = family(spec, cfg["family"])
        _dump(fam.shrink_config(cfg), root, c["file"])
    mixes = {}
    for w in bench["workloads"]:
        fam = families[w["config"]]
        t = fam.shrink_traffic(copy.deepcopy(spec.traffic(w["traffic"])))
        t["trace_units"] = min(int(t["trace_units"]), 2)
        missing = set(t["limits"]) - set(fam.LIMITS)
        if missing:
            raise KeyError(f"{fam.__file__} defines no LIMITS for "
                           f"{sorted(missing)} of mix {w['traffic']!r}")
        t["limits"] = {k: fam.LIMITS[k] for k in t["limits"]}
        if mixes.setdefault(w["traffic"], t) != t:
            raise ValueError(f"mix {w['traffic']!r} shrinks differently "
                             f"for the families of its cells")
        _dump(t, root, "benchmark", "traffic", f"{w['traffic']}.json")
    _dump(bench, root, "BENCHMARK.json")
    return root
