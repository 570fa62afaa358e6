#!/usr/bin/env python3
"""Host cost of the sweep's Python route on the card: this tree's
``ops/swr_sweep.py`` against other versions of that file (for example the
parent commit's, whose ``chunk_sweep`` was a ``torch.autograd.Function``
where this tree calls registered operators), the kernels the same.

For each route, in the order given and then reversed, it prints:

- the host time of one call at a tiny shape (1 chunk, 1 slab, 8^2), the
  forward alone and the forward with its backward, over 2,000 calls (the
  card finishes each launch before the host queues the next);
- the first forward and backward in a fresh process, after CUDA and the
  kernel libraries are up: the route's one-time cost;
- 12 capped and 12 uncapped 800x800 frames of the record configuration
  (``PyramidRenderer``, cubic, early exit 1e-4: up to 16 sweep calls a
  frame), median, min and max;
- 10 full-depth record steps (crop 256, cubic, 16 chunks: one forward and
  one backward call a step) on 8 checker views at 256x256;

beside the card's name and power limit::

    mkdir -p ab && git show HEAD~1:taichi_nerfs_torch/ops/swr_sweep.py \\
        > ab/swr_sweep.py
    python3 scripts/torch_sweep_route_ab.py --version parent=ab/swr_sweep.py

An older version must not register the operators itself (one process
registers them once).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the first call in a fresh process: argv is the repo and the version's path
# ("" for this tree's module)
_FIRST_CALL = """
import importlib.util, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as c
if sys.argv[2]:
    spec = importlib.util.spec_from_file_location(
        "taichi_nerfs_torch.ops._route", sys.argv[2])
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
else:
    from taichi_nerfs_torch.ops import swr_sweep as m
from taichi_nerfs_torch.ops import _build
for name in _build.kernel_names():
    _build.load(name)
args = c._rand_sweep_inputs(torch, np.random.default_rng(0), 1, 1, 8, 8, 8,
                            False)
torch.cuda.synchronize()
v = args[0].requires_grad_(True)
t0 = time.perf_counter()
m.chunk_sweep(v, *args[1:], 8, "cubic").sum().backward()
torch.cuda.synchronize()
print((time.perf_counter() - t0) * 1e3)
"""


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(
        f"taichi_nerfs_torch.ops._route_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spread(ms) -> str:
    return (f"median {np.median(ms):.3f} ms (min {min(ms):.3f}, max "
            f"{max(ms):.3f})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another version of ops/swr_sweep.py")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_sweep_route_ab: needs a CUDA device")
    sys.path.insert(0, _REPO)
    import chip_smoke as c
    import taichi_nerfs_torch.render.swr as rswr
    from taichi_nerfs_torch.data.cameras import intrinsics, orbit_poses
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.ops import swr_sweep
    from taichi_nerfs_torch.render.serve import PyramidRenderer, record_config
    from taichi_nerfs_torch.train.swr_step import SwrTrainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    c.phase_build()
    paths = {"new": ""}
    routes = {"new": swr_sweep.chunk_sweep}
    for spec in args.version:
        name, path = spec.split("=", 1)
        paths[name] = os.path.abspath(path)
        routes[name] = _load(name, paths[name]).chunk_sweep
    order = list(routes) + list(routes)[::-1]
    dev = torch.device("cuda")

    tiny = c._rand_sweep_inputs(torch, np.random.default_rng(0), 1, 1, 8, 8,
                                8, False)
    for name in order:
        fn = routes[name]
        for grad in (False, True):
            v = tiny[0].clone().requires_grad_(grad)

            def call():
                out = fn(v, *tiny[1:], 8, "cubic")
                if grad:
                    out.sum().backward()

            for _ in range(50):
                call()
            torch.cuda.synchronize()
            n = 2000
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            print(f"route {name}: host time a call, "
                  f"{'forward and backward' if grad else 'forward'}: "
                  f"{(time.perf_counter() - t0) / n * 1e6:.2f} us ({card})",
                  flush=True)
    for name in order:
        r = subprocess.run([sys.executable, "-c", _FIRST_CALL, _REPO,
                            paths[name]], capture_output=True, text=True,
                           timeout=600, cwd=_REPO)
        if r.returncode != 0:
            raise RuntimeError(f"route {name}: {r.stderr[-2000:]}")
        print(f"route {name}: the first forward and backward in a fresh "
              f"process {float(r.stdout.split()[-1]):.3f} ms ({card})",
              flush=True)

    cfg = record_config()
    rend = PyramidRenderer(c._record_params(torch, cfg, 0, dev), cfg,
                           intrinsics(800, 800), (800, 800),
                           resample_kind="cubic")
    poses = orbit_poses(4)
    for name in order:
        rswr.chunk_sweep = routes[name]
        for mode, cap in (("capped", "auto"), ("uncapped", None)):
            for p in poses[:2]:
                rend.render(p, lat_cap=cap)
            torch.cuda.synchronize()
            ms = []
            for i in range(12):
                t0 = time.perf_counter()
                rend.render(poses[i % 4], lat_cap=cap)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            print(f"route {name}: 800x800 {mode} frames {_spread(ms)} "
                  f"({card})", flush=True)
    del rend

    ds = SyntheticSphereDataset(n_images=8, img_wh=(256, 256),
                                variant="checker", device=dev)
    _, mcfg, tcfg = c._parallel_configs()
    trainer = SwrTrainer(mcfg, tcfg, ds.rays, ds.poses, ds.K, ds.img_wh,
                         seed=0, alphas=ds.alphas, device=dev)
    for name in order:
        rswr.chunk_sweep = routes[name]
        for _ in range(2):
            float(trainer.run_step()["loss"])
        ms = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(trainer.run_step()["loss"])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"route {name}: full-depth record steps {_spread(ms)} "
              f"({card})", flush=True)
    rswr.chunk_sweep = swr_sweep.chunk_sweep
    return 0


if __name__ == "__main__":
    sys.exit(main())
