#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Drives the port's serving path (``taichi_nerfs_torch``) through the
record model's configuration at full width on the card, in phases:

1. device: the ``nvidia-smi`` name and power limit; no CUDA device is a
   failure (never a CPU run);
2. build: compile every kernel of the path from ``taichi_nerfs_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   random ragged shapes and at the serving shapes, with timings;
4. slice: ``PyramidRenderer`` renders 4 orbit views at 800x800, capped and
   uncapped, with cubic resampling; the outputs are checked, the kernel's
   launch count during those frames must be > 0, and one view is rendered
   again through the plain sweep and compared.

Prints one JSON line with the kernels' numbers and, last, one JSON line
``{"ok": true, "device": {...}}``.  Any failure raises (exit code != 0).

    python3 chip_smoke.py [--ckpt_path results/model_pyramid.npz]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# the tolerance of kernel against plain sweep: both compute the same fp32
# function, but the kernel sums the 2x2 / 4x4 taps where the plain version
# runs two dense fp32 matmuls, so the additions happen in another order
KERNEL_TOL = 1e-4
# served rgb through the kernel vs through the plain sweep (after the fold,
# the pixel warp and the bf16-operand MLP)
RENDER_TOL = 1e-3
RECORD_WH = (800, 800)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _rand_sweep_inputs(torch, rng, nc, dc, F, R, nq, realistic):
    """Random sweep operands in the style of tests/test_swr_pallas.py.

    ``realistic`` spreads the lattice over the whole source slab as the
    renderer does (step ~ R / (nq - 16), h = 1 / R)."""
    import numpy as np

    vol = rng.normal(0.3, 1.0, (nc, dc, F, R, R)).astype(np.float32)
    if realistic:
        step = R / (nq - 16)
        starts = rng.uniform(-10.0, 0.0, (nc, dc, 2))
        steps = step * rng.uniform(0.9, 1.1, (nc, dc, 2))
        d_lat, h = 1.0 / (nq - 16), 1.0 / R
    else:
        starts = rng.uniform(-1.0, 1.0, (nc, dc, 2))
        steps = rng.uniform(0.7, 1.3, (nc, dc, 2))
        d_lat, h = 0.03, 0.1
    rs = np.stack(
        [starts[..., 0], steps[..., 0], starts[..., 1], steps[..., 1]], -1
    ).astype(np.float32)
    z_rel = np.linspace(1.0, 2.0, nc * dc, dtype=np.float32).reshape(nc, dc)
    ch = np.stack(
        [
            rng.uniform(-0.5, 0.0, nc),
            np.full(nc, d_lat),
            rng.uniform(-0.5, 0.0, nc),
            np.full(nc, d_lat),
            np.full(nc, 1.5),
            np.full(nc, h),
        ],
        axis=-1,
    ).astype(np.float32)
    dev = torch.device("cuda")
    return [torch.as_tensor(a, device=dev) for a in (vol, rs, z_rel, ch)]


def _time_ms(torch, fn, reps):
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return _median(times)


def phase_kernels(torch):
    import numpy as np

    from taichi_nerfs_torch.ops.swr_sweep import (
        chunk_sweep,
        chunk_sweep_reference,
    )

    rng = np.random.default_rng(0)
    worst = 0.0
    timing = {}
    cases = [
        (f"ragged F={F}", dict(nc=2, dc=3, F=F, R=40, nq=37, realistic=False))
        for F in (4, 8, 16)
    ] + [
        (f"serving nq={nq}", dict(nc=1, dc=16, F=8, R=256, nq=nq,
                                  realistic=True))
        for nq in (816, 336)
    ]
    for label, shp in cases:
        nq = shp["nq"]
        args = _rand_sweep_inputs(torch, rng, **shp)
        for kind in ("linear", "cubic"):
            got = chunk_sweep(*args, nq, kind)
            want = chunk_sweep_reference(*args, nq, kind)
            torch.cuda.synchronize()
            d = (got - want).abs()
            max_abs = float(d.max())
            max_rel = max_abs / max(float(want.abs().max()), 1e-30)
            ok = bool(torch.all(d <= KERNEL_TOL + KERNEL_TOL * want.abs()))
            ok = ok and bool(torch.isfinite(got).all())
            print(f"kernel swr_sweep_fwd {label} {kind}: "
                  f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(
                    f"swr_sweep_fwd disagrees with chunk_sweep_reference "
                    f"({label}, {kind}): max_abs={max_abs:.3e} > "
                    f"{KERNEL_TOL} (+{KERNEL_TOL} rel)"
                )
            worst = max(worst, max_abs)
            if label.startswith("serving"):
                k_ms = _time_ms(
                    torch, lambda: chunk_sweep(*args, nq, kind), 20
                )
                p_ms = _time_ms(
                    torch, lambda: chunk_sweep_reference(*args, nq, kind), 10
                )
                timing[(nq, kind)] = (k_ms, p_ms)
                print(f"  time nq={nq} {kind}: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms (median, CUDA events)",
                      flush=True)
    torch.cuda.synchronize()
    return worst, timing


def _record_params(torch, cfg, seed, device):
    """Seeded random record-config params plus a density blob on the finest
    level, so rays see structure and saturate."""
    from taichi_nerfs_torch.models import pyramid as pyr

    gen = torch.Generator().manual_seed(seed)
    params = pyr.init_pyramid_params(cfg, generator=gen, device=device)
    R = cfg.grid_res
    c = (torch.arange(R, dtype=torch.float32, device=device) + 0.5) / R - 0.5
    xx, yy, zz = torch.meshgrid(c, c, c, indexing="ij")
    r = torch.sqrt(xx**2 + yy**2 + zz**2)
    params["levels"][-1][..., 0] += 8.0 * torch.exp(-((r / 0.25) ** 2))
    return params


def phase_slice(torch, ckpt_path, seed):
    from taichi_nerfs_torch.data.cameras import intrinsics, orbit_poses
    from taichi_nerfs_torch.ops.swr_sweep import chunk_sweep
    from taichi_nerfs_torch.render.serve import (
        PyramidRenderer,
        config_for_params,
        record_config,
    )
    from taichi_nerfs_torch.utils.convert import load_pyramid_npz

    device = torch.device("cuda")
    cfg = record_config()
    if ckpt_path and os.path.exists(ckpt_path):
        params = load_pyramid_npz(ckpt_path, device)
        cfg = config_for_params(params, cfg)
        print(f"slice: params from {ckpt_path}", flush=True)
    else:
        params = _record_params(torch, cfg, seed, device)
        print(f"slice: random record-config params, seed {seed}", flush=True)
    w, h = RECORD_WH
    K = intrinsics(w, h)
    rend = PyramidRenderer(params, cfg, K, (w, h), resample_kind="cubic")
    t0 = time.perf_counter()
    grid = rend.grid
    torch.cuda.synchronize()
    print(f"slice: bake {tuple(grid.shape)} in "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms", flush=True)
    poses = orbit_poses(4)
    modes = (("capped", "auto"), ("uncapped", None))
    # one warm-up frame per mode (cuBLAS handles, allocator)
    for _, cap in modes:
        rend.render(poses[0], lat_cap=cap)
    torch.cuda.synchronize()

    chunk_sweep.launches = 0
    frame_ms = {}
    for name, cap in modes:
        per_view = []
        for v, pose in enumerate(poses):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = rend.render(pose, lat_cap=cap)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            rgb, dep, op = out["rgb"], out["depth"], out["opacity"]
            if tuple(rgb.shape) != (w * h, 3) or tuple(op.shape) != (w * h,):
                raise AssertionError(f"bad output shapes {tuple(rgb.shape)}")
            for k, x in (("rgb", rgb), ("depth", dep), ("opacity", op)):
                if not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"{name} view {v}: {k} not finite")
            # the warp's weights are nonnegative and sum to <= 1, so opacity
            # lies in [0, 1] up to fp32 rounding
            lo, hi = float(op.min()), float(op.max())
            if lo < -1e-6 or hi > 1.0 + 1e-6:
                raise AssertionError(f"{name} view {v}: opacity in "
                                     f"[{lo}, {hi}]")
            if hi <= 0.9:
                raise AssertionError(f"{name} view {v}: max opacity {hi}")
            per_view.append(_median(times))
            print(f"slice {name} view {v}: {_median(times):.3f} ms/frame "
                  f"(median of 3), max opacity {hi:.4f}", flush=True)
        frame_ms[name] = _median(per_view)
    torch.cuda.synchronize()
    launches = chunk_sweep.launches
    print(f"slice: chunk_sweep.launches during the served frames: "
          f"{launches}", flush=True)
    if launches <= 0:
        raise AssertionError("the served frames never launched the kernel")

    # one view again through the plain sweep
    for name, cap in modes:
        a = rend.render(poses[0], lat_cap=cap)
        rend.sweep_impl = "reference"
        b = rend.render(poses[0], lat_cap=cap)
        rend.sweep_impl = "auto"
        torch.cuda.synchronize()
        d = float((a["rgb"] - b["rgb"]).abs().max())
        print(f"slice {name} view 0: rgb kernel vs plain sweep max_abs="
              f"{d:.3e}", flush=True)
        if not d <= RENDER_TOL:
            raise AssertionError(f"{name}: rgb differs by {d} > {RENDER_TOL}")
    return launches, frame_ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt_path", default="",
                    help="model_pyramid.npz to serve instead of random "
                         "params (used when the file exists)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test runs on a CUDA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from taichi_nerfs_torch.ops import _build

    path, log, secs = _build.build("swr_sweep_fwd")
    _build.load("swr_sweep_fwd")
    built = f"in {secs:.2f} s" if log else "(already built)"
    print(f"build: {os.path.relpath(path)} {built}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    worst, timing = phase_kernels(torch)
    launches, frame_ms = phase_slice(torch, args.ckpt_path, args.seed)
    print(f"slice: 800x800 cubic frame median: capped "
          f"{frame_ms['capped']:.3f} ms, uncapped "
          f"{frame_ms['uncapped']:.3f} ms", flush=True)

    k_ms, p_ms = timing[(816, "cubic")]
    print(json.dumps({"kernels": [{
        "name": "swr_sweep_fwd",
        "route": "cuda",
        "source": "taichi_nerfs_torch/csrc/swr_sweep_fwd.cu",
        "replaces": "taichi_nerfs_tpu/ops/swr_pallas.py:116",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
