#!/usr/bin/env python3
"""Compare versions of the port's sweep forward kernel on one card.

Builds ``taichi_nerfs_torch/csrc/swr_sweep_fwd.cu`` ("new") and other
versions of the same source (``--version NAME=PATH``, e.g. the file as an
earlier commit has it), each with its own ``nvcc`` run and the package's
flags, binds each through their identical C entry, and at each of
``chip_smoke.FWD_TIMED``'s shapes, linear
and cubic, on the same random inputs as ``chip_smoke.py``:
  * holds each against the plain sweep (``chip_smoke.KERNEL_TOL``) and
    prints the largest difference of each from "new";
  * times each warm and cold with ``chip_smoke._time_ms``, the versions in
    one order and then in the reverse order, and prints each version's two
    medians per mode beside the bound and its share of it.

With ``--frames`` it then renders the record model's 800x800 orbit
(``chip_smoke.py``'s random params, 4 views, cubic) capped and uncapped
with each version in the renderer, in the same two orders: the median frame
time (host clock, ending in a synchronize), and from one profiled pass the
device time per frame of the ``swr.*`` spans and the card's busy share; and
the range of the resample steps the frames' slabs take.

Ends with one JSON line of the times (the mean of the two medians).  Needs
a CUDA device::

    git show <commit>:taichi_nerfs_torch/csrc/swr_sweep_fwd.cu \\
        > build/parent/swr_sweep_fwd.cu
    python3 scripts/torch_sweep_fwd_ab.py \\
        --version parent=build/parent/swr_sweep_fwd.cu
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def bind_version(path):
    """``swr_sweep_fwd`` of the source ``path``, built into the package's
    build directory with its flags and bound as the package binds it."""
    from taichi_nerfs_torch.ops import _build

    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_build.NVCC_FLAGS)
                                .encode()).hexdigest()[:16]
    out = os.path.join(_build.BUILD_DIR, f"libswr_sweep_fwd-ab-{digest}.so")
    if not os.path.exists(out):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out,
                        path], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(out).swr_sweep_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    return fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another version of csrc/swr_sweep_fwd.cu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", action="store_true",
                    help="also render the record frames with each version")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from taichi_nerfs_torch.ops import swr_sweep as sw

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    fns = {}
    for spec in args.version:
        name, path = spec.split("=", 1)
        fns[name] = bind_version(os.path.abspath(path))
    fns["new"] = sw._kernel_fn("swr_sweep_fwd")

    def run(version, vol, rs, z_rel, ch, nq, kind):
        nc, dc, F, Rb, Rc = vol.shape
        out = torch.empty((nc, F + 2, nq, nq), dtype=torch.float32,
                          device=vol.device)
        rc = fns[version](
            vol.data_ptr(), rs.data_ptr(), z_rel.data_ptr(), ch.data_ptr(),
            out.data_ptr(), nc, dc, F, Rb, Rc, nq, sw._KINDS[kind],
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{version} kernel launch failed: {rc}")
        return out

    rng = np.random.default_rng(args.seed)
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    results = {}
    for label, (nc, dc, F, R, nq) in cs.FWD_TIMED:
        a = cs._rand_sweep_inputs(torch, rng, nc, dc, F, R, nq, True)
        for kind in ("linear", "cubic"):
            want = sw.chunk_sweep_reference(*a, nq, kind)
            got = {v: run(v, *a, nq, kind) for v in fns}
            torch.cuda.synchronize()
            for v, x in got.items():
                d = (x - want).abs()
                if not bool(torch.all(d <= cs.KERNEL_TOL
                                      + cs.KERNEL_TOL * want.abs())):
                    raise AssertionError(f"{v} kernel disagrees with the "
                                         f"plain sweep ({label}, {kind})")
            diff = {v: float((x - got["new"]).abs().max())
                    for v, x in got.items() if v != "new"}
            del want, got
            t = {v: {"warm": [], "cold": []} for v in fns}
            for v in list(fns) + list(fns)[::-1]:
                for mode, fl in (("warm", None), ("cold", flush)):
                    t[v][mode].append(cs._time_ms(
                        torch, lambda v=v: run(v, *a, nq, kind), 20, fl))
            bound, by, _, _ = cs.sweep_fwd_bound(nc, dc, F, R, R, nq, kind)
            key = f"{label} {kind}"
            results[key] = {v: {m: float(np.mean(x)) for m, x in tv.items()}
                            for v, tv in t.items()}
            results[key]["bound"] = bound
            print(f"{key}: bound {bound:.4f} ms ({by}); max |diff| from new "
                  + ", ".join(f"{v} {d:.3e}" for v, d in diff.items()),
                  flush=True)
            for v in fns:
                w, c = t[v]["warm"], t[v]["cold"]
                print(f"  {v}: warm {w[0]:.4f} / {w[1]:.4f} ms, cold "
                      f"{c[0]:.4f} / {c[1]:.4f} ms; share of the bound warm "
                      f"{bound / np.mean(w):.1%}, cold {bound / np.mean(c):.1%}",
                      flush=True)
        del a
    del flush
    out = {"device": torch.cuda.get_device_name(0), "sweep_fwd_ms": results}
    if args.frames:
        out["frames"] = frames(torch, cs, sw, fns, args.seed)
    print(json.dumps(out), flush=True)


def frames(torch, cs, sw, fns, seed):
    """Record frames rendered with each version of the kernel in turn (the
    renderer's kernel lookup is pointed at it); returns, per version and
    mode, the median frame ms, the swr.* spans' device ms per frame and the
    busy share."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from taichi_nerfs_torch.data.cameras import intrinsics, orbit_poses
    from taichi_nerfs_torch.render import swr as rswr
    from taichi_nerfs_torch.render.serve import PyramidRenderer, record_config

    cfg = record_config()
    w, h = cs.RECORD_WH
    rend = PyramidRenderer(cs._record_params(torch, cfg, seed, "cuda"), cfg,
                           intrinsics(w, h), (w, h), resample_kind="cubic")
    poses = orbit_poses(4)
    modes = (("capped", "auto"), ("uncapped", None))

    # the slabs' resample parameters, from one pass that records them
    real_sweep, seen = rswr.chunk_sweep, []

    def recording(vol, rs, *rest):
        seen.append(rs.reshape(-1, 4))
        return real_sweep(vol, rs, *rest)

    rswr.chunk_sweep = recording
    for name, cap in modes:
        for pose in poses:
            rend.render(pose, lat_cap=cap)
        rs = torch.cat(seen)
        st, s0 = rs[:, 1::2].abs(), rs[:, 0::2]
        print(f"frames {name}: |step| of the swept slabs "
              f"{float(st.min()):.3f} to {float(st.max()):.3f} voxels, "
              f"start {float(s0.min()):.1f} to {float(s0.max()):.1f}",
              flush=True)
        seen.clear()
    rswr.chunk_sweep = real_sweep

    built = sw._kernel_fn
    current = ["new"]
    sw._kernel_fn = lambda name: (
        fns[current[0]] if name == "swr_sweep_fwd" else built(name))
    res = {}
    try:
        for v in list(fns) + list(fns)[::-1]:
            current[0] = v
            for name, cap in modes:
                rend.render(poses[0], lat_cap=cap)  # warm-up
                times = []
                for pose in poses:
                    for _ in range(3):
                        t0 = time.perf_counter()
                        rend.render(pose, lat_cap=cap)
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - t0) * 1e3)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for pose in poses:
                        rend.render(pose, lat_cap=cap)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
                avgs = prof.key_averages()
                busy = sum(e.self_device_time_total for e in avgs
                           if e.device_type == DeviceType.CUDA
                           and not e.is_user_annotation)
                spans = {e.key: e.device_time_total / 1e3 / len(poses)
                         for e in avgs if e.key.startswith("swr.")}
                r = res.setdefault(v, {}).setdefault(name, [])
                r.append({"frame_ms": float(np.median(times)),
                          "busy": busy / wall_us, "span_ms": spans})
                print(f"frames {name} {v}: median {np.median(times):.3f} ms;"
                      f" busy {100 * busy / wall_us:.1f}%; device ms per "
                      "frame " + ", ".join(f"{k} {x:.3f}" for k, x in
                                           sorted(spans.items())),
                      flush=True)
    finally:
        sw._kernel_fn = built
    return res


if __name__ == "__main__":
    main()
