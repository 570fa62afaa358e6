#!/usr/bin/env python3
"""Compare versions of the port's sweep kernels on one card.

``--kernel fwd`` (the default) builds
``taichi_nerfs_torch/csrc/swr_sweep_fwd.cu`` ("new") and other versions of
the same source (``--version NAME=PATH``, e.g. the file as an earlier commit
has it), each with its own ``nvcc`` run and the package's flags, binds each
through their C entry, and at each of ``chip_smoke.FWD_TIMED``'s shapes,
linear and cubic, on the same random inputs as ``chip_smoke.py``:
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

``--kernel bwd`` does the same for ``csrc/swr_sweep_bwd.cu`` at the three
training shapes (``chip_smoke.TRAIN_SHAPES``, 16 chunks, F=8), linear and
cubic, on ``chip_smoke.py``'s backward inputs: each version against
autograd of the plain sweep (``chip_smoke.BWD_TOL``), the largest
difference from "new", whether two runs of each give the same bits, the
warm and cold medians in the order given and reversed, and the device time
of each kernel that a version launches (``torch.profiler``), which splits
a version of two launches (the first, with its ``dx2`` scratch) into its
parts.  A version whose C entry still takes the ``dx2`` scratch gets one;
every version runs fp32 (a C entry with dtype codes gets the fp32 codes).

Ends with one JSON line of the times (the mean of the two medians).  Needs
a CUDA device::

    mkdir -p ab && git show <commit>:taichi_nerfs_torch/csrc/swr_sweep_fwd.cu \\
        > ab/swr_sweep_fwd.cu
    python3 scripts/torch_sweep_fwd_ab.py --version parent=ab/swr_sweep_fwd.cu
    python3 scripts/torch_sweep_fwd_ab.py --kernel bwd \\
        --version parent=ab/swr_sweep_bwd.cu
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


def bind_version(path, name="swr_sweep_fwd"):
    """``(fn, scratch)``: the C entry ``name`` of the source ``path``, built
    into the package's build directory with its flags (headers from
    ``csrc/``) and bound as the package binds it.  Returns the function and
    its ABI: ``dx2``, whether the entry takes the first backward's ``dx2``
    scratch (one more pointer), and ``dtypes``, whether it takes the dtype
    codes (two more ints, and for the backward the bf16 scratch pointer)."""
    import re

    from taichi_nerfs_torch.ops import _build

    with open(path, "rb") as f:
        text = f.read()
    flags = (*_build.NVCC_FLAGS, "-I", _build.CSRC)
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    out = os.path.join(_build.BUILD_DIR, f"lib{name}-ab-{digest}.so")
    if not os.path.exists(out):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *flags, "-o", out, path],
                       check=True, capture_output=True, text=True)
    entry = re.search(rf'extern "C" int {name}\(([^)]*)\)', text.decode())
    params = entry.group(1) if entry else ""
    abi = {"dx2": "dx2" in params, "dtypes": "vol_dtype" in params}
    fn = getattr(ctypes.CDLL(out), name)
    fn.restype = ctypes.c_int
    n_ptr = ({"swr_sweep_fwd": 5, "swr_sweep_bwd": 7}[name] + abi["dx2"]
             + (abi["dtypes"] and name == "swr_sweep_bwd"))
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (
        9 if abi["dtypes"] else 7) + [ctypes.c_void_p]
    return fn, abi


def fp32_args(abi, kernel):
    """The arguments a version's entry takes beyond the older ABI's, for
    fp32 operands: (extra pointers after dvol, extra ints after kind)."""
    if not abi["dtypes"]:
        return [], []
    return ([None] if kernel == "bwd" else []), [0, 0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("fwd", "bwd"), default="fwd")
    ap.add_argument("--version", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another version of the kernel's source")
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
    entry = f"swr_sweep_{args.kernel}"
    fns, abis = {}, {}
    for spec in args.version:
        name, path = spec.split("=", 1)
        fns[name], abis[name] = bind_version(os.path.abspath(path), entry)
    fns["new"], abis["new"] = sw._kernel_fn(entry), {"dx2": False,
                                                       "dtypes": True}
    if args.kernel == "bwd":
        out = {"device": torch.cuda.get_device_name(0),
               "sweep_bwd_ms": bwd_ab(torch, cs, sw, fns, abis, args.seed)}
        print(json.dumps(out), flush=True)
        return

    def run(version, vol, rs, z_rel, ch, nq, kind):
        nc, dc, F, Rb, Rc = vol.shape
        out = torch.empty((nc, F + 2, nq, nq), dtype=torch.float32,
                          device=vol.device)
        _, ints = fp32_args(abis[version], "fwd")
        rc = fns[version](
            vol.data_ptr(), rs.data_ptr(), z_rel.data_ptr(), ch.data_ptr(),
            out.data_ptr(), nc, dc, F, Rb, Rc, nq, sw._KINDS[kind], *ints,
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
        out["frames"] = frames(torch, cs, sw, fns, abis, args.seed)
    print(json.dumps(out), flush=True)


def bwd_ab(torch, cs, sw, fns, abis, seed):
    """The backward versions at the training shapes; returns, per shape and
    kind, each version's mean warm and cold medians, the bound, and each
    version's per-kernel device ms."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(version, vol, rs, z_rel, ch, frames, g, nq, kind):
        nc, dc, F, Rb, Rc = vol.shape
        dvol = torch.empty_like(vol)
        extra = []
        if abis[version]["dx2"]:
            dx2 = torch.empty((nc, dc, F, nq, nq), dtype=torch.float32,
                              device=vol.device)
            extra = [dx2.data_ptr()]
        ptrs, ints = fp32_args(abis[version], "bwd")
        rc = fns[version](
            vol.data_ptr(), rs.data_ptr(), z_rel.data_ptr(), ch.data_ptr(),
            frames.data_ptr(), g.data_ptr(), *extra, dvol.data_ptr(), *ptrs,
            nc, dc, F, Rb, Rc, nq, sw._KINDS[kind], *ints,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{version} kernel launch failed: {rc}")
        return dvol

    rng = np.random.default_rng(seed + 1)
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    results = {}
    for R, dc, nq in cs.TRAIN_SHAPES:
        a = cs._rand_sweep_inputs(torch, rng, 16, dc, 8, R, nq, True)
        cs._keep_off_the_gate(torch, rng, a, nq)
        g = torch.randn((16, 10, nq, nq), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(9))
        for kind in ("linear", "cubic"):
            frames = sw.chunk_sweep(*a, nq, kind)
            want = sw.chunk_sweep_bwd_reference(*a, g, nq, kind)
            got = {v: run(v, *a, frames, g, nq, kind) for v in fns}
            again = {v: run(v, *a, frames, g, nq, kind) for v in fns}
            torch.cuda.synchronize()
            for v, x in got.items():
                d = (x - want).abs()
                if not bool(torch.all(d <= cs.BWD_TOL
                                      + cs.BWD_TOL * want.abs())):
                    raise AssertionError(
                        f"{v} backward disagrees with the plain backward "
                        f"(R={R}, {kind}): max_abs {float(d.max()):.3e}")
            diff = {v: float((x - got["new"]).abs().max())
                    for v, x in got.items() if v != "new"}
            same = {v: bool(torch.equal(got[v], again[v])) for v in fns}
            del want, got, again
            t = {v: {"warm": [], "cold": []} for v in fns}
            for v in list(fns) + list(fns)[::-1]:
                for mode, fl in (("warm", None), ("cold", flush)):
                    t[v][mode].append(cs._time_ms(
                        torch, lambda v=v: run(v, *a, frames, g, nq, kind),
                        10, fl))
            parts = {}
            for v in fns:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        run(v, *a, frames, g, nq, kind)
                    torch.cuda.synchronize()
                parts[v] = {e.key[:60]: e.self_device_time_total / 5e3
                            for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA}
            bound, by, _, _ = cs.sweep_bwd_bound(16, dc, 8, R, R, nq, kind)
            key = f"R={R} nq={nq} {kind}"
            results[key] = {v: {m: float(np.mean(x)) for m, x in tv.items()}
                            for v, tv in t.items()}
            results[key]["bound"] = bound
            results[key]["kernels"] = parts
            print(f"{key}: bound {bound:.4f} ms ({by}); max |diff| from new "
                  + ", ".join(f"{v} {d:.3e}" for v, d in diff.items())
                  + "; same bits on a second run: "
                  + ", ".join(f"{v} {x}" for v, x in same.items()),
                  flush=True)
            for v in fns:
                w, c = t[v]["warm"], t[v]["cold"]
                print(f"  {v}: warm {w[0]:.4f} / {w[1]:.4f} ms, cold "
                      f"{c[0]:.4f} / {c[1]:.4f} ms; share of the bound warm "
                      f"{bound / np.mean(w):.1%}, cold {bound / np.mean(c):.1%}"
                      "; device ms per run by kernel: " + ", ".join(
                          f"{k} {x:.4f}" for k, x in parts[v].items()),
                      flush=True)
        del a, g, frames
    return results


def frames(torch, cs, sw, fns, abis, seed):
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

    def new_abi(v):
        # the wrapper passes the dtype codes; an older entry takes none
        if abis[v]["dtypes"]:
            return fns[v]
        return lambda *a: fns[v](*a[:12], a[14])

    built = sw._kernel_fn
    current = ["new"]
    sw._kernel_fn = lambda name: (
        new_abi(current[0]) if name == "swr_sweep_fwd" else built(name))
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
