#!/usr/bin/env python3
"""Read the errors that set the bf16 limits of the sweep kernels' checks.

Both sweep kernels against their plain versions at ``chip_smoke.py``'s bf16
cases (ragged shapes for F 4/8/16 and the forward's edge cases at F=8,
linear and cubic; the R=512 training shape, cubic), at every dtype pair
with bf16 operands, for

* ``new``: the package's kernels;
* ``opb_off``: both kernels built from copies of their sources in which
  every bf16-operand instance is replaced by the fp32-operand one, so that
  nothing is rounded to bf16 (weights, slab, pass-1 product, ``dx2``,
  ``t``): what a kernel that skips the Pallas kernel's roundings gives.
  The copies are written to a temporary directory;
* each ``--version NAME=PATH`` of the backward's source (an earlier
  commit's, put in the gitignored ``ab/``).

Per case and version it prints the forward's max abs and relative-norm
errors and ``d vol``'s relative-norm error; then one JSON line with the
largest of each per version, small cases and R=512 apart.  A limit must
pass ``new`` and fail ``opb_off``.

    python3 scripts/torch_sweep_bf16_tol.py [--version old=ab/swr_sweep_bwd.cu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def opb_off_copy(name, tmp):
    """A copy of ``csrc/<name>.cu`` in ``tmp`` whose dispatch launches the
    fp32-operand instance for bf16 operands too."""
    from taichi_nerfs_torch.ops import _build

    with open(os.path.join(_build.CSRC, name + ".cu")) as f:
        text = f.read()
    text, n = re.subn(r"LAUNCH\((float|__nv_bfloat16), true\)",
                      r"LAUNCH(\1, false)", text)
    if n != 2:
        raise RuntimeError(f"{name}.cu: {n} bf16-operand launches, not 2")
    path = os.path.join(tmp, name + ".cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another version of csrc/swr_sweep_bwd.cu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from taichi_nerfs_torch.ops import swr_sweep as sw
    from torch_sweep_fwd_ab import bind_version

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        fwd = {"new": sw._kernel_fn("swr_sweep_fwd"),
               "opb_off": bind_version(opb_off_copy("swr_sweep_fwd", tmp),
                                       "swr_sweep_fwd")[0]}
        bwd = {"new": sw._kernel_fn("swr_sweep_bwd"),
               "opb_off": bind_version(opb_off_copy("swr_sweep_bwd", tmp),
                                       "swr_sweep_bwd")[0]}
    for spec in args.version:
        name, path = spec.split("=", 1)
        bwd[name] = bind_version(os.path.abspath(path), "swr_sweep_bwd")[0]

    def codes(vol, kind, odt):
        return (sw._KINDS[kind], sw._DTYPES[vol.dtype], sw._DTYPES[odt],
                torch.cuda.current_stream().cuda_stream)

    def run_fwd(fn, vol, rs, z_rel, ch, nq, kind, odt):
        nc, dc, F, Rb, Rc = vol.shape
        out = torch.empty((nc, F + 2, nq, nq), dtype=torch.float32,
                          device=vol.device)
        rc = fn(vol.data_ptr(), rs.data_ptr(), z_rel.data_ptr(),
                ch.data_ptr(), out.data_ptr(), nc, dc, F, Rb, Rc, nq,
                *codes(vol, kind, odt))
        if rc != 0:
            raise RuntimeError(f"forward launch failed: {rc}")
        return out

    def run_bwd(fn, vol, rs, z_rel, ch, frames, g, nq, kind, odt):
        nc, dc, F, Rb, Rc = vol.shape
        dvol = torch.empty_like(vol)
        # large enough for every version's use of it
        scratch = torch.empty(nc * dc * F * max(nq, Rb) * Rc,
                              dtype=torch.float32, device=vol.device)
        rc = fn(vol.data_ptr(), rs.data_ptr(), z_rel.data_ptr(),
                ch.data_ptr(), frames.data_ptr(), g.data_ptr(),
                dvol.data_ptr(), scratch.data_ptr(), nc, dc, F, Rb, Rc, nq,
                *codes(vol, kind, odt))
        if rc != 0:
            raise RuntimeError(f"backward launch failed: {rc}")
        return dvol

    def rel(a, b):
        a, b = a.double(), b.double()
        return float(torch.linalg.norm(a - b)
                     / max(float(torch.linalg.norm(b)), 1e-30))

    worst = {}

    def note(group, key, version, x):
        k = f"{group} {key} {version}"
        worst[k] = max(worst.get(k, 0.0), x)

    def check(group, label, args4, g, nq, kinds):
        for vdt, odt in cs.DTYPE_PAIRS:
            if odt != "bfloat16":
                continue
            a = [args4[0].to(getattr(torch, vdt)), *args4[1:]]
            dt = torch.bfloat16
            for kind in kinds:
                want = sw.chunk_sweep_reference(*a, nq, kind, dtype=dt)
                want_d = sw.chunk_sweep_bwd_reference(*a, g, nq, kind,
                                                      dtype=dt)
                frames = run_fwd(fwd["new"], *a, nq, kind, dt)
                parts = []
                for v, fn in fwd.items():
                    got = run_fwd(fn, *a, nq, kind, dt)
                    err = float((got - want).abs().max())
                    r = rel(got, want)
                    note(group, "fwd_max_abs", v, err)
                    note(group, "fwd_rel_norm", v, r)
                    parts.append(f"fwd {v} {err:.3e} / {r:.3e}")
                    del got
                for v, fn in bwd.items():
                    got = run_bwd(fn, *a, frames, g, nq, kind, dt)
                    r = rel(got.float(), want_d.float())
                    note(group, "dvol_rel_norm", v, r)
                    parts.append(f"d vol {v} {r:.3e}")
                    del got
                torch.cuda.synchronize()
                print(f"{label} {cs._pair_label(vdt, odt)} {kind}: "
                      + "; ".join(parts), flush=True)
                del want, want_d, frames

    rng = np.random.default_rng(2)
    cases = [(f"ragged F={F}", dict(nc=2, dc=3, F=F, R=40, nq=37,
                                    realistic=False)) for F in (4, 8, 16)]
    cases += [(f"{label} F=8", dict(shp, F=8, realistic=False))
              for label, shp in cs.FWD_EDGE_CASES]
    for label, shp in cases:
        nq = shp["nq"]
        a = cs._rand_sweep_inputs(torch, rng, **shp)
        kinds = ("linear", "cubic")
        if label.startswith("non-finite"):
            for c, s, k, v in cs.NON_FINITE_RS:
                a[1][c, s, k] = v
            kinds = ("cubic",)
        nc, _, F = a[0].shape[:3]
        g = torch.randn((nc, F + 2, nq, nq), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(9))
        check("small", label, a, g, nq, kinds)
    base, g, nq = cs._r512_sweep_inputs(torch, args.seed)
    check("r512", f"R=512 nq={nq}", base, g, nq, ("cubic",))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "worst": worst}), flush=True)


if __name__ == "__main__":
    main()
