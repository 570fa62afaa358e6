#!/usr/bin/env python3
"""Micro-bench: (N, K) -> (N, S) per-ray sample compaction strategies.

Counterpart of ``scripts/microbench_compact.py`` on the PyTorch port.  The
marcher compacts the first S occupied candidates per ray out of a K-wide
probe window (``taichi_nerfs_torch/ops/marching.py:march_rays``).
Candidates, on the same seeded inputs (~15 % occupancy, as a settled
grid):

* topk:    ``torch.topk`` over the keyed window ``where(occ, K - k, 0)``.
* scatter: the port's own marcher compaction, ``_first_occupied``: cumsum
           slot assignment and one scatter (out-of-range slots dropped).
* gather:  the inclusive cumsum and a batched ``torch.searchsorted`` per
           slot.

All three must give the same ts, dts and counts (exact selection), then
each is timed with CUDA events behind ``torch.cuda.synchronize()``.  No
sweep kernel runs.

    python3 scripts/torch_microbench_compact.py [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises without
one.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX script's sizes; a test shrinks them
N, K, S = 8192, 1032, 128


def make_inputs(rng: np.random.RandomState):
    """The JAX script's inputs, drawn in its order: occupancy (N, K) bool,
    ts and dts (N, K) fp32."""
    occ = rng.uniform(size=(N, K)) < 0.15
    ts = rng.uniform(0.01, 1.7, size=(N, K)).astype(np.float32)
    dts = rng.uniform(1e-3, 1e-2, size=(N, K)).astype(np.float32)
    return occ, ts, dts


def compact_topk(occ, ts, dts):
    import torch

    k = occ.shape[1]
    k_idx = torch.arange(k, dtype=torch.int32, device=occ.device)[None, :]
    key = torch.where(occ, k - k_idx, 0)
    top_keys = torch.topk(key, S, dim=1).values
    valid = top_keys > 0
    sel = torch.where(valid, k - top_keys, 0).long()
    out_ts = torch.where(valid, torch.gather(ts, 1, sel), 0.0)
    out_dt = torch.where(valid, torch.gather(dts, 1, sel), 0.0)
    counts = torch.clamp(occ.sum(dim=1), max=S).to(torch.int32)
    return out_ts, out_dt, counts


def compact_scatter(occ, ts, dts):
    import torch

    from taichi_nerfs_torch.ops.marching import _first_occupied

    out_ts, total = _first_occupied(occ, ts, S)
    out_dt, _ = _first_occupied(occ, dts, S)
    return out_ts, out_dt, torch.clamp(total, max=S).to(torch.int32)


def compact_gather(occ, ts, dts):
    import torch

    c = torch.cumsum(occ.to(torch.int32), dim=1)
    targets = torch.arange(1, S + 1, dtype=torch.int32, device=occ.device)
    # (N, S): the first k with cumsum == s + 1
    sel = torch.searchsorted(c, targets.expand(c.shape[0], S).contiguous(),
                             side="left")
    counts = torch.clamp(c[:, -1], max=S).to(torch.int32)
    valid = targets[None, :] <= counts[:, None]
    sel = torch.clamp(sel, max=occ.shape[1] - 1)
    out_ts = torch.where(valid, torch.gather(ts, 1, sel), 0.0)
    out_dt = torch.where(valid, torch.gather(dts, 1, sel), 0.0)
    return out_ts, out_dt, counts


STRATEGIES = (("topk", compact_topk), ("scatter", compact_scatter),
              ("gather", compact_gather))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    import torch

    from taichi_nerfs_torch.utils.device import card_line, resolve_device
    from taichi_nerfs_torch.utils.profiling import time_calls

    device = resolve_device(args.device, "--device cpu")
    if device.type == "cuda":
        print(card_line(), flush=True)
    occ, ts, dts = (torch.as_tensor(a, device=device)
                    for a in make_inputs(np.random.RandomState(0)))

    outs = {name: fn(occ, ts, dts) for name, fn in STRATEGIES}
    for name in ("scatter", "gather"):
        for a, b, part in zip(outs["topk"], outs[name],
                              ("ts", "dts", "counts")):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} mismatch on {part}")
    print("parity ok (scatter+gather == topk)", flush=True)

    for name, fn in STRATEGIES:
        ms = time_calls(lambda: fn(occ, ts, dts), 30, 5, device)
        print(f"{name + ':':<8} {sum(ms) / len(ms):7.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
