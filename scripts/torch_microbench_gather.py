#!/usr/bin/env python3
"""Micro-bench: hash-table gather strategies for the packed field eval.

Counterpart of ``scripts/microbench_gather.py`` on the PyTorch port.  The
flagship hash encoder issues, per packed sample, (levels x 8) = 128
row-gathers per feature channel (``taichi_nerfs_torch/ops/
hash_encoder.py``).  Candidates, on the JAX script's seeded inputs:

* f32x2:   two separate (M, 128) gathers from (n_entries,) fp32 channels.
* bf16pk:  ONE (M, 128) gather from an (n_entries,) fp32 view holding both
           bf16 feature channels packed per entry, split with int32 bit
           ops (``& -65536`` and ``<< 16`` on an int32 view, then an fp32
           view).
* brick:   one (M * levels,) row-gather of (8F)-wide brick rows
           (``ops/brick_encoder.py`` layout) for comparison.

Each is timed with CUDA events behind ``torch.cuda.synchronize()`` and
printed with its rows a second.  The indices take ~100 MB and the brick
gather's output ~400 MB.  No sweep kernel runs.

    python3 scripts/torch_microbench_gather.py [--device cpu]

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
M = 196608  # packed samples (batch 8192 x ~24 samples/ray)
C = 128  # levels * corners
L = 16
N_ENTRIES = 16 * (2**19)
BRICK_ROWS, BRICK_WIDTH = 2**17 + 600000, 32


def make_inputs(rng: np.random.RandomState):
    """The JAX script's inputs, drawn in its order: two fp32 channels, the
    bf16 pair packed into one fp32 word (high half channel 0), the (M, C)
    indices, the brick table and its (M * L,) row indices."""
    t0 = rng.uniform(size=(N_ENTRIES,)).astype(np.float32)
    t1 = rng.uniform(size=(N_ENTRIES,)).astype(np.float32)
    b0 = t0.view(np.uint32) & 0xFFFF0000
    b1 = (t1.view(np.uint32) & 0xFFFF0000) >> 16
    packed = (b0 | b1).view(np.float32)
    idx = rng.randint(0, N_ENTRIES, size=(M, C)).astype(np.int32)
    brick_table = rng.uniform(size=(BRICK_ROWS, BRICK_WIDTH)).astype(
        np.float32)
    idx_l = rng.randint(0, BRICK_ROWS, size=(M * L,)).astype(np.int32)
    return t0, t1, packed, idx, brick_table, idx_l


def _take(table, idx):
    return table.index_select(0, idx.reshape(-1)).reshape(idx.shape)


def gather_f32x2(t0, t1, idx):
    return _take(t0, idx), _take(t1, idx)


def gather_bf16_packed(packed, idx):
    import torch

    u = _take(packed, idx).view(torch.int32)  # (M, C) packed bf16 pair
    # high half == channel 0 as bf16 -> fp32 by zero-padding the mantissa
    f0 = (u & -65536).view(torch.float32)
    f1 = (u << 16).view(torch.float32)
    return f0, f1


def gather_brick(table, idx_l):
    return table.index_select(0, idx_l)  # (M * L, 8F)


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
    t0, t1, packed, idx, brick_table, idx_l = (
        torch.as_tensor(a, device=device)
        for a in make_inputs(np.random.RandomState(0)))

    a0, a1 = gather_f32x2(t0, t1, idx)
    p0, p1 = gather_bf16_packed(packed, idx)
    err0 = float((a0 - p0).abs().max())
    err1 = float((a1 - p1).abs().max())
    print(f"bf16 pack max err: {err0:.5f} / {err1:.5f} (bf16 quantization)",
          flush=True)
    del a0, a1, p0, p1

    def mean_ms(fn):
        ms = time_calls(fn, 20, 4, device)
        return sum(ms) / len(ms)

    ms = mean_ms(lambda: gather_f32x2(t0, t1, idx))
    print(f"f32 two-gather:   {ms:7.3f} ms  "
          f"({2 * M * C / ms * 1e3 / 1e6:.0f} M rows/s)", flush=True)
    ms = mean_ms(lambda: gather_bf16_packed(packed, idx))
    print(f"bf16 one-gather:  {ms:7.3f} ms  "
          f"({M * C / ms * 1e3 / 1e6:.0f} M rows/s)", flush=True)
    ms = mean_ms(lambda: gather_brick(brick_table, idx_l))
    print(f"brick row-gather: {ms:7.3f} ms  "
          f"({M * L / ms * 1e3 / 1e6:.0f} M rows/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
