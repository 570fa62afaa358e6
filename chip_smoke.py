#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Drives the port's serving and training paths (``taichi_nerfs_torch``)
through the record model's configuration at full width on the card, in
phases:

1. device: the ``nvidia-smi`` name and power limit; no CUDA device is a
   failure (never a CPU run);
2. build: compile every kernel from ``taichi_nerfs_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   random ragged shapes, at edge cases of the forward (a negative step, a
   step >= 3 and non-finite positions, which take the kernel's tap-by-tap
   path from device memory, a lattice partly outside the source; F in
   {4, 8, 16}; the backward at the same cases and at clamp-binding inputs),
   at the serving and training shapes (forward) and at the three training
   shapes (backward, linear and cubic, with the difference of a second
   run); both kernels are timed warm and cold (after 128 MB written to
   evict the L2), each time beside its bound and its share of it;
4. serve: ``PyramidRenderer`` renders 4 orbit views at 800x800, capped and
   uncapped, with cubic resampling; the outputs are checked, the forward
   kernel's launch count during those frames must be > 0, and one view is
   rendered again through the plain sweep and compared;
5. train: ``SwrTrainer`` trains the record configuration for 24 steps
   through all three coarse-to-fine phases on procedural lego views made on
   the card; every loss must be finite and the loss must fall, both
   kernels' launch counts during the steps must be > 0, one full-depth
   step's gradient through the kernels is compared with the one through
   the plain sweep, and one test view is rendered uncapped;
6. default flags: ``python -m taichi_nerfs_torch.train --model_name
   pyramid``'s configuration built by the entry's own ``configs()`` from
   the default flags (linear, F=16, deferred, crop 256, R=256) on 8
   procedural lego views at 800x800, the coarse-to-fine phases cut to 3
   steps each; each phase's slab window must be 0 (the sweep's scope),
   both kernels' launch counts during the steps > 0 (the step medians and
   peak device memory printed), and one full-depth
   step's gradient through the kernels is compared with the plain sweep's;
7. scan: the record widths with a split sigma grid (``sigma_res=512``),
   per-sample shading and the distortion loss, which the slab scan renders:
   8 steps on the same views (losses finite; the loss on fixed crops
   falls), the step median and peak device memory, one capped 800x800
   frame (finite, opacity in [0, 1]) and zero sweep-kernel launches;
8. scan card vs CPU: one scan-path loss and its gradients at a small size,
   full-matrix and windowed, on the card and on the CPU (loss 1e-5
   relative, gradients 2e-4 relative norm, the CPU tests' tolerances);
9. window: a narrow 800x800 view (focal 4 w, a 32 x 32 crop) of the record
   model, whose slab window is 64 at R=256, rendered windowed (the scan)
   and with the full matrix (the sweep kernel), compared;
10. ngp: the sample-gather NGP path at the flagship ``config_for_scene(0.5)``
   (brick encoder, 128^3 occupancy grid, batch 8192) trains 320 steps with
   ``Trainer`` on 8 checker views made on the card (past the 256-step
   warmup, so the sparse grid refresh runs); every loss must be finite and
   the mean of the last 16 below half the first.  One ``render_train`` on
   4,096 rays runs on the card and on the CPU from identical params,
   bitfield and draws (equal counts on >= 99.9 % of rays, rgb within
   2e-2); ``render_image`` renders an 800x800 test view (finite, opacity in
   [0, 1]); 3 steady steps run under ``torch.profiler``.  This path has no
   hand-written kernel (the JAX package has no TPU kernel on it).

Prints one JSON line with the kernels' numbers and, last, one JSON line
``{"ok": true, "device": {...}}``.  Any failure raises (exit code != 0).
The new phases' summary lines carry the card's name and power limit.

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
# backward kernel against autograd of the plain sweep, elementwise abs +
# rel: the kernel sums taps where autograd runs the transposed dense fp32
# matmuls (another summation order), and the sums run over more terms
BWD_TOL = 2e-4
# one full-depth training step's level gradients, kernels vs plain sweep,
# relative norm per level (the loss runs both sweeps, the fold, the warp
# and the bf16-operand MLP)
GRAD_TOL = 1e-3
# the record training recipe's sweep shapes (n_chunks=16, F=8, crop 256):
# (R, dc, nq) per coarse-to-fine phase; nq is the capped lattice
# int(1.25 R) + 16 while it is below crop + 16, else crop + 16
TRAIN_SHAPES = ((64, 4, 96), (128, 8, 176), (256, 16, 272))
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): device
# memory rate, and fp32 outside the tensor cores; a kernel's bound is the
# larger of bytes / rate and flops / peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# bytes written between cold-timed launches: more than the 50 MB L2
FLUSH_BYTES = 128 << 20
# the spin queued before each timed run: ~0.5 ms at the H100's clocks,
# longer than the host takes to queue one launch of a kernel
SPIN_CYCLES = 1_000_000
TRAIN_STEPS, PROG_STEPS = 24, (4, 4)
# the loss must fall: on 4 fixed crops (with fixed backgrounds), the loss
# after training below this share of the loss of the initial params
LOSS_FALL = 0.95
# the NGP phase: steps (the density grid warms up over all cells for 256),
# the mean of the last 16 losses below this share of the first, and the
# card / CPU cross-check of one render_train: rays, the share of rays with
# equal sample counts (a float tie at a cell boundary may move a sample)
# and rgb (bf16-operand MLPs, summed in another order on each device)
NGP_STEPS, NGP_WARMUP = 320, 256
NGP_LOSS_FALL = 0.5
NGP_CHECK_RAYS, NGP_COUNT_SHARE, NGP_RGB_TOL = 4096, 0.999, 2e-2
NGP_TEST_WH = (800, 800)
# the default-flag phase: 3 coarse-to-fine phases of 3 steps; the scan
# phase: steps, and fixed crops whose loss must fall
DEFAULT_PROG, DEFAULT_STEPS = (3, 3), 9
SCAN_STEPS, SCAN_CROPS = 8, 2
# scan loss and gradients, card against CPU (the CPU tests' tolerances)
SCAN_LOSS_TOL, SCAN_GRAD_TOL = 1e-5, 2e-4


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _rand_sweep_inputs(torch, rng, nc, dc, F, R, nq, realistic,
                       start=None, step=None):
    """Random sweep operands in the style of tests/test_swr_pallas.py.

    ``realistic`` spreads the lattice over the whole source slab as the
    renderer does (step ~ R / (nq - 16), h = 1 / R).  ``start`` and
    ``step``, given as ``(low, high)``, draw the lattice's start and step
    on both axes from those ranges instead."""
    import numpy as np

    vol = rng.normal(0.3, 1.0, (nc, dc, F, R, R)).astype(np.float32)
    if realistic:
        step0 = R / (nq - 16)
        starts = rng.uniform(-10.0, 0.0, (nc, dc, 2))
        steps = step0 * rng.uniform(0.9, 1.1, (nc, dc, 2))
        d_lat, h = 1.0 / (nq - 16), 1.0 / R
    else:
        starts = rng.uniform(-1.0, 1.0, (nc, dc, 2))
        steps = rng.uniform(0.7, 1.3, (nc, dc, 2))
        d_lat, h = 0.03, 0.1
    if start is not None:
        starts = rng.uniform(*start, (nc, dc, 2))
    if step is not None:
        steps = rng.uniform(*step, (nc, dc, 2))
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


def _time_ms(torch, fn, reps, flush=None):
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events).

    Each run is queued behind a spin of the card (``torch.cuda._sleep``),
    so the host has queued the events and the launch before the card
    reaches them and the host's launch cost is not timed.  With ``flush``
    (a CUDA tensor larger than the L2) the tensor is written before each
    run, outside the events, so ``fn`` finds its inputs in device memory
    and not in the L2 (a cold time); without, ``fn`` finds what its last
    run left in the L2 (a warm time)."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return _median([a.elapsed_time(b) for a, b in events])


def _bound_ms(nbytes, flops):
    """``(bound ms, "bytes" or "operations")``: the larger of the bytes over
    the device memory rate and the flops over the fp32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _resample_flops(nc, dc, F, Rc, nq, kind):
    """Flops of the separable resample of every slab and channel onto the
    lattice: a multiply-add (2 flops) per tap, NT taps (2 linear, 4 cubic)
    per output of the pass along b (nq x Rc) and along c (nq x nq)."""
    nt = 2 if kind == "linear" else 4
    return 2 * nt * nc * dc * F * (nq * Rc + nq * nq)


def sweep_fwd_bound(nc, dc, F, Rb, Rc, nq, kind):
    """The forward's bound: each input read once (vol, rs_par, z_rel,
    ch_par) and the frames written once; the separable resample plus the
    composite's 2 (F - 1) + 10 flops per lattice point and slab."""
    nbytes = 4 * (nc * dc * F * Rb * Rc + nc * dc * 5 + nc * 6
                  + nc * (F + 2) * nq * nq)
    flops = (_resample_flops(nc, dc, F, Rc, nq, kind)
             + nc * dc * nq * nq * (2 * (F - 1) + 10))
    return (*_bound_ms(nbytes, flops), nbytes, flops)


def sweep_bwd_bound(nc, dc, F, Rb, Rc, nq, kind):
    """The backward's bound: vol, the parameters, the frames' tau channel
    (the only one it reads) and g read once, dvol written once; the
    forward's resample again, its transpose (the same count) and the
    reverse composite's 4 (F - 1) + 20 flops per lattice point and slab."""
    nbytes = 4 * (2 * nc * dc * F * Rb * Rc + nc * dc * 5 + nc * 6
                  + nc * nq * nq + nc * (F + 2) * nq * nq)
    flops = (2 * _resample_flops(nc, dc, F, Rc, nq, kind)
             + nc * dc * nq * nq * (4 * (F - 1) + 20))
    return (*_bound_ms(nbytes, flops), nbytes, flops)


# the forward's edge cases, each for F in {4, 8, 16}: the lattice runs
# backwards; the step is >= 3 on a 256-voxel source, so the window of every
# full 64-column tile spans more than the kernel's 160 shared-memory columns
# and its warps read their taps from device memory (the ragged last tile's
# window fits); some slabs' positions are not finite (read tap by tap, or
# skipped, with all weights 0); the lattice starts and ends outside the
# source (and nq is no multiple of the tile); whole tiles lie outside the
# source, as the serving lattice's do
FWD_EDGE_CASES = (
    ("negative step", dict(nc=2, dc=4, R=64, nq=90, start=(60.0, 70.0),
                           step=(-0.9, -0.6))),
    ("step >= 3", dict(nc=2, dc=3, R=256, nq=70, start=(-5.0, 0.0),
                       step=(3.0, 3.5))),
    ("non-finite", dict(nc=2, dc=3, R=64, nq=70, start=(-2.0, 0.0),
                        step=(0.9, 1.1))),
    ("partly outside", dict(nc=2, dc=3, R=48, nq=101, start=(-40.0, -30.0),
                            step=(0.9, 1.1))),
    ("far outside", dict(nc=1, dc=2, R=48, nq=200, start=(-150.0, -140.0),
                         step=(0.95, 1.05))),
)
# the "non-finite" case's (chunk, slab, rs_par entry, value): a NaN column
# start, an infinite column step, a NaN row start.  Cubic only: the plain
# linear tent, clamp(1 - |x|), turns a NaN distance into a NaN weight where
# the kernel (and the plain Catmull-Rom) gives it weight 0
NON_FINITE_RS = ((0, 1, 2, float("nan")), (1, 0, 3, float("inf")),
                 (1, 1, 0, float("nan")))
# the forward's timed shapes (n_chunks, dc, F, R, nq): one chunk of the
# record model's 800x800 frame, uncapped and capped, and the full-depth
# training step's 16 chunks
FWD_TIMED = (("serving nq=816", (1, 16, 8, 256, 816)),
             ("serving nq=336", (1, 16, 8, 256, 336)),
             ("training nq=272", (16, 16, 8, 256, 272)))


def phase_kernels(torch):
    """``swr_sweep_fwd`` against the plain sweep: ragged shapes and the
    edge cases for F in {4, 8, 16}, and the timed shapes, linear and cubic.
    The timed shapes run warm (the chunk in the L2 from the last launch)
    and cold (the L2 flushed before each launch)."""
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
        (f"{label} F={F}", dict(shp, F=F, realistic=False))
        for label, shp in FWD_EDGE_CASES for F in (4, 8, 16)
    ] + [
        (label, dict(nc=nc, dc=dc, F=F, R=R, nq=nq, realistic=True))
        for label, (nc, dc, F, R, nq) in FWD_TIMED
    ]
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for label, shp in cases:
        nq = shp["nq"]
        args = _rand_sweep_inputs(torch, rng, **shp)
        kinds = ("linear", "cubic")
        if label.startswith("non-finite"):
            for c, s, k, v in NON_FINITE_RS:
                args[1][c, s, k] = v
            kinds = ("cubic",)
        for kind in kinds:
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
            if shp["realistic"]:
                del got, want
                timing[(nq, kind)] = _time_fwd(
                    torch, label, args, nq, kind, flush)
        del args
    torch.cuda.synchronize()
    return worst, timing


def _time_fwd(torch, label, args, nq, kind, flush):
    """The forward kernel's warm and cold medians beside its bound, and the
    plain version's warm median; printed and returned as a dict."""
    from taichi_nerfs_torch.ops.swr_sweep import (
        chunk_sweep,
        chunk_sweep_reference,
    )

    nc, dc, F, Rb, Rc = args[0].shape
    warm = _time_ms(torch, lambda: chunk_sweep(*args, nq, kind), 20)
    cold = _time_ms(torch, lambda: chunk_sweep(*args, nq, kind), 20, flush)
    plain = _time_ms(torch, lambda: chunk_sweep_reference(*args, nq, kind),
                     3 if nc > 1 else 10)
    bound, by, nbytes, flops = sweep_fwd_bound(nc, dc, F, Rb, Rc, nq, kind)
    print(f"  time {label} {kind}: kernel warm {warm:.4f} ms, cold "
          f"{cold:.4f} ms; bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB,"
          f" {flops / 1e9:.3f} GFLOP), share warm {bound / warm:.1%}, cold "
          f"{bound / cold:.1%}; plain {plain:.4f} ms (medians, CUDA events)",
          flush=True)
    return dict(warm=warm, cold=cold, plain=plain, bound=bound, by=by)


def phase_bwd_kernels(torch):
    """``swr_sweep_bwd`` against autograd of the plain sweep: ragged
    shapes for F in {4, 8, 16}, the clamp-binding inputs, the forward's edge
    cases for F in {4, 8, 16}, and the three training shapes (timed warm and
    cold), linear and cubic.  At each training shape a second run's largest
    difference from the first is printed: the kernel adds the tiles' sums
    with atomics, in the order the blocks reach them."""
    import numpy as np

    from taichi_nerfs_torch.ops.swr_sweep import (
        chunk_sweep,
        chunk_sweep_bwd,
        chunk_sweep_reference,
    )

    rng = np.random.default_rng(1)
    both = ("linear", "cubic")
    cases = [
        (f"ragged F={F}", dict(nc=2, dc=3, F=F, R=40, nq=37,
                               realistic=False), both)
        for F in (4, 8, 16)
    ] + [("clamp-binding", None, both)] + [
        (f"{label} F={F}", dict(shp, F=F, realistic=False),
         ("cubic",) if label == "non-finite" else both)
        for label, shp in FWD_EDGE_CASES for F in (4, 8, 16)
    ] + [
        (f"training R={R} nq={nq}", dict(nc=16, dc=dc, F=8, R=R, nq=nq,
                                         realistic=True), both)
        for R, dc, nq in TRAIN_SHAPES
    ]
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    worst = 0.0
    timing = {}
    for label, shp, kinds in cases:
        if shp is None:
            args, nq = _clamp_case(torch), 8
        else:
            nq = shp["nq"]
            args = _rand_sweep_inputs(torch, rng, **shp)
            if shp["realistic"]:
                _keep_off_the_gate(torch, rng, args, nq)
            if label.startswith("non-finite"):
                for c, s, k, v in NON_FINITE_RS:
                    args[1][c, s, k] = v
        nc, _, F = args[0].shape[:3]
        g = torch.randn((nc, F + 2, nq, nq), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(9))
        for kind in kinds:
            frames = chunk_sweep(*args, nq, kind)
            got = chunk_sweep_bwd(*args, frames, g, nq, kind)
            # the plain backward: autograd through the plain sweep
            v = args[0].clone().requires_grad_(True)
            out = chunk_sweep_reference(v, *args[1:], nq, kind)
            (want,) = torch.autograd.grad(out, v, g, retain_graph=True)
            torch.cuda.synchronize()
            d = (got - want).abs()
            max_abs = float(d.max())
            max_rel = max_abs / max(float(want.abs().max()), 1e-30)
            ok = bool(torch.all(d <= BWD_TOL + BWD_TOL * want.abs()))
            ok = ok and bool(torch.isfinite(got).all())
            print(f"kernel swr_sweep_bwd {label} {kind}: "
                  f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(
                    f"swr_sweep_bwd disagrees with the plain backward "
                    f"({label}, {kind}): max_abs={max_abs:.3e} > "
                    f"{BWD_TOL} (+{BWD_TOL} rel)"
                )
            worst = max(worst, max_abs)
            if label.startswith("training"):
                again = chunk_sweep_bwd(*args, frames, g, nq, kind)
                rerun = float((again - got).abs().max())
                del got, want, again
                timing[(nq, kind)] = _time_bwd(
                    torch, label, args, frames, g, out, v, nq, kind, flush)
                timing[(nq, kind)]["rerun_max_abs"] = rerun
                print(f"  second run of {label} {kind}: max |difference| "
                      f"from the first {rerun:.3e}", flush=True)
            del out, v
    torch.cuda.synchronize()
    return worst, timing


def _time_bwd(torch, label, args, frames, g, out, v, nq, kind, flush):
    """The backward kernel's warm and cold medians beside its bound, and the
    plain backward's warm median (autograd through the plain sweep's
    retained graph); printed and returned as a dict."""
    from taichi_nerfs_torch.ops.swr_sweep import chunk_sweep_bwd

    def run():
        return chunk_sweep_bwd(*args, frames, g, nq, kind)

    warm = _time_ms(torch, run, 10)
    cold = _time_ms(torch, run, 10, flush)
    plain = _time_ms(torch, lambda: torch.autograd.grad(
        out, v, g, retain_graph=True), 5)
    bound, by, nbytes, flops = sweep_bwd_bound(*args[0].shape, nq, kind)
    print(f"  time {label} {kind}: kernel warm {warm:.4f} ms, cold "
          f"{cold:.4f} ms; bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB,"
          f" {flops / 1e9:.3f} GFLOP), share warm {bound / warm:.1%}, cold "
          f"{bound / cold:.1%}; plain backward {plain:.4f} ms (medians, CUDA "
          "events)", flush=True)
    return dict(warm=warm, cold=cold, plain=plain, bound=bound, by=by)


def _keep_off_the_gate(torch, rng, args, nq):
    """Make the resampled sigma stay above 0 at every lattice point: sigma
    voxels in [0.5, 1.5] (a baked grid's channel 0 is >= 0) and a lattice
    inside [2, R - 3], so no tap falls in the zero padding.

    The backward's gradient jumps where resampled sigma crosses 0 (the
    clamp gate); there the kernel's tap sum and the plain version's matmul
    can round to opposite signs, and both are right.  Measured on the card
    with inputs that reach the border: 1-9 voxels of 16.8 M, all in the
    sigma channel, all cubic.  The gate itself is held by the
    clamp-binding case."""
    vol, rs = args[0], args[1]
    nc, dc, _, R, _ = vol.shape
    vol[:, :, 0] = torch.as_tensor(
        rng.uniform(0.5, 1.5, (nc, dc, R, R)).astype("float32"),
        device=vol.device)
    span = (R - 5.0) / (nq - 1)
    for k in (0, 2):  # (start, step) of the b and c axes
        rs[..., k] = torch.as_tensor(
            rng.uniform(2.0, 2.5, (nc, dc)).astype("float32"),
            device=vol.device)
        rs[..., k + 1] = torch.as_tensor(
            (span * rng.uniform(0.95, 1.0, (nc, dc))).astype("float32"),
            device=vol.device)


def _clamp_case(torch):
    """The seed-3 sweep inputs of tests/test_swr_pallas.py, under which
    Catmull-Rom undershoot drives resampled sigma below 0 (the test pins
    it on the CPU): the backward's clamp gate is exercised."""
    import numpy as np

    rng = np.random.default_rng(3)
    nc, dc, F, Rb, Rc = 2, 3, 4, 8, 8
    vol = rng.normal(0.3, 1.0, (nc, dc, F, Rb, Rc)).astype(np.float32)
    vol[np.abs(vol[:, :, 0:1].repeat(F, 2)) < 0.05] += 0.1
    rs = np.stack(
        [rng.uniform(-1.0, 1.0, (nc, dc)), rng.uniform(0.7, 1.3, (nc, dc)),
         rng.uniform(-1.0, 1.0, (nc, dc)), rng.uniform(0.7, 1.3, (nc, dc))],
        axis=-1,
    ).astype(np.float32)
    z_rel = np.linspace(1.0, 2.0, nc * dc, dtype=np.float32).reshape(nc, dc)
    ch = np.stack(
        [rng.uniform(-0.5, 0.0, nc), rng.uniform(0.01, 0.05, nc),
         rng.uniform(-0.5, 0.0, nc), rng.uniform(0.01, 0.05, nc),
         np.full(nc, 1.5), np.full(nc, 0.1)],
        axis=-1,
    ).astype(np.float32)
    return [torch.as_tensor(a, device="cuda") for a in (vol, rs, z_rel, ch)]


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


def phase_train(torch, seed, device="cuda"):
    """Train the record configuration on procedural lego views made on the
    card, through all three coarse-to-fine phases."""
    import dataclasses

    import numpy as np

    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.ops.swr_sweep import chunk_sweep, chunk_sweep_bwd
    from taichi_nerfs_torch.render.serve import record_config
    from taichi_nerfs_torch.train.metrics import psnr
    from taichi_nerfs_torch.train.swr_step import (
        SwrTrainConfig,
        SwrTrainer,
        make_swr_loss,
        tree_leaves,
    )

    device = torch.device(device)
    t0 = time.perf_counter()
    spec = f"synthetic://lego?views=8&res={RECORD_WH[0]}"
    train = SyntheticSphereDataset(spec, split="train", device=device)
    test = SyntheticSphereDataset(variant="lego", n_images=2,
                                  img_wh=RECORD_WH, split="test",
                                  device=device)
    torch.cuda.synchronize()
    print(f"train: {len(train)} train + {len(test)} test lego views at "
          f"{train.img_wh} made on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    mcfg = record_config()
    tcfg = SwrTrainConfig(
        crop=256, lr=1e-2, max_steps=TRAIN_STEPS, n_chunks=16,
        resample_kind="cubic", alpha_w=0.2, random_bg=True, tv_w=5e-4,
        sigma_l1=1e-5, prog_steps=PROG_STEPS,
    )
    trainer = SwrTrainer(mcfg, tcfg, train.rays, train.poses, train.K,
                         train.img_wh, seed=seed, alphas=train.alphas,
                         device=device)
    evals = _fixed_crops(torch, trainer, seed)
    loss0 = _fixed_loss(torch, trainer, evals)
    torch.cuda.synchronize()

    chunk_sweep.launches = 0
    chunk_sweep_bwd.launches = 0
    losses, step_ms, levels = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = trainer.run_step()
        loss = float(m["loss"])  # waits for the step
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        levels.append(len(trainer.state.params["levels"]))
        print(f"train step {trainer.step - 1}: {levels[-1]} "
              f"levels (R={trainer.cur_mcfg.grid_res}, lattice "
              f"{trainer.lat_size or tcfg.crop + 16}) loss={loss:.6f} "
              f"psnr={float(m['psnr']):.3f} {step_ms[-1]:.2f} ms", flush=True)
    launches = (chunk_sweep.launches, chunk_sweep_bwd.launches)
    print(f"train: launches during the {TRAIN_STEPS} steps: swr_sweep_fwd "
          f"{launches[0]}, swr_sweep_bwd {launches[1]}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if set(levels) != {2, 3, 4}:
        raise AssertionError(f"phases not all run: levels {levels}")
    if min(launches) <= 0:
        raise AssertionError(f"a sweep kernel never launched: {launches}")
    loss1 = _fixed_loss(torch, trainer, evals)
    print(f"train: loss on {len(evals)} fixed crops, initial {loss0:.6f}, "
          f"after {TRAIN_STEPS} steps {loss1:.6f} (ratio "
          f"{loss1 / loss0:.4f}, must be < {LOSS_FALL}); training-step "
          f"losses, mean of the first 4 {np.mean(losses[:4]):.6f}, of the "
          f"last 4 {np.mean(losses[-4:]):.6f}", flush=True)
    if not loss1 < LOSS_FALL * loss0:
        raise AssertionError(f"the loss did not fall: {loss0} -> {loss1}")
    # step times: the first step of each phase builds its state; the rest
    # are steady
    starts = {0, PROG_STEPS[0], PROG_STEPS[0] + PROG_STEPS[1]}
    steady = [(lv, ms) for k, (lv, ms) in enumerate(zip(levels, step_ms))
              if k not in starts]
    by_phase = {lv: [ms for l2, ms in steady if l2 == lv] for lv in (2, 3, 4)}
    for lv, ms in by_phase.items():
        print(f"train: {lv} levels (R={mcfg.resolutions[lv - 1]}), steady "
              f"step times {[round(x, 3) for x in ms]} ms, median "
              f"{_median(ms):.3f} ms", flush=True)

    # one full-depth step's gradient, kernels vs plain sweep, on one crop,
    # background and TV window
    i, crop_xy, bg, tv_starts = trainer.draw()
    axis, flip = trainer._axis_flip[i]
    from taichi_nerfs_torch.render.swr import pick_warp

    warp = pick_warp(trainer.poses_np[i], trainer.K, (256, 256), axis,
                     crop_xy=crop_xy)
    grads = {}
    for impl in ("auto", "reference"):
        loss_fn = make_swr_loss(
            trainer.images[i], trainer.poses_np[i], trainer.K, crop_xy,
            trainer.cur_mcfg, dataclasses.replace(tcfg, sweep_impl=impl),
            axis, flip, bg, tv_starts, trainer.lat_size, warp,
        )
        loss, _ = loss_fn(trainer.state.params)
        grads[impl] = torch.autograd.grad(
            loss, trainer.state.params["levels"])
    torch.cuda.synchronize()
    worst_grad = 0.0
    for lv, (a, b) in enumerate(zip(grads["auto"], grads["reference"])):
        rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        worst_grad = max(worst_grad, rel)
        print(f"train: level {lv} gradient, kernels vs plain sweep: "
              f"relative norm {rel:.3e}", flush=True)
        if not rel <= GRAD_TOL:
            raise AssertionError(f"level {lv} gradient differs by {rel} > "
                                 f"{GRAD_TOL}")
    del grads

    t0 = time.perf_counter()
    out = trainer.render(test.poses[0], lat_cap=None)
    torch.cuda.synchronize()
    rgb = out["rgb"]
    if not bool(torch.isfinite(rgb).all()) or tuple(rgb.shape) != (
            RECORD_WH[0] * RECORD_WH[1], 3):
        raise AssertionError("the uncapped test render is not finite")
    p = float(psnr(rgb, torch.as_tensor(test.rays[0], device=device)))
    print(f"train: uncapped test view in {(time.perf_counter() - t0) * 1e3:.2f}"
          f" ms, psnr {p:.3f} dB after {TRAIN_STEPS} steps", flush=True)
    return launches, by_phase, worst_grad


def _grads_kernel_vs_plain(torch, trainer, tag):
    """One full-depth step's level gradients through the kernels and
    through the plain sweep, on one drawn crop, background and TV window;
    raises beyond ``GRAD_TOL``.  Returns the worst relative norm."""
    import dataclasses

    from taichi_nerfs_torch.render.swr import pick_warp
    from taichi_nerfs_torch.train.swr_step import make_swr_loss

    i, crop_xy, bg, tv_starts = trainer.draw()
    axis, flip = trainer._axis_flip[i]
    c = trainer.tcfg.crop
    warp = pick_warp(trainer.poses_np[i], trainer.K, (c, c), axis,
                     crop_xy=crop_xy)
    grads = {}
    for impl in ("auto", "reference"):
        loss_fn = make_swr_loss(
            trainer.images[i], trainer.poses_np[i], trainer.K, crop_xy,
            trainer.cur_mcfg, dataclasses.replace(trainer.tcfg,
                                                  sweep_impl=impl),
            axis, flip, bg, tv_starts, trainer.lat_size, warp,
            trainer.slab_window,
        )
        loss, _ = loss_fn(trainer.state.params)
        grads[impl] = torch.autograd.grad(
            loss, trainer.state.params["levels"])
    torch.cuda.synchronize()
    worst = 0.0
    for lv, (a, b) in enumerate(zip(grads["auto"], grads["reference"])):
        rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        worst = max(worst, rel)
        print(f"{tag}: level {lv} gradient, kernels vs plain sweep: "
              f"relative norm {rel:.3e}", flush=True)
        if not rel <= GRAD_TOL:
            raise AssertionError(f"{tag}: level {lv} gradient differs by "
                                 f"{rel} > {GRAD_TOL}")
    return worst


def phase_default_flags(torch, seed, card):
    """The train entry's configuration from its default flags: every phase
    in the sweep's scope (slab window 0), both kernels launched, the
    gradient through them against the plain sweep's.  Returns the lego
    views (reused by the scan phase), the kernels' launch counts, the
    steady step medians by phase, the worst gradient difference and the
    peak device memory (GiB) over the steps."""
    import numpy as np
    from opt import get_opts

    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.ops.swr_sweep import chunk_sweep, chunk_sweep_bwd
    from taichi_nerfs_torch.train.__main__ import configs
    from taichi_nerfs_torch.train.swr_step import SwrTrainer

    device = torch.device("cuda")
    hp = get_opts([
        "--root_dir", f"synthetic://lego?views=8&res={RECORD_WH[0]}",
        "--dataset_name", "synthetic", "--model_name", "pyramid",
        "--max_steps", str(DEFAULT_STEPS),
        "--prog_steps", ",".join(map(str, DEFAULT_PROG)),
    ])
    t0 = time.perf_counter()
    train = SyntheticSphereDataset(root_dir=hp.root_dir, split=hp.split,
                                   downsample=hp.downsample, device=device)
    torch.cuda.synchronize()
    print(f"default flags: {len(train)} lego views at {train.img_wh} made "
          f"on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    mcfg, tcfg = configs(hp, train)
    print(f"default flags: {mcfg}; {tcfg}", flush=True)
    want = dict(resample_kind="linear", crop=256, features=16, deferred=True,
                grid_res=256)
    have = dict(resample_kind=tcfg.resample_kind, crop=tcfg.crop,
                features=mcfg.features, deferred=mcfg.deferred,
                grid_res=mcfg.grid_res)
    if have != want:
        raise AssertionError(f"default flags gave {have}, not {want}")
    trainer = SwrTrainer(mcfg, tcfg, train.rays, train.poses, train.K,
                         train.img_wh, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    chunk_sweep.launches = 0
    chunk_sweep_bwd.launches = 0
    losses, step_ms, levels = [], [], []
    for _ in range(DEFAULT_STEPS):
        t0 = time.perf_counter()
        m = trainer.run_step()
        loss = float(m["loss"])  # waits for the step
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        levels.append(len(trainer.state.params["levels"]))
        print(f"default flags step {trainer.step - 1}: {levels[-1]} levels "
              f"(R={trainer.cur_mcfg.grid_res}, lattice "
              f"{trainer.lat_size or tcfg.crop + 16}, slab window "
              f"{trainer.slab_window}) loss={loss:.6f} {step_ms[-1]:.2f} ms",
              flush=True)
        if trainer.slab_window != 0:
            raise AssertionError(f"slab window {trainer.slab_window} in the "
                                 f"phase at R={trainer.cur_mcfg.grid_res}")
    launches = (chunk_sweep.launches, chunk_sweep_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"default flags: launches during the {DEFAULT_STEPS} steps: "
          f"swr_sweep_fwd {launches[0]}, swr_sweep_bwd {launches[1]}",
          flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"default flags: non-finite loss: {losses}")
    if set(levels) != {2, 3, 4}:
        raise AssertionError(f"default flags: levels {levels}")
    if min(launches) <= 0:
        raise AssertionError(f"a sweep kernel never launched: {launches}")
    n0, n1 = DEFAULT_PROG
    starts = {0, n0, n0 + n1}
    by_phase = {lv: _median([ms for k, (l2, ms) in
                             enumerate(zip(levels, step_ms))
                             if l2 == lv and k not in starts])
                for lv in (2, 3, 4)}
    worst = _grads_kernel_vs_plain(torch, trainer, "default flags")
    print(f"default flags: steady step medians by phase (R=64 / 128 / 256): "
          f"{by_phase[2]:.3f} / {by_phase[3]:.3f} / {by_phase[4]:.3f} ms; "
          f"peak device memory over the steps {peak / 2**30:.3f} GiB; "
          f"worst level-gradient difference {worst:.3e} ({card})",
          flush=True)
    return train, launches, by_phase, worst, peak / 2**30


def phase_scan(torch, seed, train, card):
    """The slab scan at the record widths: a split sigma grid, per-sample
    shading and the distortion loss; no sweep kernel may launch."""
    import numpy as np

    from taichi_nerfs_torch.data.cameras import orbit_poses
    from taichi_nerfs_torch.models.pyramid import PyramidConfig
    from taichi_nerfs_torch.ops.swr_sweep import chunk_sweep, chunk_sweep_bwd
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig, SwrTrainer

    device = torch.device("cuda")
    mcfg = PyramidConfig((32, 64, 128, 256), features=8, sigma_res=512,
                         deferred=False)
    tcfg = SwrTrainConfig(crop=256, lr=1e-2, max_steps=SCAN_STEPS,
                          n_chunks=16, distortion_w=1e-3)
    chunk_sweep.launches = 0
    chunk_sweep_bwd.launches = 0
    trainer = SwrTrainer(mcfg, tcfg, train.rays, train.poses, train.K,
                         train.img_wh, seed=seed, device=device)
    evals = _fixed_crops(torch, trainer, seed, n=SCAN_CROPS)
    t0 = time.perf_counter()
    loss0 = _fixed_loss(torch, trainer, evals)
    print(f"scan: the loss on {SCAN_CROPS} fixed crops in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (forward only)",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(SCAN_STEPS):
        t0 = time.perf_counter()
        m = trainer.run_step()
        losses.append(float(m["loss"]))  # waits for the step
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"scan step {trainer.step - 1}: loss={losses[-1]:.6f} "
              f"psnr={float(m['psnr']):.3f} {step_ms[-1]:.2f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated()
    loss1 = _fixed_loss(torch, trainer, evals)
    if not all(np.isfinite(losses)) or not np.isfinite(loss1):
        raise AssertionError(f"scan: non-finite loss: {losses}, {loss1}")
    print(f"scan: loss on {SCAN_CROPS} fixed crops, initial {loss0:.6f}, "
          f"after {SCAN_STEPS} steps {loss1:.6f} (ratio {loss1 / loss0:.4f},"
          f" must be < 1)", flush=True)
    if not loss1 < loss0:
        raise AssertionError(f"scan: the loss did not fall: {loss0} -> "
                             f"{loss1}")
    prof = _profile_step(torch, trainer, "scan")
    t0 = time.perf_counter()
    out = trainer.render(orbit_poses(1)[0], img_wh=RECORD_WH)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    rgb, op = out["rgb"], out["opacity"]
    if tuple(rgb.shape) != (RECORD_WH[0] * RECORD_WH[1], 3) or not bool(
            torch.isfinite(rgb).all() and torch.isfinite(op).all()):
        raise AssertionError("scan: the capped frame is not finite")
    lo, hi = float(op.min()), float(op.max())
    if lo < -1e-6 or hi > 1.0 + 1e-6:
        raise AssertionError(f"scan: opacity in [{lo}, {hi}]")
    launches = (chunk_sweep.launches, chunk_sweep_bwd.launches)
    if launches != (0, 0):
        raise AssertionError(f"scan: the sweep kernels launched {launches}")
    steady = _median(step_ms[1:])
    print(f"scan: split sigma_res=512, per-sample shading, distortion 1e-3, "
          f"R=256, crop 256: steady step median {steady:.3f} ms (steps "
          f"{[round(x, 3) for x in step_ms]}), peak device memory "
          f"{peak / 2**30:.3f} GiB; capped 800x800 frame {frame_ms:.2f} ms, "
          f"opacity in [{lo:.4f}, {hi:.4f}]; sweep launches {launches}; "
          f"profiled step: {prof['launches']} kernel launches, the card busy "
          f"{100.0 * prof['busy']:.1f}% ({card})", flush=True)
    return {"step_ms": steady, "peak_gib": peak / 2**30,
            "frame_ms": frame_ms, "sweep_launches": launches, **prof}


def _profile_step(torch, trainer, tag):
    """One training step under ``torch.profiler``: its kernel launches, the
    card's busy share of its wall time, the top kernels by device time and
    the renderer's spans (host time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer.run_step()["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation),
                  key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kern)
    launches = sum(e.count for e in kern)
    print(f"{tag}: profiled step {wall_us / 1e3:.3f} ms wall, "
          f"{busy_us / 1e3:.3f} ms of kernels ({launches} launches); top "
          "kernels: " + "; ".join(
              f"{e.key[:50]} {e.self_device_time_total / 1e3:.3f} ms x"
              f"{e.count}" for e in kern[:6]), flush=True)
    print(f"{tag}: spans, host time: " + "; ".join(
        f"{e.key} {e.cpu_time_total / 1e3:.3f} ms x{e.count}"
        for e in sorted(avgs, key=lambda e: e.key)
        if e.key.startswith("swr.")), flush=True)
    return {"launches": launches, "busy": busy_us / wall_us,
            "profiled_ms": wall_us / 1e3}


def phase_scan_cpu(torch, seed, card):
    """One scan-path loss and its gradients at a small size on the card and
    on the CPU, from the same params and inputs: full-matrix and windowed
    (a split grid, per-sample shading, the distortion loss)."""
    import numpy as np

    from taichi_nerfs_torch.data.cameras import look_at
    from taichi_nerfs_torch.models.pyramid import (
        PyramidConfig,
        init_pyramid_params,
    )
    from taichi_nerfs_torch.render.swr import sweep_axis
    from taichi_nerfs_torch.train.swr_step import (
        SwrTrainConfig,
        _trainable,
        make_swr_loss,
        tree_leaves,
        tree_map,
    )

    mcfg = PyramidConfig((8, 16), features=4, rgb_width=16, sigma_res=32,
                         sigma_bias=-1.0, deferred=False)
    tcfg = SwrTrainConfig(crop=24, n_chunks=4, tv_w=5e-3, sigma_l1=1e-3,
                          distortion_w=1e-2)
    params = init_pyramid_params(mcfg, torch.Generator().manual_seed(seed))
    R = mcfg.grid_res
    c = (torch.arange(R, dtype=torch.float32) + 0.5) / R - 0.5
    xx, yy, zz = torch.meshgrid(c, c, c, indexing="ij")
    params["levels"][-1][..., 0] += 3.0 * torch.exp(
        -(xx**2 + yy**2 + zz**2) / 0.25**2)
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    pose = look_at(np.array([0.4, -1.2, 0.5]), np.zeros(3),
                   np.array([0.0, 0.0, 1.0]))
    axis, flip = sweep_axis(pose)
    worst = 0.0
    for window, f in ((0, 36.0), (8, 96.0)):
        K = np.array([[f, 0, 20], [0, f, 20], [0, 0, 1]], np.float32)
        res = {}
        for dev in ("cuda", "cpu"):
            p = _trainable(tree_map(lambda t, d=dev: t.to(d), params))
            loss, _ = make_swr_loss(
                torch.as_tensor(img, device=dev), pose, K, (9, 5), mcfg,
                tcfg, axis, flip, None, (2, 5), 40, "matmul", window,
            )(p)
            grads = torch.autograd.grad(loss, tree_leaves(p))
            res[dev] = (float(loss.detach()), [g.cpu() for g in grads])
        (lc, gc), (lh, gh) = res["cuda"], res["cpu"]
        d_loss = abs(lc - lh) / abs(lh)
        d_grad = max(float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
                     for a, b in zip(gc, gh))
        print(f"scan card vs CPU, slab window {window}: loss {lc:.8f} / "
              f"{lh:.8f} (relative {d_loss:.3e}, must be <= {SCAN_LOSS_TOL}),"
              f" worst gradient relative norm {d_grad:.3e} (must be <= "
              f"{SCAN_GRAD_TOL}) ({card})", flush=True)
        if not (d_loss <= SCAN_LOSS_TOL and d_grad <= SCAN_GRAD_TOL):
            raise AssertionError("scan: the card and the CPU disagree")
        worst = max(worst, d_grad)
    return worst


def phase_window(torch, seed, card):
    """A narrow view of the record model whose slab window is 64: rendered
    windowed (the scan) and with the full matrix (the sweep kernel) on the
    card; the two must agree within ``RENDER_TOL``."""
    import numpy as np

    from taichi_nerfs_torch.data.cameras import look_at
    from taichi_nerfs_torch.models import pyramid as pyr
    from taichi_nerfs_torch.ops.swr_sweep import chunk_sweep
    from taichi_nerfs_torch.render.serve import record_config
    from taichi_nerfs_torch.render.swr import render_swr, slab_window_bound

    device = torch.device("cuda")
    cfg = record_config()
    params = _record_params(torch, cfg, seed, device)
    with torch.no_grad():
        grid = pyr.bake(params, cfg)
    w, h = RECORD_WH
    crop = 32
    K = np.array([[4.0 * w, 0, w / 2], [0, 4.0 * w, h / 2], [0, 0, 1]],
                 np.float32)
    pose = look_at(np.array([0.3, 0.2, -1.3]), np.zeros(3),
                   np.array([0.0, 0.0, 1.0]))
    window = slab_window_bound(pose[None], K, (w, h), cfg, crop=crop)
    if window != 64:
        raise AssertionError(f"slab_window_bound gave {window}, not 64")
    x0, y0 = (w - crop) // 2, (h - crop) // 2
    K_crop = K.copy()
    K_crop[0, 2] -= x0
    K_crop[1, 2] -= y0
    outs, ms, launches = {}, {}, {}
    with torch.no_grad():
        for sw in (window, 0):
            render_swr(params, grid, cfg, pose, K_crop, (crop, crop),
                       n_chunks=16, slab_window=sw)  # warm-up
            chunk_sweep.launches = 0
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[sw] = render_swr(params, grid, cfg, pose, K_crop,
                                      (crop, crop), n_chunks=16,
                                      slab_window=sw)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[sw], launches[sw] = _median(times), chunk_sweep.launches
    a, b = outs[window], outs[0]
    diffs = {k: float((a[k] - b[k]).abs().max()) for k in a}
    op = float(b["opacity"].max())
    print(f"window: 800x800 view, focal 4 w, {crop}x{crop} crop, R=256: "
          f"slab window {window}; windowed scan vs full-matrix sweep max_abs "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(diffs.items()))
          + f" (must be <= {RENDER_TOL}); max opacity {op:.4f}; frame "
          f"{ms[window]:.2f} ms windowed ({launches[window]} sweep launches),"
          f" {ms[0]:.2f} ms full ({launches[0]}) ({card})", flush=True)
    if launches[window] != 0 or launches[0] <= 0:
        raise AssertionError(f"window: sweep launches {launches}")
    if op <= 0.5 or not max(diffs.values()) <= RENDER_TOL:
        raise AssertionError(f"window: windowed and full renders differ: "
                             f"{diffs}, max opacity {op}")
    return diffs, ms


def _fixed_crops(torch, trainer, seed, n=4):
    """``n`` training inputs (image, crop, background, TV start 0): the
    centre crop of the first ``n`` training views, where the object is
    (an off-centre crop is mostly background, whose loss is ~0 for a
    transparent model), with backgrounds drawn from their own generator so
    the trainer's draws are untouched."""
    gen = torch.Generator(trainer.device).manual_seed(seed + 1)
    w, h = trainer.img_wh
    c = trainer.tcfg.crop
    xy = ((w - c) // 2, (h - c) // 2)
    return [(i, xy, torch.rand((c * c, 3), generator=gen,
                               device=trainer.device)) for i in range(n)]


def _fixed_loss(torch, trainer, evals):
    """Mean training loss of the current params over ``evals``."""
    from taichi_nerfs_torch.render.swr import pick_warp
    from taichi_nerfs_torch.train.swr_step import make_swr_loss, tv_levels

    c = trainer.tcfg.crop
    tv_starts = (0,) * len(tv_levels(trainer.state.params, trainer.cur_mcfg))
    total = 0.0
    with torch.no_grad():
        for i, xy, bg in evals:
            axis, flip = trainer._axis_flip[i]
            warp = pick_warp(trainer.poses_np[i], trainer.K, (c, c), axis,
                             crop_xy=xy)
            loss, _ = make_swr_loss(
                trainer.images[i], trainer.poses_np[i], trainer.K, xy,
                trainer.cur_mcfg, trainer.tcfg, axis, flip, bg, tv_starts,
                trainer.lat_size, warp, trainer.slab_window,
            )(trainer.state.params)
            total += float(loss)
    return total / len(evals)


def _occupied_share(torch, bitfield):
    words = bitfield.long() & 0xFFFFFFFF
    bits = (words[:, None] >> torch.arange(32, device=words.device)) & 1
    return float(bits.sum()) / (32 * bitfield.numel())


def phase_ngp(torch, seed):
    """Train the flagship NGP configuration, cross-check one render with the
    CPU, render an 800x800 test view and profile 3 steady steps."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from taichi_nerfs_torch.config import config_for_scene
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.ops.rays import get_rays
    from taichi_nerfs_torch.render.renderer import render_image, render_train
    from taichi_nerfs_torch.render.serve import report_profile
    from taichi_nerfs_torch.train.loop import Trainer
    from taichi_nerfs_torch.train.metrics import psnr
    from taichi_nerfs_torch.train.state import tree_map
    from taichi_nerfs_torch.train.step import draw_step, sample_batch

    device = torch.device("cuda")
    cfg = config_for_scene(0.5)
    t0 = time.perf_counter()
    train = SyntheticSphereDataset(n_images=8, img_wh=(256, 256),
                                   variant="checker", device=device)
    test = SyntheticSphereDataset(n_images=1, img_wh=NGP_TEST_WH,
                                  variant="checker", split="test",
                                  device=device)
    torch.cuda.synchronize()
    print(f"ngp: 8 checker views at 256x256 and one at "
          f"{NGP_TEST_WH[0]}x{NGP_TEST_WH[1]} made on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, train.as_batch(device), train.K, train.img_wh,
                      device=device)
    torch.cuda.synchronize()
    print(f"ngp: trainer (visibility marking of {cfg.model.grid_size}^3 "
          f"cells) in {time.perf_counter() - t0:.2f} s; encoder "
          f"{cfg.model.pos_encoder_type} {cfg.model.brick.levels}x"
          f"{cfg.model.brick.feature_per_level}, batch "
          f"{cfg.train.batch_size}", flush=True)

    losses, step_ms = [], []
    for i in range(NGP_STEPS):
        t0 = time.perf_counter()
        m = trainer.run_step()
        losses.append(float(m["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i % 32 == 0 or i == NGP_STEPS - 1:
            print(f"ngp step {i}: loss={losses[-1]:.6f} "
                  f"psnr={float(m['psnr']):.3f} S={trainer.sample_cap} "
                  f"pack={trainer.pack_cap} "
                  f"rm_s={float(m['rm_samples']) / cfg.train.batch_size:.1f}"
                  f" {step_ms[-1]:.2f} ms", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ngp: non-finite loss: {losses}")
    last = float(np.mean(losses[-16:]))
    print(f"ngp: loss first {losses[0]:.6f}, mean of the last 16 {last:.6f} "
          f"(ratio {last / losses[0]:.4f}, must be < {NGP_LOSS_FALL})",
          flush=True)
    if not last < NGP_LOSS_FALL * losses[0]:
        raise AssertionError(f"ngp: the loss did not fall: {losses[0]} -> "
                             f"{last}")
    warm = _median(step_ms[16:NGP_WARMUP])
    steady = _median(step_ms[NGP_WARMUP:])
    interval = cfg.train.update_interval
    refresh = _median(step_ms[NGP_WARMUP::interval])
    occ = _occupied_share(torch, trainer.state.occupancy.bitfield)
    print(f"ngp: median step, warmup (steps 16-{NGP_WARMUP - 1}) "
          f"{warm:.3f} ms, after it {steady:.3f} ms = "
          f"{cfg.train.batch_size / steady * 1e3:.0f} rays/s (the steps "
          f"after it that refresh the grid: {refresh:.3f} ms); final "
          f"sample_cap {trainer.sample_cap}, pack_cap {trainer.pack_cap}; "
          f"occupied cells {100.0 * occ:.2f}%", flush=True)

    # one render_train on the card and on the CPU, same inputs
    gen = torch.Generator(device).manual_seed(seed + 7)
    draws = draw_step(cfg, trainer.data, gen)
    sl = slice(0, NGP_CHECK_RAYS)
    _, pose, direction = sample_batch(trainer.data, draws.img_idxs[sl],
                                      draws.pix_idxs[sl])
    rays_o, rays_d = get_rays(direction, pose)
    cap, pack = trainer.sample_cap, trainer.pack_cap
    params = trainer.state.params
    bitfield = trainer.state.occupancy.bitfield
    outs = []
    with torch.no_grad():
        for dev in (device, torch.device("cpu")):
            t0 = time.perf_counter()
            outs.append(render_train(
                tree_map(lambda p, d=dev: p.detach().to(d), params),
                cfg.model, cfg.render, bitfield.to(dev), rays_o.to(dev),
                rays_d.to(dev), cap, pack, t_noise=draws.t_noise[sl].to(dev)))
            torch.cuda.synchronize()
            print(f"ngp: render_train of {NGP_CHECK_RAYS} rays on "
                  f"{dev.type} in {(time.perf_counter() - t0) * 1e3:.1f} ms",
                  flush=True)
    a, b = outs
    same = (a["counts"].cpu() == b["counts"]).numpy()
    d_rgb = (a["rgb"].cpu() - b["rgb"]).abs().max(dim=1).values.numpy()
    worst = float(d_rgb[same].max())
    print(f"ngp: card vs CPU render_train: equal counts on "
          f"{100.0 * same.mean():.3f}% of rays (must be >= "
          f"{100 * NGP_COUNT_SHARE}%), rgb max_abs {worst:.3e} on them "
          f"(must be <= {NGP_RGB_TOL}), {float(d_rgb.max()):.3e} on all; "
          f"samples {int(a['rm_samples'])} / {int(b['rm_samples'])}",
          flush=True)
    if same.mean() < NGP_COUNT_SHARE or not worst <= NGP_RGB_TOL:
        raise AssertionError("ngp: the card and the CPU disagree")

    # the test-time renderer, 800x800
    rays_o, rays_d = get_rays(
        torch.as_tensor(test.directions, device=device),
        torch.as_tensor(test.poses[0], device=device))
    frame_ms = []
    for _ in range(2):  # the first frame warms the allocator
        t0 = time.perf_counter()
        out = render_image(params, cfg, bitfield, rays_o, rays_d)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    rgb, op = out["rgb"], out["opacity"]
    n_px = NGP_TEST_WH[0] * NGP_TEST_WH[1]
    if tuple(rgb.shape) != (n_px, 3) or not bool(torch.isfinite(rgb).all()):
        raise AssertionError("ngp: the test frame is not finite")
    lo, hi = float(op.min()), float(op.max())
    if lo < -1e-6 or hi > 1.0 + 1e-6:
        raise AssertionError(f"ngp: opacity in [{lo}, {hi}]")
    p = float(psnr(rgb, torch.as_tensor(test.rays[0], device=device)))
    print(f"ngp: {NGP_TEST_WH[0]}x{NGP_TEST_WH[1]} test frame in "
          f"{frame_ms[1]:.2f} ms (first {frame_ms[0]:.2f} ms), "
          f"{out['rounds']} rounds, {out['host_reads']} host reads, "
          f"{int(out['total_samples'])} samples, psnr {p:.3f} dB after "
          f"{NGP_STEPS} steps", flush=True)

    # 3 steady steps under the profiler, none of them a grid refresh (one
    # step in update_interval; its cost is the refresh steps' median above)
    while any((trainer.step + i) % interval == 0 for i in range(3)):
        trainer.run_step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            m = trainer.run_step()
        float(m["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = report_profile(prof, wall_us, "3 steady ngp steps", True, None)
    from torch.autograd import DeviceType

    kern = sorted(
        (e for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
        key=lambda e: -e.self_device_time_total)
    spans = {e.key: e.device_time_total for e in prof.key_averages()
             if e.key.startswith("ngp.")}
    print("ngp: top kernels by device time per step: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 3e3:.3f} ms"
        for e in kern[:8]), flush=True)
    print("ngp: spans, device time per step: " + "; ".join(
        f"{k} {v / 3e3:.3f} ms" for k, v in sorted(spans.items())),
        flush=True)
    return {"warm_ms": warm, "steady_ms": steady, "frame_ms": frame_ms[1],
            "busy": busy_us / wall_us, "occupied": occ}


def ptxas_summary(log):
    """One line per kernel of nvcc's ``-Xptxas -v`` output: the kernel with
    its template arguments, its registers and, if any, its spills."""
    import re

    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(swr_[a-z_]+)I"
                      r"((?:Li\d+E)+)E", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2))
            name = f"{m.group(1)}<{', '.join(args)}>"
        elif "spill" in line and not line.strip().startswith(
                "0 bytes stack frame, 0 bytes spill stores"):
            spill = "; " + line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers"
                       + spill)
            name, spill = "?", ""
    return out


def phase_build():
    """Build every kernel, one ``nvcc`` per source, all started together,
    and print each kernel's registers and spills."""
    from concurrent.futures import ThreadPoolExecutor

    from taichi_nerfs_torch.ops import _build

    names = ("swr_sweep_fwd", "swr_sweep_bwd")
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(_build.build, names))
    for name, (path, log, secs) in zip(names, builds):
        _build.load(name)
        built = f"in {secs:.2f} s" if log else "(already built)"
        print(f"build: {os.path.relpath(path)} {built}", flush=True)
        for line in ptxas_summary(log):
            print(f"  ptxas: {line}", flush=True)


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
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_build()
    worst, timing = phase_kernels(torch)
    worst_bwd, bwd_timing = phase_bwd_kernels(torch)
    serve_launches, frame_ms = phase_slice(torch, args.ckpt_path, args.seed)
    print(f"slice: 800x800 cubic frame median: capped "
          f"{frame_ms['capped']:.3f} ms, uncapped "
          f"{frame_ms['uncapped']:.3f} ms", flush=True)
    (fwd_n, bwd_n), step_ms, worst_grad = phase_train(torch, args.seed)
    print(f"train: median steady full-depth step "
          f"{_median(step_ms[4]):.3f} ms, first phase (R=64) "
          f"{_median(step_ms[2]):.3f} ms; worst level-gradient "
          f"difference {worst_grad:.3e}", flush=True)
    lego, (dfl_fwd, dfl_bwd), dfl_ms, dfl_grad, dfl_gib = (
        phase_default_flags(torch, args.seed, card))
    scan = phase_scan(torch, args.seed, lego, card)
    del lego
    scan_cpu = phase_scan_cpu(torch, args.seed, card)
    window_diffs, window_ms = phase_window(torch, args.seed, card)
    print(f"summary ({card}): default-flag full-depth step "
          f"{dfl_ms[4]:.3f} ms, peak {dfl_gib:.3f} GiB (swr_sweep_fwd "
          f"{dfl_fwd} / swr_sweep_bwd "
          f"{dfl_bwd} launches, gradients within {dfl_grad:.3e}); scan step "
          f"{scan['step_ms']:.3f} ms, peak {scan['peak_gib']:.3f} GiB, capped "
          f"frame {scan['frame_ms']:.2f} ms; scan card vs CPU gradients "
          f"within {scan_cpu:.3e}; windowed frame {window_ms[64]:.2f} ms vs "
          f"full {window_ms[0]:.2f} ms", flush=True)
    ngp = phase_ngp(torch, args.seed)
    print(f"ngp: steady step {ngp['steady_ms']:.3f} ms, warmup step "
          f"{ngp['warm_ms']:.3f} ms, 800x800 frame "
          f"{ngp['frame_ms']:.2f} ms, device busy "
          f"{100.0 * ngp['busy']:.1f}% of 3 profiled steps", flush=True)


    fwd = timing[(816, "cubic")]
    bwd = bwd_timing[(TRAIN_SHAPES[-1][2], "cubic")]
    print(json.dumps({"kernels": [{
        "name": "swr_sweep_fwd",
        "route": "cuda",
        "source": "taichi_nerfs_torch/csrc/swr_sweep_fwd.cu",
        "replaces": "taichi_nerfs_tpu/ops/swr_pallas.py:116",
        # the default-flag (linear) training steps
        "launches": dfl_fwd,
        "launches_by_path": {"serve": serve_launches, "train": fwd_n,
                             "train_default_flags": dfl_fwd,
                             "scan": scan["sweep_launches"][0]},
        "max_abs_err": worst,
        # one chunk of the uncapped 800x800 frame, cubic, warm
        "ms": fwd["warm"],
        "plain_ms": fwd["plain"],
        "bound_ms": fwd["bound"],
        "bound_by": fwd["by"],
        "library_ms": None,  # no single PyTorch call computes the sweep
        "ms_by_shape": {f"nq={nq} {kind}": {k: t[k] for k in
                                            ("warm", "cold", "bound")}
                        for (nq, kind), t in sorted(timing.items())},
    }, {
        "name": "swr_sweep_bwd",
        "route": "cuda",
        "source": "taichi_nerfs_torch/csrc/swr_sweep_bwd.cu",
        "replaces": "taichi_nerfs_tpu/ops/swr_pallas.py:178",
        "launches": dfl_bwd,
        "launches_by_path": {"train": bwd_n, "train_default_flags": dfl_bwd,
                             "scan": scan["sweep_launches"][1]},
        "max_abs_err": worst_bwd,
        # the full-depth training shape, cubic, warm
        "ms": bwd["warm"],
        "cold_ms": bwd["cold"],
        "plain_ms": bwd["plain"],
        "bound_ms": bwd["bound"],
        "bound_by": bwd["by"],
        "library_ms": None,
        "ms_by_shape": {f"nq={nq} {kind}": {k: t[k] for k in
                                            ("warm", "cold", "bound",
                                             "rerun_max_abs")}
                        for (nq, kind), t in sorted(bwd_timing.items())},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
