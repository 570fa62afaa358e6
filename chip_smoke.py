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
   run), and at the default flags' full-depth shape (F=16, linear); both
   kernels are timed warm and cold (after 128 MB written to evict the L2),
   each time beside its bound and its share of it;
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
10. bf16: the bf16 variants and the repo's R=512 record configuration
   (5 levels to 512, the last lean, bf16 bake, bf16 Adam moment, cubic):
   (a) both kernels at every (volume, operand) dtype pair against their
   plain versions, at small ragged and edge-case shapes and at the R=512
   training shape (16, 32, 8, 512, 512, nq=272), timed warm and cold beside
   the bound; (b) ``SwrTrainer`` on the lego views with the phases cut to
   2 + 2 steps and 4 at full depth: both kernels launched with a bf16
   volume at every step, losses finite, one full-depth step's level
   gradients against the plain sweep's (2e-2), the slabs' column windows
   against the row buffer, the steady step, the peak device memory and one
   fp32-bake step's peak; (c) ``PyramidRenderer(bake_dtype="bfloat16")``
   renders a capped and an uncapped 800x800 R=512 frame (finite, opacity
   in [0, 1], rgb within 2e-2 of the fp32-bake frame);
11. inside: a mixed rig on the ``shell`` scene, 8 views from inside the
   cube at 256x256 and 4 from outside of the same density (GT made on the
   card), the record widths (cubic) with ``cam_carve=0.1``, ``near=0.05``
   and random backgrounds, 2 + 2 + 4 steps through the coarse-to-fine
   phases and 3 more full-depth inside steps: losses finite, no sweep
   kernel launched on an inside step (the slab scan), both on every
   outside step (on the carved grid); one 800x800 inside frame through
   ``PyramidRenderer`` and ``SwrTrainer.render`` (within 1e-5; finite,
   opacity in [0, 1], every pixel owned by exactly one cubemap face); the
   step medians, peak device memory, one profiled inside step, one
   ``debug_frames`` frame (its keys and shapes) and one small inside loss
   and its gradients on the card against the CPU (1e-5 / 2e-4);
12. files: 8 train and 4 test lego views at 800x800 written as a Blender
   scene (``export_blender_dataset``) into a temporary directory and loaded
   back (seconds per view); ``python -m taichi_nerfs_torch.train
   --dataset_name nerf`` trains the pyramid on them at the record recipe
   (without its opacity term: files carry no GT alpha) for 2 + 2 + 4 steps
   (both kernels launched, the eval finite), and NGP for 32 steps (losses
   finite);
13. ngp: the sample-gather NGP path at the flagship ``config_for_scene(0.5)``
   (brick encoder, 128^3 occupancy grid, batch 8192) trains 320 steps with
   ``Trainer`` on 8 checker views made on the card (past the 256-step
   warmup, so the sparse grid refresh runs); every loss must be finite and
   the mean of the last 16 below half the first.  One ``render_train`` on
   4,096 rays runs on the card and on the CPU from identical params,
   bitfield and draws (equal counts on >= 99.9 % of rays, rgb within
   2e-2); ``render_image`` renders an 800x800 test view (finite, opacity in
   [0, 1]); 3 steady steps run under ``torch.profiler``.  This path has no
   hand-written kernel (the JAX package has no TPU kernel on it);
14. ngp_models: the tri-plane encoder (``config_for_scene(0.5,
   pos_encoder_type="triplane")``, the default ``TriPlaneConfig``: a
   3 x 1024^2 x 4 table) and the svox voxel grid (``--grid_size 256
   --sh_degree 2 --grid_radius 0.0125``: 256^3 x 27 SH coefficients) each
   train 320 steps on the ngp phase's views (losses finite, the mean of the
   last 16 below the first), run the ngp phase's card-vs-CPU
   ``render_train`` check and render an 800x800 test view (finite, opacity
   in [0, 1]); the steady step, peak device memory and frame time printed;
15. export: ``python -m taichi_nerfs_torch.train --deployment
   --encoder_type hash`` trains the deployment model 64 steps;
   ``deployment.npy`` is read back and the params rebuilt from it give the
   trained model's field on the card exactly; ``export_native`` writes
   ``.bin`` files equal to the dict's arrays; ``export_pyramid_native`` of
   the train phase's record model writes a ``grid.bin`` within fp16
   rounding of the bake on the card; seconds and bytes printed;
16. viewer: the headless ``NGPGUI`` renders 4 800x800 frames of the ngp
   phase's model (the last equal to ``render_image`` at its pose) and 8 of
   the train phase's record model through ``SwrTrainer.render`` (finite,
   ``swr_sweep_fwd`` launched, the first equal to ``SwrTrainer.render`` at
   its pose); each model's frame-time median and spread printed;
17. parallel: data-parallel training (``parallel/``) at full width on 8
   checker views at 256x256: the flagship NGP configuration (its MLPs in
   fp32, a refresh every 2 steps) for 4 steps after a warm-up and a steady
   refresh from its first state, and the record pyramid at full depth
   (crop 256, cubic, 16 chunks) for 2 crop-parallel steps; (a) on
   ``cuda:0`` as a real NCCL process group of one rank, (b) on two ranks
   sharing ``cuda:0`` over gloo (NCCL refuses two ranks on one card).  Each
   against one process on the card: the refreshes equal (density grid 2e-6
   / 2e-5, bitfields equal), the first step's loss within 1e-5 and params
   within 2e-6 (but where both runs' gradient is below 1e-8, whose sign
   the atomics of either run decide; at most a 1e-5 share), the NGP steps
   of the ranks against the one-process steps, the pyramid's against the
   mean of the ranks' crops' gradients with Adam once; every rank's params
   bitwise equal, both sweep kernels launched on every rank; step times
   (the two ranks share one card: not a scaling figure) and peak memory a
   rank.

Prints each new phase's seconds and the run's total, one JSON line with
the kernels' numbers and, last, one JSON line ``{"ok": true, "device":
{...}}``.  Any failure raises (exit code != 0).  The new phases' summary
lines carry the card's name and power limit.

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
# the bf16 phase: the repo's R=512 record
# (docs/records/lego_proxy_r512_negative.manifest.json) and its full-depth
# training step's sweep shape (n_chunks, dc, F, R, nq); its coarse-to-fine
# phases cut to 2 + 2 steps, then 4 at full depth (3 steady)
R512_LEVELS, R512_LEVEL_FEATURES = (32, 64, 128, 256, 512), (8, 8, 8, 8, 4)
R512_SHAPE = (16, 32, 8, 512, 272)
BF16_PROG, BF16_STEPS = (2, 2), 8
# the (volume, operand) dtype pairs of both kernels
DTYPE_PAIRS = (("float32", "float32"), ("float32", "bfloat16"),
               ("bfloat16", "float32"), ("bfloat16", "bfloat16"))
# kernel against plain version at the R=512 shape, max abs, by operand
# dtype: fp32 operands compute the same fp32 function (a bf16 volume is
# exact in fp32); bf16 operands round each pass-1 value, and a last-bit
# difference of the fp32 tap sum can move it to the neighbouring bf16 value
BF16_FWD_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# the same at the small ragged and edge-case shapes and the served chunks,
# whose larger alphas carry such a one-ulp move further: the JAX package's
# bf16 tolerance (tests/test_half.py)
BF16_SMALL_FWD_TOL = 2e-2
# Max abs cannot tell those moves from a kernel that skips the roundings
# (scripts/torch_sweep_bf16_tol.py on the H100: the kernels within 2.0e-3
# max abs at the small shapes, such a kernel 2.8e-4 to 3.1e-2).  Relative
# norms can, and every bf16-operand case is held to them: frames (the
# kernels within 6.0e-5, such a kernel 8.1e-4 or more) and d vol (the
# kernels within 9.3e-5 at any dtype pair; such a backward 4.5e-3 or more,
# one that rounds t per 64-column tile up to 2.7e-3, 4.7e-4 at R=512)
BF16_FWD_REL_TOL = 3e-4
BF16_DVOL_TOL = 2.5e-4
# one full-depth step's level gradients through the kernels vs the plain
# sweep, and the bf16-bake frame against the fp32-bake frame
BF16_GRAD_TOL, BF16_RGB_TOL = 2e-2, 2e-2
# the kernels' row buffer, columns (csrc/swr_sweep_common.cuh kRowCols)
ROW_COLS = 160


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


def sweep_fwd_bound(nc, dc, F, Rb, Rc, nq, kind, vol_bytes=4):
    """The forward's bound: each input read once (vol, of ``vol_bytes`` a
    voxel, rs_par, z_rel, ch_par) and the frames written once; the
    separable resample plus the composite's 2 (F - 1) + 10 flops per
    lattice point and slab."""
    nbytes = (vol_bytes * nc * dc * F * Rb * Rc
              + 4 * (nc * dc * 5 + nc * 6 + nc * (F + 2) * nq * nq))
    flops = (_resample_flops(nc, dc, F, Rc, nq, kind)
             + nc * dc * nq * nq * (2 * (F - 1) + 10))
    return (*_bound_ms(nbytes, flops), nbytes, flops)


def sweep_bwd_bound(nc, dc, F, Rb, Rc, nq, kind, vol_bytes=4):
    """The backward's bound: vol, the parameters, the frames' tau channel
    (the only one it reads) and g read once, dvol (vol's dtype, of
    ``vol_bytes`` a voxel) written once; the forward's resample again, its
    transpose (the same count) and the reverse composite's 4 (F - 1) + 20
    flops per lattice point and slab.  The fp32 scratch of the transposed
    pass (a bf16 volume or bf16 operands) is the implementation's cost, not
    the function's: it is not counted."""
    nbytes = (vol_bytes * 2 * nc * dc * F * Rb * Rc
              + 4 * (nc * dc * 5 + nc * 6 + nc * nq * nq
                     + nc * (F + 2) * nq * nq))
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
# training step's 16 chunks, at the record's F=8 and at the default flags'
# F=16 (which train linear only)
FWD_TIMED = (("serving nq=816", (1, 16, 8, 256, 816)),
             ("serving nq=336", (1, 16, 8, 256, 336)),
             ("training nq=272", (16, 16, 8, 256, 272)),
             ("training F=16 nq=272", (16, 16, 16, 256, 272)))


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
        kinds = ("linear",) if "F=16 nq" in label else ("linear", "cubic")
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
                timing[(label, kind)] = _time_fwd(
                    torch, label, args, nq, kind, flush)
        del args
    torch.cuda.synchronize()
    return worst, timing


def _time_fwd(torch, label, args, nq, kind, flush, dtype=None):
    """The forward kernel's warm and cold medians beside its bound, and the
    plain version's warm median; printed and returned as a dict.  ``dtype``
    is the resample operand dtype (fp32 by default)."""
    from taichi_nerfs_torch.ops.swr_sweep import (
        chunk_sweep,
        chunk_sweep_reference,
    )

    dtype = dtype or torch.float32
    nc, dc, F, Rb, Rc = args[0].shape
    warm = _time_ms(torch, lambda: chunk_sweep(*args, nq, kind, dtype=dtype),
                    20)
    cold = _time_ms(torch, lambda: chunk_sweep(*args, nq, kind, dtype=dtype),
                    20, flush)
    plain = _time_ms(torch, lambda: chunk_sweep_reference(
        *args, nq, kind, dtype=dtype), 3 if nc > 1 else 10)
    bound, by, nbytes, flops = sweep_fwd_bound(
        nc, dc, F, Rb, Rc, nq, kind, args[0].element_size())
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
    ] + [
        # the default flags' full-depth step: F=16, linear
        ("training F=16 R=256 nq=272", dict(nc=16, dc=16, F=16, R=256,
                                            nq=272, realistic=True),
         ("linear",)),
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
                timing[(label, kind)] = _time_bwd(
                    torch, label, args, frames, g, out, v, nq, kind, flush)
                timing[(label, kind)]["rerun_max_abs"] = rerun
                print(f"  second run of {label} {kind}: max |difference| "
                      f"from the first {rerun:.3e}", flush=True)
            del out, v
    torch.cuda.synchronize()
    return worst, timing


def _time_bwd(torch, label, args, frames, g, out, v, nq, kind, flush,
              dtype=None):
    """The backward kernel's warm and cold medians beside its bound, and the
    plain backward's warm median (autograd through the plain sweep's
    retained graph); printed and returned as a dict."""
    from taichi_nerfs_torch.ops.swr_sweep import chunk_sweep_bwd

    dtype = dtype or torch.float32

    def run():
        return chunk_sweep_bwd(*args, frames, g, nq, kind, dtype=dtype)

    warm = _time_ms(torch, run, 10)
    cold = _time_ms(torch, run, 10, flush)
    plain = _time_ms(torch, lambda: torch.autograd.grad(
        out, v, g, retain_graph=True), 5)
    bound, by, nbytes, flops = sweep_bwd_bound(
        *args[0].shape, nq, kind, args[0].element_size())
    print(f"  time {label} {kind}: kernel warm {warm:.4f} ms, cold "
          f"{cold:.4f} ms; bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB,"
          f" {flops / 1e9:.3f} GFLOP), share warm {bound / warm:.1%}, cold "
          f"{bound / cold:.1%}; plain backward {plain:.4f} ms (medians, CUDA "
          "events)", flush=True)
    return dict(warm=warm, cold=cold, plain=plain, bound=bound, by=by)


def _device_ms_by_kernel(torch, fn, reps=5):
    """Device ms of each kernel (and memset) that ``fn`` launches once, by
    short name: the mean over the launches ``torch.profiler``'s CUDA
    activity recorded in ``reps`` runs (it may record fewer than it ran)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.count:
            continue
        m = re.search(r"swr_sweep_\w+_kernel|Memset", e.key)
        name = m.group(0) if m else e.key[:40]
        out[name] = e.self_device_time_total / (1e3 * e.count)
    return out


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
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig, SwrTrainer

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
    draw = trainer.draw()
    grads = {}
    for impl in ("auto", "reference"):
        loss, _ = trainer.loss_fn(
            draw, dataclasses.replace(tcfg, sweep_impl=impl))(
                trainer.state.params)
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
    # the trained model goes on to the export and viewer phases: free the
    # Adam moments
    trainer.state = trainer.state._replace(opt_state=None)
    record = {"trainer": trainer, "pose": test.poses[0], "poses": test.poses}
    return launches, by_phase, worst_grad, record


def _grads_kernel_vs_plain(torch, trainer, tag, tol=GRAD_TOL):
    """One full-depth step's level gradients through the kernels and
    through the plain sweep, on one drawn crop, background and TV window;
    raises beyond ``tol``.  Returns the worst relative norm."""
    import dataclasses

    draw = trainer.draw()
    grads = {}
    for impl in ("auto", "reference"):
        loss, _ = trainer.loss_fn(draw, dataclasses.replace(
            trainer.tcfg, sweep_impl=impl))(trainer.state.params)
        grads[impl] = torch.autograd.grad(
            loss, trainer.state.params["levels"])
    torch.cuda.synchronize()
    worst = 0.0
    for lv, (a, b) in enumerate(zip(grads["auto"], grads["reference"])):
        rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        worst = max(worst, rel)
        print(f"{tag}: level {lv} gradient, kernels vs plain sweep: "
              f"relative norm {rel:.3e}", flush=True)
        if not rel <= tol:
            raise AssertionError(f"{tag}: level {lv} gradient differs by "
                                 f"{rel} > {tol}")
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


def _profile_step(torch, trainer, tag, draw=None):
    """One training step (on ``draw``, or the trainer's next) under
    ``torch.profiler``: its kernel launches, the card's busy share of its
    wall time, the top kernels by device time and the renderer's spans
    (host time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer.run_step(draw)["loss"])
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

# ------------------------------------------------------------------ bf16


def r512_config():
    """The repo's R=512 record (``docs/records/
    lego_proxy_r512_negative.manifest.json``): 5 levels 32 ... 512, the
    last one lean (4 channels), deferred shading."""
    from taichi_nerfs_torch.models.pyramid import PyramidConfig

    return PyramidConfig(resolutions=R512_LEVELS, features=8,
                         level_features=R512_LEVEL_FEATURES, rgb_width=64,
                         rgb_depth=2, scale=0.5, sigma_bias=-2.0,
                         deferred=True)


def _r512_sweep_inputs(torch, seed):
    """The R=512 training step's sweep operands, made on the card: random
    channels around 0.3, sigma voxels in [0.5, 1.5] and a lattice inside
    [2, R - 3] (``_keep_off_the_gate``: resampled sigma stays off the clamp
    gate, where kernel and plain version may round to opposite sides), the
    chunk geometry of ``_rand_sweep_inputs(realistic=True)``."""
    nc, dc, F, R, nq = R512_SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)

    def uni(lo, hi, shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    vol = torch.randn((nc, dc, F, R, R), generator=gen, device=dev).add_(0.3)
    vol[:, :, 0] = uni(0.5, 1.5, (nc, dc, R, R))
    span = (R - 5.0) / (nq - 1)
    st = uni(2.0, 2.5, (nc, dc, 2))
    sp = span * uni(0.95, 1.0, (nc, dc, 2))
    rs = torch.stack([st[..., 0], sp[..., 0], st[..., 1], sp[..., 1]],
                     -1).contiguous()
    z_rel = torch.linspace(1.0, 2.0, nc * dc, device=dev).reshape(nc, dc)
    ch = torch.stack([
        uni(-0.5, 0.0, (nc,)), torch.full((nc,), 1.0 / (nq - 16), device=dev),
        uni(-0.5, 0.0, (nc,)), torch.full((nc,), 1.0 / (nq - 16), device=dev),
        torch.full((nc,), 1.5, device=dev), torch.full((nc,), 1.0 / R,
                                                       device=dev),
    ], -1).contiguous()
    g = torch.randn((nc, F + 2, nq, nq), generator=gen, device=dev)
    return [vol, rs, z_rel, ch], g, nq


def _rel_norm(got, want):
    """||got - want|| / ||want|| in fp64."""
    got, want = got.double(), want.double()
    return float((got - want).norm()) / max(float(want.norm()), 1e-30)


def _pair_label(vol_dtype, op_dtype):
    short = {"float32": "f32", "bfloat16": "bf16"}
    return f"vol={short[vol_dtype]} ops={short[op_dtype]}"


def _bf16_small_cases(torch):
    """Both kernels for the three pairs with a bf16 volume or bf16
    operands, against their plain versions, at ragged shapes (F 4/8/16) and
    the forward's edge cases (F=8), linear and cubic.  Forward within
    ``BF16_SMALL_FWD_TOL`` max abs and ``BF16_FWD_REL_TOL`` relative norm
    where the operands are bf16 (else KERNEL_TOL), ``d vol`` of the
    volume's dtype within ``BF16_DVOL_TOL`` relative norm.
    Returns the worst forward error and ``d vol`` relative norm."""
    import numpy as np

    from taichi_nerfs_torch.ops.swr_sweep import (
        chunk_sweep,
        chunk_sweep_bwd,
        chunk_sweep_bwd_reference,
        chunk_sweep_reference,
    )

    rng = np.random.default_rng(2)
    cases = [(f"ragged F={F}", dict(nc=2, dc=3, F=F, R=40, nq=37,
                                    realistic=False)) for F in (4, 8, 16)]
    cases += [(f"{label} F=8", dict(shp, F=8, realistic=False))
              for label, shp in FWD_EDGE_CASES]
    worst_fwd, worst_dvol = 0.0, 0.0
    for label, shp in cases:
        nq = shp["nq"]
        args = _rand_sweep_inputs(torch, rng, **shp)
        kinds = ("linear", "cubic")
        if label.startswith("non-finite"):
            for c, s, k, v in NON_FINITE_RS:
                args[1][c, s, k] = v
            kinds = ("cubic",)
        nc, _, F = args[0].shape[:3]
        g = torch.randn((nc, F + 2, nq, nq), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(9))
        for vdt, odt in DTYPE_PAIRS[1:]:
            v = args[0].to(getattr(torch, vdt))
            a = [v, *args[1:]]
            dt = getattr(torch, odt)
            tol = BF16_SMALL_FWD_TOL if odt == "bfloat16" else KERNEL_TOL
            for kind in kinds:
                got = chunk_sweep(*a, nq, kind, dtype=dt)
                want = chunk_sweep_reference(*a, nq, kind, dtype=dt)
                dv = chunk_sweep_bwd(*a, got, g, nq, kind, dtype=dt)
                dw = chunk_sweep_bwd_reference(*a, g, nq, kind, dtype=dt)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                frel = _rel_norm(got, want)
                rel = _rel_norm(dv, dw)
                ok = (err <= tol and rel <= BF16_DVOL_TOL
                      and (odt == "float32" or frel <= BF16_FWD_REL_TOL)
                      and dv.dtype == v.dtype
                      and bool(torch.isfinite(got).all())
                      and bool(torch.isfinite(dv).all()))
                print(f"bf16 kernels {label} {_pair_label(vdt, odt)} {kind}: "
                      f"forward max_abs={err:.3e} relative norm {frel:.3e}, "
                      f"d vol ({dv.dtype}) relative norm {rel:.3e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(
                        f"bf16 kernels disagree with the plain versions "
                        f"({label}, {vdt}/{odt}, {kind}): forward {err:.3e} "
                        f"(limit {tol}), relative norm {frel:.3e} (limit "
                        f"{BF16_FWD_REL_TOL} with bf16 operands), d vol "
                        f"{rel:.3e} (limit {BF16_DVOL_TOL}), d vol dtype "
                        f"{dv.dtype}")
                worst_fwd = max(worst_fwd, err)
                worst_dvol = max(worst_dvol, rel)
        del args
    return worst_fwd, worst_dvol


def phase_bf16_kernels(torch, seed, card):
    """Both kernels at every (volume, operand) dtype pair: at small ragged
    and edge-case shapes, then at the R=512 training shape, cubic, against
    their plain versions (forward max abs within ``BF16_FWD_TOL``, and
    with bf16 operands relative norm within ``BF16_FWD_REL_TOL``; ``d vol``
    within ``BF16_DVOL_TOL`` relative norm, in the volume's dtype), each
    timed warm and cold beside its bound and share, with the plain
    version's time and the backward's device time by kernel."""
    from taichi_nerfs_torch.ops.swr_sweep import (
        chunk_sweep,
        chunk_sweep_bwd,
        chunk_sweep_reference,
    )

    small_fwd, small_dvol = _bf16_small_cases(torch)
    base, g, nq = _r512_sweep_inputs(torch, seed)
    nc, dc, F, R, _ = R512_SHAPE
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    res = {}
    for vdt, odt in DTYPE_PAIRS:
        pair = _pair_label(vdt, odt)
        label = f"R=512 nq={nq} {pair}"
        args = [base[0].to(getattr(torch, vdt)), *base[1:]]
        dt = getattr(torch, odt)
        frames = chunk_sweep(*args, nq, "cubic", dtype=dt)
        want = chunk_sweep_reference(*args, nq, "cubic", dtype=dt)
        got_d = chunk_sweep_bwd(*args, frames, g, nq, "cubic", dtype=dt)
        v = args[0].clone().requires_grad_(True)
        out = chunk_sweep_reference(v, *args[1:], nq, "cubic", dtype=dt)
        (want_d,) = torch.autograd.grad(out, v, g, retain_graph=True)
        torch.cuda.synchronize()
        err = float((frames - want).abs().max())
        frel = _rel_norm(frames, want)
        rel = _rel_norm(got_d, want_d)
        tol = BF16_FWD_TOL[odt]
        ok = (err <= tol and rel <= BF16_DVOL_TOL
              and (odt == "float32" or frel <= BF16_FWD_REL_TOL)
              and got_d.dtype == args[0].dtype
              and bool(torch.isfinite(frames).all())
              and bool(torch.isfinite(got_d).all()))
        print(f"bf16 kernels {label} cubic: forward max_abs={err:.3e} "
              f"(limit {tol}) relative norm {frel:.3e}, d vol "
              f"({got_d.dtype}) relative norm {rel:.3e} (limit "
              f"{BF16_DVOL_TOL}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(
                f"bf16 kernels at the R=512 shape ({pair}): forward "
                f"{err:.3e} > {tol}, relative norm {frel:.3e} > "
                f"{BF16_FWD_REL_TOL} (bf16 operands) or d vol {rel:.3e} > "
                f"{BF16_DVOL_TOL} or d vol dtype {got_d.dtype}")
        del want, got_d, want_d
        fwd = _time_fwd(torch, f"{label} forward", args, nq, "cubic", flush,
                        dt)
        bwd = _time_bwd(torch, f"{label} backward", args, frames, g, out, v,
                        nq, "cubic", flush, dt)
        # the backward's launches apart: the memset, the sweep kernel and,
        # with a bf16 volume or bf16 operands, swr_sweep_bwd_rows_kernel
        bwd["parts"] = _device_ms_by_kernel(torch, lambda: chunk_sweep_bwd(
            *args, frames, g, nq, "cubic", dtype=dt))
        print(f"  {label} backward, device ms by kernel: " + ", ".join(
            f"{k} {x:.4f}" for k, x in bwd["parts"].items()), flush=True)
        res[pair] = {"fwd": dict(fwd, max_abs_err=err, rel_norm_err=frel),
                     "bwd": dict(bwd, rel_norm_err=rel)}
        del out, v, frames, args
    del base, g, flush
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"bf16 kernels ({card}): small shapes forward within "
          f"{small_fwd:.3e}, d vol within {small_dvol:.3e} relative norm; "
          "R=512 nq=272 cubic, warm ms (forward / backward) and share of "
          "the bound: " + "; ".join(
              f"{p} " + " / ".join(
                  f"{r[k]['warm']:.4f} ({r[k]['bound'] / r[k]['warm']:.1%})"
                  for k in ("fwd", "bwd"))
              for p, r in res.items()), flush=True)
    return {"small_fwd": small_fwd, "small_dvol": small_dvol, "r512": res}


def _window_paths(rs, nq, Rc, widen4, NT=4):
    """The kernels' column windows at these slab parameters (a mirror of
    ``axis_window`` in ``csrc/swr_sweep_common.cuh``, in fp32, over every
    (chunk, slab, 64-column tile); ``widen4``: the backward's widening to
    whole float4s): the widest window and the tiles wider than the row
    buffer (``ROW_COLS``, which then read tap by tap)."""
    import numpy as np

    f32 = np.float32
    rs = np.asarray(rs, np.float32)
    j0 = np.arange(0, nq, 64)
    j1 = np.minimum(j0 + 64, nq) - 1
    with np.errstate(invalid="ignore", over="ignore"):
        pa = rs[..., 2:3] + f32(j0) * rs[..., 3:4]
        pz = rs[..., 2:3] + f32(j1) * rs[..., 3:4]
        finite = np.isfinite(pa) & np.isfinite(pz)
        p_lo = np.clip(np.fmin(pa, pz), -8, Rc + 8)
        p_hi = np.clip(np.fmax(pa, pz), -8, Rc + 8)
        lo = np.floor(p_lo) - (NT // 2 - 1)
        hi = np.floor(p_hi) + NT // 2
    empty = (hi < 0) | (lo >= Rc)
    c0 = np.maximum(lo - 1, 0)
    end = np.minimum(hi + 1, Rc - 1) + 1
    if widen4:
        end = np.minimum((end + 3) // 4 * 4, Rc)
        c0 = c0 // 4 * 4
    ncol = np.where(empty | ~finite, 0, end - c0)
    return int(ncol.max()), int(ncol.size), int(((ncol > ROW_COLS)
                                                 | ~finite).sum())


def phase_bf16_train(torch, seed, train, card):
    """The R=512 record's recipe (bf16 bake, bf16 Adam moment, cubic) on
    the lego views, the coarse-to-fine phases cut to BF16_PROG so that
    full-depth steps run: both kernels launched with a bf16 volume at every
    step, losses finite, one full-depth step's level gradients through the
    kernels against the plain sweep's; the steady step median, the peak
    device memory over the steps and, for comparison, one fp32-bake step's
    peak.  Returns a dict of the numbers."""
    import dataclasses

    import numpy as np

    from taichi_nerfs_torch.ops.swr_sweep import chunk_sweep, chunk_sweep_bwd
    from taichi_nerfs_torch.render import swr as rswr
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig, SwrTrainer

    device = torch.device("cuda")
    mcfg = r512_config()
    tcfg = SwrTrainConfig(
        crop=256, lr=1e-2, max_steps=BF16_STEPS, n_chunks=16,
        resample_kind="cubic", alpha_w=0.2, random_bg=True, tv_w=5e-4,
        sigma_l1=1e-5, prog_steps=BF16_PROG, bake_dtype="bfloat16",
        adam_mu_bf16=True,
    )
    trainer = SwrTrainer(mcfg, tcfg, train.rays, train.poses, train.K,
                         train.img_wh, seed=seed, alphas=train.alphas,
                         device=device)
    # record each sweep call's volume dtype and slab parameters
    real_sweep, seen = rswr.chunk_sweep, []

    def recording(vol, rs, *rest, **kw):
        seen.append((vol.dtype, kw.get("dtype"), rs.detach().cpu().numpy(),
                     vol.shape[-1], rest[2]))
        return real_sweep(vol, rs, *rest, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk_sweep.launches = 0
    chunk_sweep_bwd.launches = 0
    chunk_sweep_bwd.finish_launches = 0
    rswr.chunk_sweep = recording
    losses, step_ms, levels, fwd_n, bwd_n = [], [], [], [], []
    try:
        for _ in range(BF16_STEPS):
            f0, b0 = chunk_sweep.launches, chunk_sweep_bwd.launches
            t0 = time.perf_counter()
            m = trainer.run_step()
            loss = float(m["loss"])  # waits for the step
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            levels.append(len(trainer.state.params["levels"]))
            fwd_n.append(chunk_sweep.launches - f0)
            bwd_n.append(chunk_sweep_bwd.launches - b0)
            print(f"bf16 train step {trainer.step - 1}: {levels[-1]} levels "
                  f"(R={trainer.cur_mcfg.grid_res}, lattice "
                  f"{trainer.lat_size or tcfg.crop + 16}) loss={loss:.6f} "
                  f"{step_ms[-1]:.2f} ms; launches forward {fwd_n[-1]}, "
                  f"backward {bwd_n[-1]}", flush=True)
    finally:
        rswr.chunk_sweep = real_sweep
    peak = torch.cuda.max_memory_allocated()
    launches = (chunk_sweep.launches, chunk_sweep_bwd.launches)
    finish = chunk_sweep_bwd.finish_launches
    vol_dtypes = {str(d) for d, _, _, _, _ in seen}
    op_dtypes = {str(o) for _, o, _, _, _ in seen}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bf16 train: non-finite loss: {losses}")
    if set(levels) != {3, 4, 5}:
        raise AssertionError(f"bf16 train: levels {levels}")
    if min(fwd_n) < 1 or min(bwd_n) < 1:
        raise AssertionError(f"bf16 train: a step launched no kernel: "
                             f"forward {fwd_n}, backward {bwd_n}")
    if finish != launches[1]:
        raise AssertionError(f"bf16 train: {finish} launches of "
                             "swr_sweep_bwd_rows_kernel for "
                             f"{launches[1]} backward launches")
    if vol_dtypes != {"torch.bfloat16"} or len(seen) != BF16_STEPS:
        raise AssertionError(f"bf16 train: sweep volumes {vol_dtypes} over "
                             f"{len(seen)} calls")
    # the column windows of the full-depth steps' slabs
    full = [(rs, Rc, nq) for _, _, rs, Rc, nq in seen if Rc == 512]
    paths = [(*_window_paths(rs, nq, Rc, False),
              *_window_paths(rs, nq, Rc, True)) for rs, Rc, nq in full]
    widest_f = max(p[0] for p in paths)
    widest_b = max(p[3] for p in paths)
    tiles = sum(p[1] for p in paths)
    taps_f = sum(p[2] for p in paths)
    taps_b = sum(p[5] for p in paths)
    steps = np.array([np.abs(rs[..., 1::2]) for rs, _, _ in full])
    print(f"bf16 train: R=512 slabs' |step| {steps.min():.3f} to "
          f"{steps.max():.3f} voxels; widest column window forward "
          f"{widest_f}, backward {widest_b} columns (row buffer "
          f"{ROW_COLS}); tiles on the tap-by-tap path: forward {taps_f}, "
          f"backward {taps_b} of {tiles}", flush=True)
    full_idx = [k for k, lv in enumerate(levels) if lv == 5]
    steady = [step_ms[k] for k in full_idx[1:]]
    if len(steady) < 3:
        raise AssertionError(f"bf16 train: {len(steady)} steady full-depth "
                             "steps")
    worst = _grads_kernel_vs_plain(torch, trainer, "bf16 train",
                                   BF16_GRAD_TOL)
    del trainer
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # one full-depth step of the fp32-bake configuration, for its peak
    tcfg32 = dataclasses.replace(tcfg, bake_dtype="float32",
                                 adam_mu_bf16=False, prog_steps=())
    tr32 = SwrTrainer(mcfg, tcfg32, train.rays, train.poses, train.K,
                      train.img_wh, seed=seed, alphas=train.alphas,
                      device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss32 = float(tr32.run_step()["loss"])
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    peak32 = torch.cuda.max_memory_allocated()
    del tr32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if not np.isfinite(loss32):
        raise AssertionError(f"fp32-bake R=512 step: loss {loss32}")
    out = {"step_ms": _median(steady), "steady": steady,
           "peak_gib": peak / 2**30, "peak32_gib": peak32 / 2**30,
           "step32_ms": ms32, "launches": launches,
           "finish_launches": finish, "grad": worst,
           "widest": (widest_f, widest_b), "tap_tiles": (taps_f, taps_b),
           "tiles": tiles, "op_dtypes": sorted(op_dtypes)}
    print(f"bf16 train ({card}): R=512 record recipe, crop 256, cubic, bf16 "
          f"bake and Adam moment: steady full-depth step median "
          f"{out['step_ms']:.3f} ms (steps {[round(x, 3) for x in steady]}),"
          f" peak device memory over the {BF16_STEPS} steps "
          f"{out['peak_gib']:.3f} GiB; one fp32-bake full-depth step "
          f"{ms32:.2f} ms (first of its trainer), peak {out['peak32_gib']:.3f}"
          f" GiB; launches forward {launches[0]}, backward {launches[1]}, "
          f"each with a bf16 volume (and {finish} of the backward's rows "
          f"kernel); level "
          f"gradients within {worst:.3e}",
          flush=True)
    return out


def phase_bf16_serve(torch, seed, card):
    """``PyramidRenderer(bake_dtype="bfloat16")`` at R=512: one capped and
    one uncapped 800x800 frame, finite, opacity in [0, 1], rgb within
    BF16_RGB_TOL of the fp32-bake frame; the frame times and the forward
    kernel's launches.  One chunk's sweep inputs of each frame, of each
    bake, are recorded, and the forward kernel is held against the plain
    sweep on them, with fp32 and with bf16 operands (BF16_FWD_TOL)."""
    from taichi_nerfs_torch.data.cameras import intrinsics, orbit_poses
    from taichi_nerfs_torch.ops.swr_sweep import (
        chunk_sweep,
        chunk_sweep_reference,
    )
    from taichi_nerfs_torch.render import swr as rswr
    from taichi_nerfs_torch.render.serve import PyramidRenderer

    device = torch.device("cuda")
    cfg = r512_config()
    params = _record_params(torch, cfg, seed, device)
    w, h = RECORD_WH
    K = intrinsics(w, h)
    pose = orbit_poses(4)[1]
    res = {}
    frames = {}
    chunks = {}
    real_sweep = rswr.chunk_sweep
    for bake in ("float32", "bfloat16"):
        rend = PyramidRenderer(params, cfg, K, (w, h), resample_kind="cubic",
                               bake_dtype=bake)
        t0 = time.perf_counter()
        grid = rend.grid
        torch.cuda.synchronize()
        bake_ms = (time.perf_counter() - t0) * 1e3
        if grid.dtype != getattr(torch, bake):
            raise AssertionError(f"bake {bake}: grid {grid.dtype}")
        for name, cap in (("capped", "auto"), ("uncapped", None)):
            rend.render(pose, lat_cap=cap)  # warm-up
            torch.cuda.synchronize()
            chunk_sweep.launches = 0
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = rend.render(pose, lat_cap=cap)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            launches = chunk_sweep.launches
            rgb, op = out["rgb"], out["opacity"]
            if not bool(torch.isfinite(rgb).all() and torch.isfinite(
                    op).all()):
                raise AssertionError(f"bf16 serve {bake} {name}: not finite")
            lo, hi = float(op.min()), float(op.max())
            if lo < -1e-6 or hi > 1.0 + 1e-6:
                raise AssertionError(f"bf16 serve {bake} {name}: opacity in "
                                     f"[{lo}, {hi}]")
            if launches <= 0:
                raise AssertionError(f"bf16 serve {bake} {name}: no kernel "
                                     "launch")
            frames[(bake, name)] = rgb
            res[(bake, name)] = {"ms": _median(times), "launches": launches}
            # one more frame with the sweep's inputs recorded; the middle
            # chunk it swept is kept
            calls = []

            def recording(*a, **kw):
                calls.append(a)
                return real_sweep(*a, **kw)

            rswr.chunk_sweep = recording
            try:
                rend.render(pose, lat_cap=cap)
            finally:
                rswr.chunk_sweep = real_sweep
            chunks[(bake, name)] = tuple(
                x.clone() if torch.is_tensor(x) else x
                for x in calls[len(calls) // 2])
            del calls
            print(f"bf16 serve R=512 {bake} bake {name} 800x800: "
                  f"{_median(times):.3f} ms/frame (median of 3), forward "
                  f"launches {launches} in 3 frames, opacity in "
                  f"[{lo:.4f}, {hi:.4f}]; bake {bake_ms:.1f} ms", flush=True)
        del rend, grid
        torch.cuda.empty_cache()
    worst = 0.0
    for name in ("capped", "uncapped"):
        d = float((frames[("bfloat16", name)]
                   - frames[("float32", name)]).abs().max())
        worst = max(worst, d)
        print(f"bf16 serve {name}: rgb bf16 bake vs fp32 bake max_abs="
              f"{d:.3e} (limit {BF16_RGB_TOL})", flush=True)
        if not d <= BF16_RGB_TOL:
            raise AssertionError(f"bf16 serve {name}: rgb differs by {d} > "
                                 f"{BF16_RGB_TOL}")
    # the forward kernel against the plain sweep on the recorded chunks
    kernel_err = {}
    for (bake, name), (vol, rs, z_rel, ch, nq, kind) in chunks.items():
        for odt in ("float32", "bfloat16"):
            dt = getattr(torch, odt)
            got = chunk_sweep(vol, rs, z_rel, ch, nq, kind, dtype=dt)
            want = chunk_sweep_reference(vol, rs, z_rel, ch, nq, kind,
                                         dtype=dt)
            err = float((got - want).abs().max())
            frel = _rel_norm(got, want)
            bf = odt == "bfloat16"
            tol = BF16_SMALL_FWD_TOL if bf else KERNEL_TOL
            ok = (err <= tol and (not bf or frel <= BF16_FWD_REL_TOL)
                  and bool(torch.isfinite(got).all()))
            label = f"{bake} bake {name} {tuple(vol.shape)} nq={nq}"
            kernel_err[f"{label} ops={odt}"] = err
            print(f"bf16 serve kernel {label} {kind} ops={odt}: forward "
                  f"max_abs={err:.3e} (limit {tol}), relative norm "
                  f"{frel:.3e} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(
                    f"swr_sweep_fwd disagrees with the plain sweep on a "
                    f"served chunk ({label}, ops {odt}): {err:.3e} > {tol} "
                    f"or relative norm {frel:.3e} > {BF16_FWD_REL_TOL}")
            del got, want
    del chunks
    print(f"bf16 serve ({card}): R=512 800x800 frames, bf16 bake: capped "
          f"{res[('bfloat16', 'capped')]['ms']:.3f} ms, uncapped "
          f"{res[('bfloat16', 'uncapped')]['ms']:.3f} ms (fp32 bake "
          f"{res[('float32', 'capped')]['ms']:.3f} / "
          f"{res[('float32', 'uncapped')]['ms']:.3f} ms)", flush=True)
    return {"ms": {f"{b} {n}": r["ms"] for (b, n), r in res.items()},
            "launches": sum(r["launches"] for (b, _), r in res.items()
                            if b == "bfloat16"),
            "rgb_max_abs": worst, "kernel_max_abs": kernel_err}


# ---------------------------------------------------------------- inside

# the inside phase: the shell scene's inside views and outside views of
# the same density (GT made on the card), the record widths trained
# through 2 + 2 + 4 steps with camera carving, and frames at 800x800
INSIDE_WH, INSIDE_VIEWS, OUTSIDE_VIEWS = (256, 256), 8, 4
INSIDE_PROG, INSIDE_STEPS = (2, 2), 8
# full-depth inside steps timed after the recipe's (each on the first
# inside view, the face that owns most of its crop)
INSIDE_TIMED = 3
INSIDE_CARVE, INSIDE_NEAR = 0.1, 0.05
# the served inside frame against the trainer's render of it
INSIDE_FRAME_TOL = 1e-5


def _mixed_rig():
    """The shell's inside views (its own rig) and ``OUTSIDE_VIEWS`` orbit
    views of the same density from outside the cube, GT rendered on the
    card: ``(rays, poses, alphas, K)``, inside views first."""
    import numpy as np

    from taichi_nerfs_torch.data.cameras import orbit_poses
    from taichi_nerfs_torch.data.synthetic import (
        SyntheticSphereDataset,
        render_gt_image,
    )

    inside = SyntheticSphereDataset(
        f"synthetic://shell?views={INSIDE_VIEWS}&res={INSIDE_WH[0]}",
        device="cuda")
    out = orbit_poses(OUTSIDE_VIEWS, radius=1.2, elevation=0.4)
    gts = [render_gt_image(p, inside.K, *INSIDE_WH, variant="shell",
                           want_alpha=True, device="cuda") for p in out]
    return (np.concatenate([inside.rays, np.stack([g[0] for g in gts])]),
            np.concatenate([inside.poses, out]),
            np.concatenate([inside.alphas, np.stack([g[1] for g in gts])]),
            inside.K)


def _inside_draw(trainer, draw):
    """``draw`` moved to the first inside view (its crop, background and
    TV windows kept), on the face that owns most of the crop."""
    import numpy as np

    i = trainer._inside.index(True)
    face = int(np.argmax(trainer.face_shares(i, draw.crop_xy)))
    return draw._replace(i=i, face=face)


def phase_inside(torch, seed, card):
    """A mixed rig of inside and outside cameras on the shell scene, the
    record widths, ``cam_carve`` and ``near``: the steps (no sweep kernel
    on inside steps, both on outside ones), an 800x800 inside frame
    through ``PyramidRenderer`` and ``SwrTrainer.render``, one profiled
    inside step, one ``debug_frames`` frame, and one small inside loss and
    its gradients on the card against the CPU.  Returns a dict of the
    numbers."""
    import numpy as np

    from taichi_nerfs_torch.ops.swr_sweep import chunk_sweep, chunk_sweep_bwd
    from taichi_nerfs_torch.render.serve import PyramidRenderer, record_config
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig, SwrTrainer

    t_phase = time.perf_counter()
    rays, poses, alphas, K = _mixed_rig()
    made = time.perf_counter() - t_phase
    mcfg = record_config()
    tcfg = SwrTrainConfig(
        crop=256, lr=1e-2, max_steps=INSIDE_STEPS, n_chunks=16,
        resample_kind="cubic", alpha_w=0.2, random_bg=True, tv_w=5e-4,
        sigma_l1=1e-5, prog_steps=INSIDE_PROG, cam_carve=INSIDE_CARVE,
        near=INSIDE_NEAR)
    trainer = SwrTrainer(mcfg, tcfg, rays, poses, K, INSIDE_WH, seed=seed,
                         alphas=alphas, device="cuda")
    n_in = sum(trainer._inside)
    print(f"inside: {n_in} inside + {len(poses) - n_in} outside shell views "
          f"at {INSIDE_WH} made in {made:.2f} s", flush=True)
    keep = trainer.sigma_keep
    carved = int((keep == 0).sum())
    print(f"inside: cam_carve {INSIDE_CARVE} zeroes {carved} of "
          f"{keep.numel()} sigma voxels at R={trainer.cur_mcfg.grid_res}",
          flush=True)
    if carved <= 0:
        raise AssertionError("inside: cam_carve carved nothing")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for k in range(INSIDE_STEPS + INSIDE_TIMED):
        trainer._advance_phases()
        draw = trainer.draw()
        if k >= INSIDE_STEPS:
            draw = _inside_draw(trainer, draw)
        plan = trainer.plan(draw)
        before = (chunk_sweep.launches, chunk_sweep_bwd.launches)
        t0 = time.perf_counter()
        m = trainer.run_step(draw)
        loss = float(m["loss"])  # waits for the step
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = (chunk_sweep.launches - before[0],
             chunk_sweep_bwd.launches - before[1])
        steps.append(dict(inside=plan.inside, ms=ms, loss=loss, launches=n,
                          R=trainer.cur_mcfg.grid_res, k=k))
        print(f"inside step {trainer.step - 1}: "
              f"{'inside face ' + str(draw.face) if plan.inside else 'outside'}"
              f" (view {draw.i}, R={trainer.cur_mcfg.grid_res}, warp "
              f"{plan.warp}) loss={loss:.6f} {ms:.2f} ms, sweep launches "
              f"{n}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    losses = [st["loss"] for st in steps]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"inside: non-finite loss: {losses}")
    kinds = {st["inside"] for st in steps}
    if kinds != {True, False}:
        raise AssertionError(f"inside: steps of one kind only: {kinds}")
    in_launch = [st["launches"] for st in steps if st["inside"]]
    out_launch = [st["launches"] for st in steps if not st["inside"]]
    if any(n != (0, 0) for n in in_launch) or any(
            min(n) <= 0 for n in out_launch):
        raise AssertionError(f"inside: sweep launches, inside steps "
                             f"{in_launch}, outside steps {out_launch}")
    # steady full-depth steps: not the first of the phase
    first = sum(INSIDE_PROG)
    full = [st for st in steps if st["R"] == mcfg.grid_res
            and st["k"] != first]
    med = {k: _median([st["ms"] for st in full if st["inside"] == k] or
                      [float("nan")]) for k in (True, False)}

    # one inside step under the profiler
    prof = _profile_step(torch, trainer, "inside",
                         _inside_draw(trainer, trainer.draw()))

    # an inside frame: PyramidRenderer against SwrTrainer.render
    i = trainer._inside.index(True)
    frame_wh = RECORD_WH
    K_f = np.asarray(K, np.float64) * (frame_wh[0] / INSIDE_WH[0])
    K_f[2, 2] = 1.0
    K_f = K_f.astype(np.float32)
    rend = PyramidRenderer(trainer.state.params, trainer.cur_mcfg, K_f,
                           frame_wh, resample_kind="cubic",
                           cam_carve=INSIDE_CARVE,
                           carve_poses=trainer.poses_np, near=INSIDE_NEAR)
    rend.grid
    frames, frame_ms = {}, {}
    for name, fn in (("served", lambda: rend.render(poses[i])),
                     ("trainer", lambda: trainer.render(poses[i], K=K_f,
                                                        img_wh=frame_wh))):
        fn()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames[name] = fn()
        torch.cuda.synchronize()
        frame_ms[name] = (time.perf_counter() - t0) * 1e3
    a, b = frames["served"], frames["trainer"]
    diff = max(float((a[k] - b[k]).abs().max()) for k in a)
    rgb, op = a["rgb"], a["opacity"]
    lo, hi = float(op.min()), float(op.max())
    print(f"inside: {frame_wh[0]}x{frame_wh[1]} inside frame of view {i}: "
          f"served {frame_ms['served']:.2f} ms, trainer "
          f"{frame_ms['trainer']:.2f} ms, max_abs difference {diff:.3e} "
          f"(must be <= {INSIDE_FRAME_TOL}); opacity in [{lo:.4f}, "
          f"{hi:.4f}] ({card})", flush=True)
    if not diff <= INSIDE_FRAME_TOL:
        raise AssertionError(f"inside: served and trainer frames differ by "
                             f"{diff}")
    if tuple(rgb.shape) != (frame_wh[0] * frame_wh[1], 3) or not bool(
            torch.isfinite(rgb).all() and torch.isfinite(op).all()):
        raise AssertionError("inside: the frame is not finite")
    if lo < -1e-6 or hi > 1.0 + 1e-6:
        raise AssertionError(f"inside: opacity [{lo}, {hi}]")
    faces = _face_merge(torch, rend, poses[i], K_f, frame_wh, a, card)
    # the frames' render baked and carved the grid
    dbg = _debug_frames(torch, trainer, trainer._grid_cache[1], poses, K,
                        INSIDE_WH)
    cpu = _inside_card_vs_cpu(torch, seed, card)
    secs = time.perf_counter() - t_phase
    print(f"inside ({card}): full-depth steps (R={mcfg.grid_res}) median "
          f"inside {med[True]:.3f} ms, outside {med[False]:.3f} ms; peak "
          f"device memory {peak / 2**30:.3f} GiB; profiled inside step "
          f"{prof['launches']} launches, the card busy "
          f"{100.0 * prof['busy']:.1f}%; {frame_wh[0]}x{frame_wh[1]} inside "
          f"frame {frame_ms['served']:.2f} ms over {faces} faces; "
          f"phase {secs:.1f} s", flush=True)
    return {"step_ms_inside": med[True], "step_ms_outside": med[False],
            "peak_gib": peak / 2**30, "frame_ms": frame_ms["served"],
            "faces": faces, "launches_outside": tuple(
                map(sum, zip(*out_launch))), "secs": secs, "debug": dbg,
            "card_vs_cpu": cpu, **prof}


def _face_merge(torch, rend, pose, K, wh, frame, card):
    """Each cubemap face of the served inside ``frame`` rendered alone by
    ``render_swr_fixed_axis(inside=True)``, with the slope bounds (its own
    pixels', padded by 0.02), solve and lattice that ``render_swr_inside``
    gives it: the merged frame must equal it on that face's pixels.
    Returns the number of faces."""
    import numpy as np

    from taichi_nerfs_torch.render.swr import (
        _matmul_solve_choice,
        pixel_faces,
        render_swr_fixed_axis,
    )

    cfg, pad = rend.cfg, 0.02
    lat_cap = int(1.25 * cfg.grid_res) + 16  # PyramidRenderer's "auto"
    lat = {"lat_size": lat_cap} if max(wh) + 16 > lat_cap else {}
    dom, pos, faces, dir_w = pixel_faces(pose, K, wh)
    worst = {}
    for a, p in faces:
        b_ax, c_ax = [d for d in range(3) if d != a]
        m = (dom == a) & (pos == p)
        sb = dir_w[..., b_ax][m] / dir_w[..., a][m]
        sc = dir_w[..., c_ax][m] / dir_w[..., a][m]
        lo, hi = float(sc.min()) - pad, float(sc.max()) + pad
        bounds = np.asarray([[sb.min() - pad, sb.max() + pad], [lo, hi]],
                            np.float32)
        with torch.no_grad():
            r = render_swr_fixed_axis(
                rend.params, rend.grid, cfg, pose, K, wh, a, not p,
                inside=True, slope_bounds=bounds,
                warp=_matmul_solve_choice(pose, a, lo, hi),
                n_chunks=min(16, cfg.grid_res), white_bg=True,
                skip_empty=True, near=rend.near, resample_kind=rend.resample_kind,
                resample_dtype=rend.resample_dtype,
                sweep_impl=rend.sweep_impl, **lat)
        mask = torch.as_tensor(m.reshape(-1), device=r["rgb"].device)
        worst[(a, p)] = max(float((frame[k][mask] - r[k][mask]).abs().max())
                            for k in frame)
    print(f"inside: each face rendered alone against the merged frame on "
          f"its pixels, max_abs {worst} (must be <= {INSIDE_FRAME_TOL}) "
          f"({card})", flush=True)
    if not max(worst.values()) <= INSIDE_FRAME_TOL:
        raise AssertionError(f"inside: the merged frame differs from its "
                             f"faces: {worst}")
    return len(faces)


def _debug_frames(torch, trainer, grid, poses, K, wh):
    """One ``debug_frames`` render of an outside view (the slab scan) of
    ``grid``: its keys and shapes."""
    from taichi_nerfs_torch.render.swr import render_swr

    i = trainer._inside.index(False)
    mcfg = trainer.cur_mcfg
    nq = wh[0] + 16
    with torch.no_grad():
        out = render_swr(trainer.state.params, grid, mcfg, poses[i], K, wh,
                         n_chunks=16, debug_frames=True,
                         resample_kind="cubic")
    want = {"rgb": (wh[0] * wh[1], 3), "depth": (wh[0] * wh[1],),
            "opacity": (wh[0] * wh[1],),
            "global_frame": (nq, nq, mcfg.features + 1)}
    got = {k: tuple(v.shape) for k, v in out.items() if k != "chunk_debug"}
    dbg = [tuple(x.shape) for x in out["chunk_debug"]]
    want_dbg = [(16, nq, nq, mcfg.features - 1), (16, nq, nq),
                (16, mcfg.features + 1, nq, nq)]
    print(f"inside: debug_frames of view {i}: {got}, chunk_debug {dbg}",
          flush=True)
    if got != want or dbg != want_dbg or not all(
            bool(torch.isfinite(x).all()) for x in out["chunk_debug"]):
        raise AssertionError(f"inside: debug_frames gave {got}, {dbg}")
    return got


def _inside_card_vs_cpu(torch, seed, card):
    """One small inside loss (cam_carve, near, random background, opacity
    and distortion terms) and its gradients on the card and on the CPU
    from the same params and inputs, against the CPU tests' tolerances."""
    import numpy as np

    from taichi_nerfs_torch.data.cameras import look_at
    from taichi_nerfs_torch.models.pyramid import (
        PyramidConfig,
        init_pyramid_params,
    )
    from taichi_nerfs_torch.render.swr import face_slope_bounds, pixel_faces
    from taichi_nerfs_torch.train.swr_step import (
        SwrTrainConfig,
        _trainable,
        camera_keep_mask,
        make_swr_loss,
        tree_leaves,
        tree_map,
    )

    mcfg = PyramidConfig((16, 32), features=4, rgb_width=16,
                         sigma_bias=-1.0, deferred=True)
    tcfg = SwrTrainConfig(crop=24, n_chunks=4, tv_w=5e-3, sigma_l1=1e-3,
                          distortion_w=1e-2, random_bg=True, alpha_w=0.2,
                          near=0.08, cam_carve=0.12)
    params = init_pyramid_params(mcfg, torch.Generator().manual_seed(seed))
    R = mcfg.grid_res
    c = (torch.arange(R, dtype=torch.float32) + 0.5) / R - 0.5
    xx, yy, zz = torch.meshgrid(c, c, c, indexing="ij")
    r = torch.sqrt(xx**2 + yy**2 + zz**2)
    params["levels"][-1][..., 0] += 3.0 * torch.exp(-((r - 0.35) / 0.08)**2)
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (40, 40, 4), dtype=np.uint8)
    bg = torch.as_tensor(rng.uniform(size=(24 * 24, 3)).astype(np.float32))
    pose = look_at(np.array([0.3, 0.25, 0.2]), np.array([-0.4, -0.4, -0.3]),
                   np.array([0.0, 0.0, 1.0]))
    K = np.array([[28.0, 0, 20], [0, 28.0, 20], [0, 0, 1]], np.float32)
    keep = torch.as_tensor(camera_keep_mask(pose[None], R, tcfg.cam_carve))
    dom, pos, faces, _ = pixel_faces(pose, K, (40, 40))
    worst = 0.0
    for a, p in faces:
        sb = face_slope_bounds(pose, K, (24, 24), a, 1.0 if p else -1.0,
                               crop_xy=(7, 11))
        res = []
        for dev in ("cuda", "cpu"):
            prm = _trainable(tree_map(lambda t, d=dev: t.to(d), params))
            loss, _ = make_swr_loss(
                torch.as_tensor(img, device=dev), pose, K, (7, 11), mcfg,
                tcfg, a, not p, bg.to(dev), (2,), 0, "gather", 0, True,
                keep.to(dev), sb)(prm)
            grads = torch.autograd.grad(loss, tree_leaves(prm))
            res.append((float(loss.detach()), [g.cpu() for g in grads]))
        (lc, gc), (lh, gh) = res
        d_loss = abs(lc - lh) / abs(lh)
        d_grad = max(float(torch.linalg.norm(x - y)
                           / max(float(torch.linalg.norm(y)), 1e-30))
                     for x, y in zip(gc, gh))
        print(f"inside card vs CPU, face ({a}, {p}): loss {lc:.8f} / "
              f"{lh:.8f} (relative {d_loss:.3e}, must be <= "
              f"{SCAN_LOSS_TOL}), worst gradient relative norm {d_grad:.3e} "
              f"(must be <= {SCAN_GRAD_TOL}) ({card})", flush=True)
        if not (d_loss <= SCAN_LOSS_TOL and d_grad <= SCAN_GRAD_TOL):
            raise AssertionError("inside: the card and the CPU disagree")
        worst = max(worst, d_grad)
    return worst


# ----------------------------------------------------------------- files

FILES_VIEWS, FILES_TEST_VIEWS = 8, 4
FILES_PROG, FILES_STEPS, FILES_NGP_STEPS = (2, 2), 8, 32
FILES_LEVELS = (32, 64, 128, 256)


def phase_files(torch, seed, card):
    """The Blender file format end to end: lego-proxy views written with
    ``export_blender_dataset`` into a temporary directory, loaded back
    (seconds per view), and ``python -m taichi_nerfs_torch.train
    --dataset_name nerf`` run on them for the pyramid (the record recipe
    without opacity supervision, which files cannot give: both kernels must
    launch, the eval must be finite) and for NGP (the last loss and the
    eval finite).  Returns a dict of the numbers."""
    import tempfile

    import numpy as np

    from taichi_nerfs_torch.data import dataset_dict
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.data.transforms_export import (
        export_blender_dataset,
    )
    from taichi_nerfs_torch.ops.swr_sweep import chunk_sweep, chunk_sweep_bwd
    from taichi_nerfs_torch.train import __main__ as entry

    t_phase = time.perf_counter()
    wh = RECORD_WH
    kw = dict(variant="lego", img_wh=wh, cam_radius=1.5, device="cuda")
    t0 = time.perf_counter()
    views = {"train": SyntheticSphereDataset(n_images=FILES_VIEWS, **kw),
             "test": SyntheticSphereDataset(split="test",
                                            n_images=FILES_TEST_VIEWS, **kw)}
    made = time.perf_counter() - t0
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "lego_blender")
        t0 = time.perf_counter()
        export_blender_dataset(root, views)
        wrote = time.perf_counter() - t0
        n = FILES_VIEWS + FILES_TEST_VIEWS
        t0 = time.perf_counter()
        loaded = [dataset_dict["nerf"](root, split=sp, downsample=1.0)
                  for sp in ("train", "test")]
        load_s = time.perf_counter() - t0
        for got, sp in zip(loaded, ("train", "test")):
            src = views[sp]
            dp = float(np.abs(got.poses - src.poses).max())
            di = float(np.abs(got.rays - src.rays).max())
            if dp > 1e-5 or di > 0.5 / 255 + 1e-6:
                raise AssertionError(f"files: {sp} loaded back off by poses "
                                     f"{dp}, pixels {di}")
        print(f"files: {n} lego views at {wh} made in {made:.2f} s, written "
              f"in {wrote:.2f} s, loaded in {load_s:.3f} s "
              f"({1e3 * load_s / n:.2f} ms a view) ({card})", flush=True)
        common = ["--root_dir", root, "--dataset_name", "nerf",
                  "--downsample", "1"]
        pyr_argv = common + [
            "--model_name", "pyramid", "--exp_name", "files_pyramid",
            "--pyramid_levels", ",".join(map(str, FILES_LEVELS)),
            "--features", "8", "--level_features",
            ",".join("8" * len(FILES_LEVELS)),
            "--bake_dtype", "float32", "--lr", "1e-2", "--random_bg",
            "--tv_w", "5e-4", "--sigma_l1", "1e-5", "--resample_kind",
            "cubic", "--prog_steps", ",".join(map(str, FILES_PROG)),
            "--max_steps", str(FILES_STEPS)]
        os.chdir(tmp)
        try:
            chunk_sweep.launches = 0
            chunk_sweep_bwd.launches = 0
            t0 = time.perf_counter()
            manifest = entry.main(pyr_argv)
            pyr_s = time.perf_counter() - t0
            launches = (chunk_sweep.launches, chunk_sweep_bwd.launches)
            t0 = time.perf_counter()
            ngp = entry.main(common + [
                "--model_name", "ngp", "--exp_name", "files_ngp",
                "--max_steps", str(FILES_NGP_STEPS), "--eval_views", "2"])
            ngp_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    print(f"files: pyramid through the train entry in {pyr_s:.1f} s: eval "
          f"psnr {manifest['eval_psnr']} over {manifest['views_finite']} "
          f"finite views of {FILES_TEST_VIEWS}; sweep launches {launches}; "
          f"ngp {ngp['steps']} steps in {ngp_s:.1f} s, last loss "
          f"{ngp['last_loss']:.5f}, eval psnr "
          f"{[round(x, 3) for x in ngp['psnr']]} ({card})", flush=True)
    if manifest["views_finite"] != FILES_TEST_VIEWS:
        raise AssertionError(f"files: eval {manifest['per_view_psnr']}")
    if min(launches) <= 0:
        raise AssertionError(f"files: a sweep kernel never launched: "
                             f"{launches}")
    # fit runs max_steps + 1 steps, as the JAX loop does; a non-finite
    # loss on any of them leaves the last one non-finite
    if ngp["steps"] != FILES_NGP_STEPS + 1 or not np.isfinite(
            ngp["last_loss"]) or not all(np.isfinite(ngp["psnr"])):
        raise AssertionError(f"files: ngp {ngp['steps']} steps, last loss "
                             f"{ngp['last_loss']}, psnr {ngp['psnr']}")
    secs = time.perf_counter() - t_phase
    print(f"files: phase {secs:.1f} s", flush=True)
    return {"load_ms_per_view": 1e3 * load_s / n, "launches": launches,
            "secs": secs, "eval_psnr": manifest["eval_psnr"]}


def _occupied_share(torch, bitfield):
    words = bitfield.long() & 0xFFFFFFFF
    bits = (words[:, None] >> torch.arange(32, device=words.device)) & 1
    return float(bits.sum()) / (32 * bitfield.numel())


def _ngp_card_vs_cpu(torch, tag, trainer, seed):
    """One ``render_train`` of ``NGP_CHECK_RAYS`` rays on the card and on
    the CPU from the trainer's params and bitfield and identical draws:
    equal sample counts on >= ``NGP_COUNT_SHARE`` of the rays, rgb within
    ``NGP_RGB_TOL`` on them."""
    from taichi_nerfs_torch.ops.rays import get_rays
    from taichi_nerfs_torch.render.renderer import render_train
    from taichi_nerfs_torch.train.state import tree_map
    from taichi_nerfs_torch.train.step import draw_step, sample_batch

    device, cfg = trainer.device, trainer.cfg
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
            print(f"{tag}: render_train of {NGP_CHECK_RAYS} rays on "
                  f"{dev.type} in {(time.perf_counter() - t0) * 1e3:.1f} ms",
                  flush=True)
    a, b = outs
    same = (a["counts"].cpu() == b["counts"]).numpy()
    d_rgb = (a["rgb"].cpu() - b["rgb"]).abs().max(dim=1).values.numpy()
    worst = float(d_rgb[same].max())
    print(f"{tag}: card vs CPU render_train: equal counts on "
          f"{100.0 * same.mean():.3f}% of rays (must be >= "
          f"{100 * NGP_COUNT_SHARE}%), rgb max_abs {worst:.3e} on them "
          f"(must be <= {NGP_RGB_TOL}), {float(d_rgb.max()):.3e} on all; "
          f"samples {int(a['rm_samples'])} / {int(b['rm_samples'])}",
          flush=True)
    if same.mean() < NGP_COUNT_SHARE or not worst <= NGP_RGB_TOL:
        raise AssertionError(f"{tag}: the card and the CPU disagree")
    return worst


def _profile_ngp_steps(torch, tag, trainer):
    """3 steady steps of an NGP-path trainer under ``torch.profiler``, none
    of them a grid refresh (one step in ``update_interval``): the op table,
    the top kernels and the spans by device time a step.  Returns the
    device-busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from taichi_nerfs_torch.render.serve import report_profile

    interval = trainer.cfg.train.update_interval
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
    busy_us = report_profile(prof, wall_us, f"3 steady {tag} steps", True,
                             None)
    kern = sorted(
        (e for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
        key=lambda e: -e.self_device_time_total)
    spans = {e.key: e.device_time_total for e in prof.key_averages()
             if e.key.startswith("ngp.")}
    print(f"{tag}: top kernels by device time per step: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 3e3:.3f} ms"
        for e in kern[:8]), flush=True)
    print(f"{tag}: spans, device time per step: " + "; ".join(
        f"{k} {v / 3e3:.3f} ms" for k, v in sorted(spans.items())),
        flush=True)
    return busy_us / wall_us


def phase_ngp(torch, seed):
    """Train the flagship NGP configuration, cross-check one render with the
    CPU, render an 800x800 test view and profile 3 steady steps."""
    import numpy as np

    from taichi_nerfs_torch.config import config_for_scene
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.ops.rays import get_rays
    from taichi_nerfs_torch.render.renderer import render_image
    from taichi_nerfs_torch.train.loop import Trainer
    from taichi_nerfs_torch.train.metrics import psnr

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
    _ngp_card_vs_cpu(torch, "ngp", trainer, seed)
    params = trainer.state.params
    bitfield = trainer.state.occupancy.bitfield

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

    busy = _profile_ngp_steps(torch, "ngp", trainer)
    return {"warm_ms": warm, "steady_ms": steady, "frame_ms": frame_ms[1],
            "busy": busy, "occupied": occ, "trainer": trainer,
            "test": test}


# the ngp_models phase: the tri-plane encoder at the default TriPlaneConfig
# and the svox grid at opt.py's defaults (--grid_size 256 --sh_degree 2
# --grid_radius 0.0125), each trained NGP_STEPS steps on the ngp phase's views
SVOX_GRID, SVOX_SH_DEGREE, SVOX_RADIUS = 256, 2, 0.0125
# the export phase: steps of the deployment model through the train entry
EXPORT_STEPS = 64
# the viewer phase: headless frames of the NGP model and of the record
# pyramid (through SwrTrainer.render, lattice cap auto)
VIEWER_NGP_FRAMES, VIEWER_PYRAMID_FRAMES = 4, 8


def _ngp_model_configs():
    """``(name, Config)`` of the tri-plane and svox families at full width,
    otherwise the ngp phase's ``config_for_scene(0.5)``."""
    from taichi_nerfs_torch.config import config_for_scene

    tri = config_for_scene(0.5, pos_encoder_type="triplane")
    base = config_for_scene(0.5)
    svox = base.replace(model=base.model.replace(
        name="svox", voxel_grid_size=SVOX_GRID,
        voxel_sh_degree=SVOX_SH_DEGREE, voxel_radius=SVOX_RADIUS))
    return (("triplane", tri), ("svox", svox))


def _frame_checks(torch, tag, out, n_px):
    rgb, op = out["rgb"], out["opacity"]
    if tuple(rgb.shape) != (n_px, 3) or not bool(torch.isfinite(rgb).all()):
        raise AssertionError(f"{tag}: the frame is not finite")
    lo, hi = float(op.min()), float(op.max())
    if lo < -1e-6 or hi > 1.0 + 1e-6:
        raise AssertionError(f"{tag}: opacity in [{lo}, {hi}]")
    return hi


def phase_ngp_models(torch, seed, card):
    """The tri-plane encoder and the svox voxel grid at full width: each
    trains ``NGP_STEPS`` steps with ``Trainer`` on the ngp phase's 8 checker
    views (losses finite, the mean of the last 16 below the first), renders
    an 800x800 test view (finite, opacity in [0, 1]) and runs one
    ``render_train`` on the card and on the CPU.  Returns a dict by
    model."""
    import numpy as np

    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.ops.rays import get_rays
    from taichi_nerfs_torch.render.renderer import render_image
    from taichi_nerfs_torch.train.loop import Trainer
    from taichi_nerfs_torch.train.metrics import psnr
    from taichi_nerfs_torch.train.state import param_count

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    train = SyntheticSphereDataset(n_images=8, img_wh=(256, 256),
                                   variant="checker", device=device)
    test = SyntheticSphereDataset(n_images=1, img_wh=NGP_TEST_WH,
                                  variant="checker", split="test",
                                  device=device)
    rays_o, rays_d = get_rays(
        torch.as_tensor(test.directions, device=device),
        torch.as_tensor(test.poses[0], device=device))
    gt = torch.as_tensor(test.rays[0], device=device)
    res = {}
    for name, cfg in _ngp_model_configs():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(cfg, train.as_batch(device), train.K, train.img_wh,
                          device=device, log_fn=lambda *_: None)
        torch.cuda.synchronize()
        n_par = param_count(trainer.state.params)
        print(f"{name}: trainer in {time.perf_counter() - t0:.2f} s, "
              f"{n_par} params ({4 * n_par / 1e6:.1f} MB fp32), batch "
              f"{cfg.train.batch_size}", flush=True)
        losses, step_ms = [], []
        for i in range(NGP_STEPS):
            t0 = time.perf_counter()
            m = trainer.run_step()
            losses.append(float(m["loss"]))  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i % 64 == 0 or i == NGP_STEPS - 1:
                print(f"{name} step {i}: loss={losses[-1]:.6f} "
                      f"psnr={float(m['psnr']):.3f} S={trainer.sample_cap} "
                      f"pack={trainer.pack_cap} {step_ms[-1]:.2f} ms",
                      flush=True)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: non-finite loss: {losses}")
        last = float(np.mean(losses[-16:]))
        if not last < losses[0]:
            raise AssertionError(f"{name}: the loss did not fall: "
                                 f"{losses[0]} -> {last}")
        warm = _median(step_ms[16:NGP_WARMUP])
        steady = _median(step_ms[NGP_WARMUP:])
        busy = _profile_ngp_steps(torch, name, trainer)
        _ngp_card_vs_cpu(torch, name, trainer, seed)
        t0 = time.perf_counter()
        out = render_image(trainer.state.params, cfg,
                           trainer.state.occupancy.bitfield, rays_o, rays_d)
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3
        hi = _frame_checks(torch, name, out, NGP_TEST_WH[0] * NGP_TEST_WH[1])
        p = float(psnr(out["rgb"], gt))
        print(f"{name} ({card}): loss first {losses[0]:.6f}, mean of the "
              f"last 16 {last:.6f}; median step, warmup (steps "
              f"16-{NGP_WARMUP - 1}) {warm:.3f} ms, after it {steady:.3f} ms"
              f" (device busy {100.0 * busy:.1f}% of 3 profiled steps); peak "
              f"device memory {peak:.3f} GiB; 800x800 test frame "
              f"{frame_ms:.2f} ms, "
              f"{out['rounds']} rounds, max opacity {hi:.4f}, psnr "
              f"{p:.3f} dB after {NGP_STEPS} steps", flush=True)
        res[name] = {"warm_ms": warm, "steady_ms": steady, "peak_gib": peak,
                     "frame_ms": frame_ms, "params": n_par, "busy": busy}
        del trainer, out
    secs = time.perf_counter() - t_phase
    print(f"ngp_models: phase {secs:.1f} s ({card})", flush=True)
    res["secs"] = secs
    return res


def phase_export(torch, seed, card, record):
    """The deployment exports: ``python -m taichi_nerfs_torch.train
    --deployment --encoder_type hash`` trains the deployment model
    ``EXPORT_STEPS`` steps; its ``deployment.npy`` is read back, the params
    rebuilt from it give the trained model's field on the card exactly;
    ``export_native`` of the trained model writes ``.bin`` files equal to
    the dict's arrays; ``export_pyramid_native`` of the record trainer's
    model writes a ``grid.bin`` within fp16 rounding of the bake on the
    card.  Returns a dict of seconds and bytes."""
    import json as _json
    import tempfile

    import numpy as np

    from opt import get_opts
    from taichi_nerfs_torch.config import config_from_opts
    from taichi_nerfs_torch.data.cameras import intrinsics
    from taichi_nerfs_torch.models import ngp
    from taichi_nerfs_torch.models import pyramid as pyr
    from taichi_nerfs_torch.train import __main__ as entry
    from taichi_nerfs_torch.utils.convert import load_ngp_npz
    from taichi_nerfs_torch.utils.export import (
        export_native,
        export_pyramid_native,
        load_tagged_binary,
        params_from_deployment,
    )

    t_phase = time.perf_counter()
    device = torch.device("cuda")

    def _size(d):
        return sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d))

    argv = ["--root_dir", "synthetic://checker?views=8&res=256",
            "--dataset_name", "synthetic", "--deployment", "--encoder_type",
            "hash", "--max_steps", str(EXPORT_STEPS), "--exp_name",
            "export", "--eval_views", "1", "--deployment_model_path", "dep"]
    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            run = entry.main(argv)
            train_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        if run["steps"] != EXPORT_STEPS + 1 or not np.isfinite(
                run["last_loss"]):
            raise AssertionError(f"export: {run['steps']} steps, last loss "
                                 f"{run['last_loss']}")
        cfg = config_from_opts(get_opts(argv))
        dep_path = os.path.join(tmp, "dep", "deployment.npy")
        t0 = time.perf_counter()
        dep = np.load(dep_path, allow_pickle=True).item()
        read_s = time.perf_counter() - t0
        params, occ, _, _ = load_ngp_npz(
            os.path.join(tmp, "results", "export", "model.npz"), device)
        rebuilt = params_from_deployment(dep, cfg.model, device)
        gen = torch.Generator(device).manual_seed(seed + 11)
        x = torch.rand((1 << 16, 3), generator=gen, device=device) - 0.5
        d = torch.randn((1 << 16, 3), generator=gen, device=device)
        with torch.no_grad():
            want = ngp.forward(params, cfg.model, x, d)
            got = ngp.forward(rebuilt, cfg.model, x, d)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("export: the params rebuilt from "
                                 "deployment.npy give another field")
        print(f"export ({card}): the deployment model "
              f"({cfg.model.grid.levels}x{cfg.model.grid.feature_per_level} "
              f"hash, 2^{cfg.model.grid.log2_T} rows, "
              f"{cfg.model.xyz_net_width}-wide MLPs) trained "
              f"{run['steps']} steps through the train entry in "
              f"{train_s:.1f} s (last loss {run['last_loss']:.5f}); "
              f"deployment.npy {os.path.getsize(dep_path)} bytes, read in "
              f"{read_s * 1e3:.1f} ms; the field of the params rebuilt "
              f"from it equals the trained model's on 65536 points",
              flush=True)

        native = os.path.join(tmp, "native")
        t0 = time.perf_counter()
        export_native(params, cfg.model, occ.bitfield, dep["poses"],
                      intrinsics(*RECORD_WH), RECORD_WH, native,
                      render_cfg=cfg.render)
        native_s = time.perf_counter() - t0
        pose = dep["poses"][min(20, len(dep["poses"]) - 1)]
        for name, want_arr in (
                ("hash_embedding", dep["model.hash_encoder.params"]),
                ("sigma_weights", dep["model.xyz_encoder.params"]),
                ("rgb_weights", dep["model.rgb_net.params"]),
                ("density_bitfield",
                 dep["model.density_bitfield"].view(np.uint32)),
                ("pose", pose.reshape(-1))):
            got_arr = load_tagged_binary(os.path.join(native, name + ".bin"))
            if got_arr.dtype != want_arr.dtype or not np.array_equal(
                    got_arr, want_arr):
                raise AssertionError(f"export: {name}.bin differs from the "
                                     "deployment dict")
        with open(os.path.join(native, "config.json")) as f:
            conf = _json.load(f)
        if (conf["levels"], conf["rgb_depth"]) != (
                cfg.model.grid.levels, cfg.model.rgb_net_depth):
            raise AssertionError(f"export: config.json {conf}")
        out["native"] = (native_s, _size(native))
        print(f"export ({card}): export_native in {native_s * 1e3:.1f} ms, "
              f"{out['native'][1]} bytes in {len(os.listdir(native))} files; "
              f"each .bin equals the deployment dict's array", flush=True)

        trainer = record["trainer"]
        mcfg = trainer.cur_mcfg
        pdir = os.path.join(tmp, "pyramid")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_pyramid_native(trainer.state.params, mcfg,
                              record["pose"], trainer.K, RECORD_WH, pdir)
        pyr_s = time.perf_counter() - t0
        grid = torch.as_tensor(
            load_tagged_binary(os.path.join(pdir, "grid.bin")).copy(),
            device=device).float()
        with torch.no_grad():
            bake = pyr.bake(trainer.state.params, mcfg).reshape(-1)
        # round to nearest fp16: within half an ulp, 2^-11 relative for
        # normal values, 2^-25 in the subnormal range
        tol = torch.clamp(bake.abs() * 2.0**-11, min=2.0**-25)
        err = (grid - bake).abs()
        bad = ~((err <= tol) | (torch.isinf(grid) & (bake.abs() >= 65520)))
        ratio = float((err / tol).nan_to_num(0.0).max())
        n_grid = mcfg.grid_res**3 * mcfg.features
        out["pyramid"] = (pyr_s, _size(pdir))
        print(f"export ({card}): export_pyramid_native of the record model "
              f"(R={mcfg.grid_res}, F={mcfg.features}) in {pyr_s:.2f} s, "
              f"{out['pyramid'][1]} bytes (grid.bin "
              f"{os.path.getsize(os.path.join(pdir, 'grid.bin'))}); grid.bin "
              f"against the bake on the card: worst error {ratio:.3f} of "
              f"half an fp16 ulp, {int(bad.sum())} of {n_grid} values "
              f"outside", flush=True)
        if grid.numel() != n_grid or int(bad.sum()):
            raise AssertionError("export: grid.bin is not the bake rounded "
                                 "to fp16")
        del grid, bake, err, tol, bad
    out["secs"] = time.perf_counter() - t_phase
    out["train_s"] = train_s
    print(f"export: phase {out['secs']:.1f} s ({card})", flush=True)
    return out


def phase_viewer(torch, seed, card, ngp, record):
    """The headless viewer (``viewer/gui.py``, no ``cv2`` or display):
    ``VIEWER_NGP_FRAMES`` 800x800 frames of the ngp phase's model through
    ``render_image`` and ``VIEWER_PYRAMID_FRAMES`` of the record model
    through ``SwrTrainer.render`` (``render_fn``, lattice cap auto): every
    frame finite, ``swr_sweep_fwd`` launched during the pyramid frames, the
    last NGP frame equal to ``render_image`` at its pose and the first
    pyramid frame equal to ``SwrTrainer.render`` at its pose.  Returns a
    dict of frame times and launches."""
    import numpy as np

    from taichi_nerfs_torch.ops.rays import get_ray_directions, get_rays
    from taichi_nerfs_torch.ops.swr_sweep import chunk_sweep
    from taichi_nerfs_torch.render.renderer import render_image
    from taichi_nerfs_torch.viewer.gui import NGPGUI

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    res = {}

    def _quantize(rgb, wh):
        w, h = wh
        img = rgb.reshape(h, w, 3).float().cpu().numpy()
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    # the NGP model
    ntr, test = ngp["trainer"], ngp["test"]
    frames, dts = [], []
    gui = NGPGUI(ntr.cfg, ntr.state.params, ntr.state.occupancy.bitfield,
                 test.K, test.img_wh, test.poses,
                 frame_callback=lambda f: (frames.append(f),
                                           dts.append(gui.dt * 1e3)))
    gui.render(max_frames=VIEWER_NGP_FRAMES)
    w, h = test.img_wh
    pose = gui.cam.pose.astype(np.float32)
    rays_o, rays_d = get_rays(get_ray_directions(h, w, test.K, device=device),
                              torch.as_tensor(pose, device=device))
    with torch.no_grad():
        want = render_image(ntr.state.params, ntr.cfg,
                            ntr.state.occupancy.bitfield, rays_o, rays_d)
    _frame_checks(torch, "viewer ngp", want, w * h)
    diff = np.abs(frames[-1].astype(int) - _quantize(want["rgb"], (w, h)))
    print(f"viewer ngp ({card}): {len(frames)} frames at {w}x{h}, ms "
          f"{[round(x, 2) for x in dts]}, median {_median(dts):.2f} (min "
          f"{min(dts):.2f}, max {max(dts):.2f}), samples/ray "
          f"{gui.mean_samples:.2f}; the last frame against render_image at "
          f"its pose: max {int(diff.max())} of 255, equal on "
          f"{100.0 * np.mean(diff == 0):.3f}% of values", flush=True)
    if len(frames) != VIEWER_NGP_FRAMES or diff.max() > 1 or np.mean(
            diff == 0) < 0.999:
        raise AssertionError("viewer: the NGP frames are not render_image's")
    res["ngp"] = {"median_ms": _median(dts), "min_ms": min(dts),
                  "max_ms": max(dts)}

    # the record pyramid, through SwrTrainer.render
    trainer = record["trainer"]
    frames, dts, outs, poses = [], [], [], []

    def render_fn(p, K, wh):
        out = trainer.render(p, K=K, img_wh=wh)
        poses.append(p)
        outs.append(out["rgb"])
        return out

    gui = NGPGUI(None, trainer.state.params, None, trainer.K, RECORD_WH,
                 record["poses"], render_fn=render_fn,
                 frame_callback=lambda f: (frames.append(f),
                                           dts.append(gui.dt * 1e3)))
    torch.cuda.synchronize()
    chunk_sweep.launches = 0
    gui.render(max_frames=VIEWER_PYRAMID_FRAMES)
    torch.cuda.synchronize()
    launches = chunk_sweep.launches
    bad = [i for i, o in enumerate(outs) if not bool(torch.isfinite(o).all())]
    again = trainer.render(poses[0], K=trainer.K, img_wh=RECORD_WH)["rgb"]
    d0 = float((again - outs[0]).abs().max())
    same = np.array_equal(frames[0], _quantize(again, RECORD_WH))
    print(f"viewer pyramid ({card}): {len(frames)} frames at "
          f"{RECORD_WH[0]}x{RECORD_WH[1]} through SwrTrainer.render, ms "
          f"{[round(x, 2) for x in dts]}, median {_median(dts):.2f} (min "
          f"{min(dts):.2f}, max {max(dts):.2f}); swr_sweep_fwd launches "
          f"{launches}; the first frame against SwrTrainer.render at its "
          f"pose: rgb max_abs {d0:.3e}, uint8 frame equal {same}",
          flush=True)
    if bad or len(frames) != VIEWER_PYRAMID_FRAMES:
        raise AssertionError(f"viewer: pyramid frames {bad} not finite")
    if launches <= 0:
        raise AssertionError("viewer: the pyramid frames never launched "
                             "swr_sweep_fwd")
    if not (same and d0 <= 1e-6):
        raise AssertionError("viewer: the first pyramid frame is not "
                             "SwrTrainer.render's")
    res["pyramid"] = {"median_ms": _median(dts), "min_ms": min(dts),
                      "max_ms": max(dts), "launches": launches}
    res["secs"] = time.perf_counter() - t_phase
    print(f"viewer: phase {res['secs']:.1f} s ({card})", flush=True)
    return res


# the parallel phase: NGP steps (refreshes at steps 0 and 2) and full-depth
# pyramid steps a run
PAR_NGP_STEPS, PAR_SWR_STEPS = 4, 2
# one process against the ranks, after the first step (a later step starts
# from params that differ where that step's atomics decided a sign):
# tests/test_sharding.py's tolerances
PAR_LOSS_RTOL, PAR_TOL = 1e-5, 2e-6
# the gradients of both runs are summed with atomics (index_add_ in the NGP
# backward, the sweep backward's d vol), so a gradient within rounding of 0
# takes either sign, and Adam's first step (eps 1e-15) moves that entry by
# up to lr either way: an entry past PAR_TOL must have a first-step
# gradient below PAR_TINY_GRAD in both runs (typical ones are ~1e-5), and
# such entries at most PAR_FLIP_SHARE of all
PAR_TINY_GRAD, PAR_FLIP_SHARE = 1e-8, 1e-5


def _parallel_configs():
    """The flagship NGP configuration with a refresh every 2 steps (the
    warm-up one at step 0, a steady one at step 2) and its MLPs in fp32,
    and the record pyramid at full depth from the first step.

    fp32 MLPs: the flagship's bf16 MLPs round every product to bf16, and a
    shard's matmul has other rows than the one-process one (and the one
    process packs where a shard evaluates dense), which may round it
    otherwise; ``tests/test_sharding.py``'s tolerances presume fp32, as its
    configuration sets."""
    import dataclasses

    from taichi_nerfs_torch.config import config_for_scene
    from taichi_nerfs_torch.render.serve import record_config
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig

    cfg = config_for_scene(0.5)
    cfg = cfg.replace(model=cfg.model.replace(mlp_dtype="float32"),
                      train=dataclasses.replace(cfg.train, warmup_steps=2,
                                                update_interval=2))
    tcfg = SwrTrainConfig(crop=256, lr=1e-2, max_steps=TRAIN_STEPS,
                          n_chunks=16, resample_kind="cubic", alpha_w=0.2,
                          random_bg=True, tv_w=5e-4, sigma_l1=1e-5)
    return cfg, record_config(), tcfg


def _parallel_rank(mesh, scene):
    """One rank of the parallel phase: the flagship NGP ``Trainer`` (both
    refreshes from its first state on fixed draws, then its steps) and the
    record ``SwrTrainer`` on ``mesh``, timed; the kernels' launches counted
    from 0 in this rank, over its pyramid steps."""
    import torch

    from taichi_nerfs_torch.ops.swr_sweep import chunk_sweep, chunk_sweep_bwd
    from taichi_nerfs_torch.parallel import sharded_density_grid_step
    from taichi_nerfs_torch.train.loop import Trainer
    from taichi_nerfs_torch.train.swr_step import SwrTrainer

    cfg, mcfg, tcfg = _parallel_configs()
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"rank": mesh.rank}
    tr = Trainer(cfg, _parallel_batch(torch, scene, dev), scene["K"],
                 scene["img_wh"], mesh=mesh, log_fn=lambda s: None)
    warm = sharded_density_grid_step(tr.state, cfg, mesh, True,
                                     draws=_parallel_grid_draws(cfg, True, dev))
    steady = sharded_density_grid_step(
        warm, cfg, mesh, False, draws=_parallel_grid_draws(cfg, False, dev))
    out["grids"] = [(g.occupancy.density_grid.cpu(),
                     g.occupancy.bitfield.cpu()) for g in (warm, steady)]
    del warm, steady
    out["ngp"] = _timed_steps(torch, tr, PAR_NGP_STEPS)
    del tr

    st = SwrTrainer(mcfg, tcfg, scene["rays"], scene["poses"], scene["K"],
                    scene["img_wh"], seed=3, alphas=scene["alphas"],
                    mesh=mesh)
    out["swr_draws"] = [st.draw_sharded() for _ in range(PAR_SWR_STEPS)]
    chunk_sweep.launches = chunk_sweep_bwd.launches = 0
    out["swr"] = _timed_steps(torch, st, PAR_SWR_STEPS, out["swr_draws"])
    out["launches"] = (chunk_sweep.launches, chunk_sweep_bwd.launches)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def _parallel_batch(torch, scene, dev):
    from taichi_nerfs_torch.train.step import Batch

    return Batch(*(torch.as_tensor(scene[k], device=dev)
                   for k in ("rays", "poses", "directions")))


def _parallel_grid_draws(cfg, warmup, dev):
    import torch

    from taichi_nerfs_torch.models.occupancy import draw_grid_inputs

    return draw_grid_inputs(cfg.model, warmup, torch.Generator(
        dev).manual_seed(11 + warmup), dev)


def _timed_steps(torch, trainer, n, draws=None):
    """``n`` steps of ``trainer``: losses, ms each, and (on the host) the
    params and Adam's first moment after the first step and the params
    after the last."""
    losses, ms, out = [], [], {}
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.run_step(*([] if draws is None else [draws[i]]))
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["params1"] = _host_leaves(trainer.state.params)
            out["mu1"] = _host_leaves(trainer.state.opt_state.mu)
    out["params"] = _host_leaves(trainer.state.params)
    return dict(out, losses=losses, ms=ms)


def _host_leaves(tree):
    from taichi_nerfs_torch.train.state import tree_leaves

    return [p.detach().cpu() for p in tree_leaves(tree)]


def _params_close(tag, got, want):
    """The params after the first step (``got``, ``want``: dicts of
    ``params1`` and ``mu1``, Adam's first moment, 0.1 times the gradient)
    within PAR_TOL (absolute and relative) but where the first-step
    gradient of both runs is below PAR_TINY_GRAD, at most PAR_FLIP_SHARE of
    the entries; returns (max difference, entries past the tolerance,
    entries)."""
    worst, off, bad, total = 0.0, 0, 0, 0
    for a, b, ma, mb in zip(got["params1"], want["params1"], got["mu1"],
                            want["mu1"], strict=True):
        if not b.numel():
            continue
        d = (a - b).abs()
        past = d > PAR_TOL + PAR_TOL * b.abs()
        tiny = ma.abs().maximum(mb.abs()) < 0.1 * PAR_TINY_GRAD
        worst = max(worst, float(d.max()))
        off += int(past.sum())
        bad += int((past & ~tiny).sum())
        total += b.numel()
    print(f"parallel: {tag}: params max difference {worst:.3e}, {off} of "
          f"{total} entries past {PAR_TOL} ({bad} of them with a gradient "
          f"of {PAR_TINY_GRAD} or more)", flush=True)
    if bad or off > PAR_FLIP_SHARE * total:
        raise AssertionError(f"{tag}: {off} of {total} params differ by "
                             f"more than {PAR_TOL}, {bad} of them with a "
                             f"gradient of {PAR_TINY_GRAD} or more")
    return worst, off, total


def _losses_close(tag, got, want):
    """The first step's loss within PAR_LOSS_RTOL of one process's; every
    loss finite.  Later steps start from params that may differ where the
    first step's atomics decided a sign, so their differences are only
    printed."""
    import numpy as np

    err = np.abs(np.asarray(got) - want) / np.abs(want)
    print(f"parallel: {tag}: losses {[round(float(x), 6) for x in got]}, "
          f"one process {[round(float(x), 6) for x in want]}, relative "
          f"differences {[float(f'{e:.3e}') for e in err]}", flush=True)
    if not np.all(np.isfinite(got)) or err[0] > PAR_LOSS_RTOL:
        raise AssertionError(f"{tag}: losses {got} vs {want}")


def _same_bits_on_every_rank(torch, tag, outs):
    for key in ("ngp", "swr"):
        for o in outs[1:]:
            for a, b in zip(outs[0][key]["params"], o[key]["params"],
                            strict=True):
                if not torch.equal(a, b):
                    raise AssertionError(f"{tag}: rank {o['rank']}'s {key} "
                                         "params differ from rank 0's")
    print(f"parallel: {tag}: NGP and pyramid params bitwise equal on the "
          f"{len(outs)} ranks", flush=True)


def _parallel_reference(torch, scene, outs):
    """One process on the card: the unsharded trainers' refreshes and NGP
    steps, and the pyramid steps as the mean of the ranks' crops'
    gradients with Adam applied once (on the draws the ranks made)."""
    from taichi_nerfs_torch.train.loop import Trainer
    from taichi_nerfs_torch.train.step import density_grid_step
    from taichi_nerfs_torch.train.swr_step import (
        SwrTrainer,
        apply_swr_grads,
        loss_and_grads,
        make_swr_loss,
    )

    cfg, mcfg, tcfg = _parallel_configs()
    dev = torch.device("cuda")
    tr = Trainer(cfg, _parallel_batch(torch, scene, dev), scene["K"],
                 scene["img_wh"], log_fn=lambda s: None)
    warm = density_grid_step(tr.state, cfg, True,
                             draws=_parallel_grid_draws(cfg, True, dev))
    steady = density_grid_step(warm, cfg, False,
                               draws=_parallel_grid_draws(cfg, False, dev))
    ref = {"grids": [(g.occupancy.density_grid.cpu(),
                      g.occupancy.bitfield.cpu()) for g in (warm, steady)]}
    del warm, steady
    ref["ngp"] = _timed_steps(torch, tr, PAR_NGP_STEPS)
    del tr
    st = SwrTrainer(mcfg, tcfg, scene["rays"], scene["poses"], scene["K"],
                    scene["img_wh"], seed=3, alphas=scene["alphas"],
                    device=dev)
    losses = []
    for s in range(PAR_SWR_STEPS):
        pl = st.plan_sharded(outs[0]["swr_draws"][s])
        parts = []
        for r, o in enumerate(outs):
            d = o["swr_draws"][s]
            parts.append(loss_and_grads(make_swr_loss(
                st.images[d.idxs[r]], st.poses_np[d.idxs[r]], st.K,
                d.wins[r], st.cur_mcfg, tcfg, pl.axis, pl.flip,
                d.bg.to(dev), d.tv_starts, st.lat_size, pl.warp,
                pl.slab_window, pl.inside, st.sigma_keep,
                None if pl.slope_bounds is None else pl.slope_bounds[r]),
                st.state.params))
            del d
        n = len(parts)
        grads = [sum(g) / n for g in zip(*(p[2] for p in parts))]
        st.state, m = apply_swr_grads(st.state, tcfg,
                                      sum(p[0] for p in parts) / n,
                                      sum(p[1] for p in parts) / n, grads)
        st.step += 1
        del parts, grads
        losses.append(float(m["loss"]))
        if s == 0:
            ref["swr"] = {"params1": _host_leaves(st.state.params),
                          "mu1": _host_leaves(st.state.opt_state.mu)}
    ref["swr"]["losses"] = losses
    return ref


def _parallel_compare(tag, outs, ref):
    """The ranks against one process; returns the worst params difference
    and the entries past the tolerance (NGP, pyramid)."""
    import numpy as np

    for (g, b), (gw, bw), what, rtol in zip(outs[0]["grids"], ref["grids"],
                                            ("warm-up", "steady"),
                                            (2e-6, 2e-5)):
        d = (g - gw).abs()
        off = int((d > PAR_TOL + rtol * gw.abs()).sum())
        bits = int((b != bw).sum())
        print(f"parallel: {tag}: {what} refresh of {g.numel()} cells: "
              f"density grid max difference {float(d.max()):.3e} ({off} "
              f"past {PAR_TOL} + {rtol} relative), {bits} bitfield words "
              "differ", flush=True)
        if off or bits:
            raise AssertionError(f"{tag}: the {what} refresh differs")
    _losses_close(f"{tag} NGP", outs[0]["ngp"]["losses"],
                  np.asarray(ref["ngp"]["losses"]))
    _losses_close(f"{tag} pyramid", outs[0]["swr"]["losses"],
                  np.asarray(ref["swr"]["losses"]))
    return (_params_close(f"{tag} NGP, first step", outs[0]["ngp"],
                          ref["ngp"]),
            _params_close(f"{tag} pyramid, first step", outs[0]["swr"],
                          ref["swr"]))


def _fmt_ms(ms):
    return [round(x, 3) for x in ms]


def _par_launches(par, k):
    """Kernel ``k``'s launches on each rank of each parallel run."""
    return {tag: [x[k] for x in par[tag]["launches"]]
            for tag in ("nccl 1 rank", "gloo 2 ranks on one card")}


def phase_parallel(torch, card):
    """Data-parallel training at full width: (a) ``cuda:0`` as a real NCCL
    process group of one rank; (b) two ranks sharing ``cuda:0`` over gloo
    (NCCL refuses two ranks on one card).  Each against one process on the
    card; every rank's params bitwise equal; both sweep kernels launched on
    every rank."""
    import tempfile

    import numpy as np

    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.parallel import launch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the earlier phases' cache, for the ranks
    ds = SyntheticSphereDataset(n_images=8, img_wh=(256, 256),
                                variant="checker", device="cuda")
    scene = {"rays": np.asarray(ds.rays, np.float32)[..., :3],
             "alphas": np.asarray(ds.alphas, np.float32),
             "poses": np.asarray(ds.poses, np.float32),
             "directions": np.asarray(ds.directions, np.float32),
             "K": np.asarray(ds.K, np.float32), "img_wh": ds.img_wh}
    del ds
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, n, device, backend in (("nccl 1 rank", 1, "cuda", "nccl"),
                                        ("gloo 2 ranks on one card", 2,
                                         "cuda:0", "gloo")):
            t0 = time.perf_counter()
            outs = launch(_parallel_rank, n, device=device, backend=backend,
                          rendezvous_dir=tmp, args=(scene,))
            secs = time.perf_counter() - t0
            ref = _parallel_reference(torch, scene, outs)
            worst = _parallel_compare(tag, outs, ref)
            _same_bits_on_every_rank(torch, tag, outs)
            launches = [o["launches"] for o in outs]
            if min(min(x) for x in launches) <= 0:
                raise AssertionError(f"{tag}: a sweep kernel was not "
                                     f"launched on every rank: {launches}")
            for o in outs:
                print(f"parallel ({card}): {tag}, rank {o['rank']}: NGP "
                      f"steps {[round(x, 3) for x in o['ngp']['ms']]} ms, "
                      f"pyramid steps "
                      f"{[round(x, 3) for x in o['swr']['ms']]} ms, peak "
                      f"{o['peak_gib']:.3f} GiB, swr_sweep_fwd / "
                      f"swr_sweep_bwd launches {o['launches']}", flush=True)
            print(f"parallel ({card}): {tag}: one process NGP steps "
                  f"{[round(x, 3) for x in ref['ngp']['ms']]} ms; the launch "
                  f"took {secs:.1f} s", flush=True)
            res[tag] = {"launches": launches, "worst": worst,
                        "ngp_ms": [o["ngp"]["ms"] for o in outs],
                        "swr_ms": [o["swr"]["ms"] for o in outs],
                        "peak_gib": [o["peak_gib"] for o in outs],
                        "secs": secs}
            del outs, ref
    res["secs"] = time.perf_counter() - t_phase
    print(f"parallel ({card}): phase {res['secs']:.1f} s (the times of "
          f"the 2 ranks are of 2 ranks sharing one card: not a scaling "
          f"figure)", flush=True)
    return res


def ptxas_summary(log):
    """One line per kernel of nvcc's ``-Xptxas -v`` output: the kernel with
    its template arguments (F, kind, the volume's type, operand bf16), its
    registers and, if any, its spills."""
    import re

    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"(swr_[a-z_]+_kernel)", mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            if "swr_" in mangled:
                args.append("bf16" if "bfloat16" in mangled else "float")
                args += [f"ops_bf16={b}"
                         for b in re.findall(r"Lb([01])E", mangled)]
            name = (base.group(1) if base else mangled) + (
                f"<{', '.join(args)}>" if args else "")
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

    names = _build.kernel_names()
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

    t_start = time.perf_counter()
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
    (fwd_n, bwd_n), step_ms, worst_grad, record = phase_train(torch,
                                                              args.seed)
    print(f"train: median steady full-depth step "
          f"{_median(step_ms[4]):.3f} ms, first phase (R=64) "
          f"{_median(step_ms[2]):.3f} ms; worst level-gradient "
          f"difference {worst_grad:.3e}", flush=True)
    lego, (dfl_fwd, dfl_bwd), dfl_ms, dfl_grad, dfl_gib = (
        phase_default_flags(torch, args.seed, card))
    scan = phase_scan(torch, args.seed, lego, card)
    bf16_k = phase_bf16_kernels(torch, args.seed, card)
    bf16_t = phase_bf16_train(torch, args.seed, lego, card)
    del lego
    bf16_s = phase_bf16_serve(torch, args.seed, card)
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
    print(f"summary bf16 ({card}): R=512 record recipe steady full-depth "
          f"step {bf16_t['step_ms']:.3f} ms, peak {bf16_t['peak_gib']:.3f} "
          f"GiB (fp32 bake: one step's peak {bf16_t['peak32_gib']:.3f} GiB),"
          f" gradients within {bf16_t['grad']:.3e}; R=512 800x800 bf16-bake "
          f"frames capped {bf16_s['ms']['bfloat16 capped']:.3f} ms, "
          f"uncapped {bf16_s['ms']['bfloat16 uncapped']:.3f} ms, rgb within "
          f"{bf16_s['rgb_max_abs']:.3e} of the fp32 bake", flush=True)
    inside = phase_inside(torch, args.seed, card)
    files = phase_files(torch, args.seed, card)
    ngp = phase_ngp(torch, args.seed)
    print(f"ngp: steady step {ngp['steady_ms']:.3f} ms, warmup step "
          f"{ngp['warm_ms']:.3f} ms, 800x800 frame "
          f"{ngp['frame_ms']:.2f} ms, device busy "
          f"{100.0 * ngp['busy']:.1f}% of 3 profiled steps", flush=True)
    models = phase_ngp_models(torch, args.seed, card)
    export = phase_export(torch, args.seed, card, record)
    viewer = phase_viewer(torch, args.seed, card, ngp, record)
    del record, ngp
    par = phase_parallel(torch, card)
    print(f"summary inside and files ({card}): inside phase "
          f"{inside['secs']:.1f} s (full-depth steps inside "
          f"{inside['step_ms_inside']:.3f} ms, outside "
          f"{inside['step_ms_outside']:.3f} ms, peak {inside['peak_gib']:.3f} "
          f"GiB, 800x800 inside frame {inside['frame_ms']:.2f} ms over "
          f"{inside['faces']} faces, card vs CPU gradients within "
          f"{inside['card_vs_cpu']:.3e}); files phase {files['secs']:.1f} s "
          f"({files['load_ms_per_view']:.2f} ms a view loaded, eval psnr "
          f"{files['eval_psnr']})", flush=True)
    tri, svox = models["triplane"], models["svox"]
    print(f"summary ngp_models, export and viewer ({card}): triplane steady "
          f"step {tri['steady_ms']:.3f} ms, peak {tri['peak_gib']:.3f} GiB, "
          f"800x800 frame {tri['frame_ms']:.2f} ms; svox steady step "
          f"{svox['steady_ms']:.3f} ms, peak {svox['peak_gib']:.3f} GiB, "
          f"800x800 frame {svox['frame_ms']:.2f} ms ({models['secs']:.1f} "
          f"s); export_native {export['native'][0] * 1e3:.1f} ms "
          f"{export['native'][1]} bytes, export_pyramid_native "
          f"{export['pyramid'][0]:.2f} s {export['pyramid'][1]} bytes "
          f"({export['secs']:.1f} s); viewer frames ngp median "
          f"{viewer['ngp']['median_ms']:.2f} ms, pyramid median "
          f"{viewer['pyramid']['median_ms']:.2f} ms ({viewer['secs']:.1f} s)"
          f"", flush=True)
    one, two = par["nccl 1 rank"], par["gloo 2 ranks on one card"]
    print(f"summary parallel ({card}): nccl, 1 rank: NGP steps "
          f"{_fmt_ms(one['ngp_ms'][0])} ms, pyramid steps "
          f"{_fmt_ms(one['swr_ms'][0])} ms, peak {one['peak_gib'][0]:.3f} GiB; "
          f"gloo, 2 ranks sharing one card: NGP steps "
          f"{[_fmt_ms(x) for x in two['ngp_ms']]} ms, pyramid steps "
          f"{[_fmt_ms(x) for x in two['swr_ms']]} ms, peak "
          f"{[round(x, 3) for x in two['peak_gib']]} GiB a rank; phase "
          f"{par['secs']:.1f} s; total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    fwd = timing[("serving nq=816", "cubic")]
    bwd = bwd_timing[("training R=256 nq=272", "cubic")]

    def bf16_shapes(which):
        keys = ("warm", "cold", "bound", "plain", "max_abs_err",
                "rel_norm_err", "parts")
        return {f"R=512 nq=272 cubic {pair}": {
            k: r[which][k] for k in keys if k in r[which]}
            for pair, r in bf16_k["r512"].items()}
    print(json.dumps({"kernels": [{
        "name": "swr_sweep_fwd",
        "route": "cuda",
        "source": "taichi_nerfs_torch/csrc/swr_sweep_fwd.cu",
        "replaces": "taichi_nerfs_tpu/ops/swr_pallas.py:116",
        # the default-flag (linear) training steps
        "launches": dfl_fwd,
        "launches_by_path": {"serve": serve_launches, "train": fwd_n,
                             "train_default_flags": dfl_fwd,
                             "scan": scan["sweep_launches"][0],
                             "train_bf16": bf16_t["launches"][0],
                             "serve_bf16": bf16_s["launches"],
                             "train_mixed_rig_outside":
                                 inside["launches_outside"][0],
                             "train_files": files["launches"][0],
                             "viewer": viewer["pyramid"]["launches"],
                             # a list: each rank's count
                             "train_parallel": _par_launches(par, 0)},
        "max_abs_err": worst,
        # on one recorded chunk of each R=512 frame, each bake and operand
        # dtype
        "max_abs_err_serve_bf16": bf16_s["kernel_max_abs"],
        # one chunk of the uncapped 800x800 frame, cubic, warm
        "ms": fwd["warm"],
        "plain_ms": fwd["plain"],
        "bound_ms": fwd["bound"],
        "bound_by": fwd["by"],
        "library_ms": None,  # no single PyTorch call computes the sweep
        "ms_by_shape": {**{f"{label} {kind}": {k: t[k] for k in
                                               ("warm", "cold", "bound",
                                                "plain")}
                           for (label, kind), t in sorted(timing.items())},
                        **bf16_shapes("fwd")},
    }, {
        "name": "swr_sweep_bwd",
        "route": "cuda",
        "source": "taichi_nerfs_torch/csrc/swr_sweep_bwd.cu",
        "replaces": "taichi_nerfs_tpu/ops/swr_pallas.py:178",
        "launches": dfl_bwd,
        "launches_by_path": {"train": bwd_n, "train_default_flags": dfl_bwd,
                             "scan": scan["sweep_launches"][1],
                             "train_bf16": bf16_t["launches"][1],
                             "train_mixed_rig_outside":
                                 inside["launches_outside"][1],
                             "train_files": files["launches"][1],
                             "train_parallel": _par_launches(par, 1)},
        # the backward's second kernel, swr_sweep_bwd_rows_kernel (a bf16
        # volume or bf16 operands)
        "finish_launches_by_path": {"train_bf16":
                                    bf16_t["finish_launches"]},
        "max_abs_err": worst_bwd,
        # the full-depth training shape, cubic, warm
        "ms": bwd["warm"],
        "cold_ms": bwd["cold"],
        "plain_ms": bwd["plain"],
        "bound_ms": bwd["bound"],
        "bound_by": bwd["by"],
        "library_ms": None,
        "ms_by_shape": {**{f"{label} {kind}": {k: t[k] for k in
                                               ("warm", "cold", "bound",
                                                "plain", "rerun_max_abs")}
                           for (label, kind), t in sorted(bwd_timing.items())},
                        **bf16_shapes("bwd")},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
