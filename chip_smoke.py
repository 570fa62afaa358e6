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
   random ragged shapes, at the serving shapes (forward) and at the three
   training shapes (backward), with timings;
4. serve: ``PyramidRenderer`` renders 4 orbit views at 800x800, capped and
   uncapped, with cubic resampling; the outputs are checked, the forward
   kernel's launch count during those frames must be > 0, and one view is
   rendered again through the plain sweep and compared;
5. train: ``SwrTrainer`` trains the record configuration for 24 steps
   through all three coarse-to-fine phases on procedural lego views made on
   the card; every loss must be finite and the loss must fall, both
   kernels' launch counts during the steps must be > 0, one full-depth
   step's gradient through the kernels is compared with the one through
   the plain sweep, and one test view is rendered uncapped.

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
TRAIN_STEPS, PROG_STEPS = 24, (4, 4)
# the loss must fall: on 4 fixed crops (with fixed backgrounds), the loss
# after training below this share of the loss of the initial params
LOSS_FALL = 0.95


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


def phase_bwd_kernels(torch):
    """``swr_sweep_bwd`` against autograd of the plain sweep: ragged
    shapes for F in {4, 8, 16} and both kinds, the clamp-binding inputs,
    and the three training shapes (cubic, timed)."""
    import numpy as np

    from taichi_nerfs_torch.ops.swr_sweep import (
        chunk_sweep,
        chunk_sweep_bwd,
        chunk_sweep_reference,
    )

    rng = np.random.default_rng(1)
    cases = [
        (f"ragged F={F}", dict(nc=2, dc=3, F=F, R=40, nq=37,
                               realistic=False), ("linear", "cubic"))
        for F in (4, 8, 16)
    ] + [("clamp-binding", None, ("linear", "cubic"))] + [
        (f"training R={R} nq={nq}", dict(nc=16, dc=dc, F=8, R=R, nq=nq,
                                         realistic=True), ("cubic",))
        for R, dc, nq in TRAIN_SHAPES
    ]
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
                k_ms = _time_ms(torch, lambda: chunk_sweep_bwd(
                    *args, frames, g, nq, kind), 10)
                p_ms = _time_ms(torch, lambda: torch.autograd.grad(
                    out, v, g, retain_graph=True), 5)
                timing[(nq, kind)] = (k_ms, p_ms)
                print(f"  time R={args[0].shape[-1]} nq={nq} {kind}: "
                      f"kernel {k_ms:.4f} ms, plain backward {p_ms:.4f} ms "
                      f"(median, CUDA events)", flush=True)
            del out, v
    torch.cuda.synchronize()
    return worst, timing


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
    from taichi_nerfs_torch.train.swr_step import make_swr_loss

    c = trainer.tcfg.crop
    total = 0.0
    with torch.no_grad():
        for i, xy, bg in evals:
            axis, flip = trainer._axis_flip[i]
            warp = pick_warp(trainer.poses_np[i], trainer.K, (c, c), axis,
                             crop_xy=xy)
            loss, _ = make_swr_loss(
                trainer.images[i], trainer.poses_np[i], trainer.K, xy,
                trainer.cur_mcfg, trainer.tcfg, axis, flip, bg, (0,),
                trainer.lat_size, warp,
            )(trainer.state.params)
            total += float(loss)
    return total / len(evals)


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
    from concurrent.futures import ThreadPoolExecutor

    from taichi_nerfs_torch.ops import _build

    names = ("swr_sweep_fwd", "swr_sweep_bwd")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source
        builds = list(pool.map(_build.build, names))
    for name, (path, log, secs) in zip(names, builds):
        _build.load(name)
        built = f"in {secs:.2f} s" if log else "(already built)"
        print(f"build: {os.path.relpath(path)} {built}", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    worst, timing = phase_kernels(torch)
    worst_bwd, bwd_timing = phase_bwd_kernels(torch)
    serve_launches, frame_ms = phase_slice(torch, args.ckpt_path, args.seed)
    print(f"slice: 800x800 cubic frame median: capped "
          f"{frame_ms['capped']:.3f} ms, uncapped "
          f"{frame_ms['uncapped']:.3f} ms", flush=True)
    (fwd_n, bwd_n), step_ms, worst_grad = phase_train(torch, args.seed)
    print(f"train: median steady full-depth step "
          f"{_median(step_ms[4]):.3f} ms, first phase (R=64) "
          f"{_median(step_ms[2]):.3f} ms; worst level-gradient difference "
          f"{worst_grad:.3e}", flush=True)

    k_ms, p_ms = timing[(816, "cubic")]
    kb_ms, pb_ms = bwd_timing[(TRAIN_SHAPES[-1][2], "cubic")]
    print(json.dumps({"kernels": [{
        "name": "swr_sweep_fwd",
        "route": "cuda",
        "source": "taichi_nerfs_torch/csrc/swr_sweep_fwd.cu",
        "replaces": "taichi_nerfs_tpu/ops/swr_pallas.py:116",
        "launches": fwd_n,
        "launches_by_path": {"serve": serve_launches, "train": fwd_n},
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "swr_sweep_bwd",
        "route": "cuda",
        "source": "taichi_nerfs_torch/csrc/swr_sweep_bwd.cu",
        "replaces": "taichi_nerfs_tpu/ops/swr_pallas.py:178",
        "launches": bwd_n,
        "launches_by_path": {"train": bwd_n},
        "max_abs_err": worst_bwd,
        "ms": kb_ms,
        "plain_ms": pb_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
