#!/usr/bin/env python3
"""Brick parity-path stage analysis at steady state, on the PyTorch port.

Counterpart of ``scripts/roofline_parity.py``: the real ``Trainer`` of the
bench's parity configuration (``config_for_scene(0.5)``: brick encoder,
batch 8192) settles on 8 checker views at 256x256 to ``--settle_steps``
(the adaptive sample caps grow for a few hundred steps past the warm-up),
then each pipeline stage runs as implemented at the settled shapes:

* march        — the marcher (``ops/marching.py:march_rays``);
* render_fwd   — march + brick encode + MLPs + composite
                 (``render/renderer.py:render_train``);
* render_fwd_bwd — the loss gradient (adds the encoder's scatter and the
                 MLPs' backward);
* grid refresh — ``train/step.py:density_grid_step``, amortised over its
                 cadence (``update_interval``).

Each stage's calls are timed with CUDA events behind
``torch.cuda.synchronize()`` (the mean); ``Trainer.run_step`` is timed over
48 steps on the host clock, ending in a host read.  The stage sum against
the measured step bounds dispatch and cadence overhead.  The encoder's
access floor is the card's own: the brick rows' bytes over the H100's HBM
rate (3.35 TB/s, each gathered row read and written once, each scattered
row read and added once), and the row rates measured here on this card
with ``scripts/torch_microbench_gather.py``'s brick row-gather and an
``index_add_`` of the same rows.  No sweep kernel runs.

    python3 scripts/torch_roofline_parity.py [--settle_steps 800] \\
        [--json out.json] [--device cpu]

``--json`` writes the JAX script's record keys plus ``card``.  It runs on
the card unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
# the JAX script's scene and repeats; a test shrinks them
N_VIEWS, RES = 8, 256
STAGE_REPS, REFRESH_REPS, STEP_REPS = (20, 3), (5, 1), 48
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, at a 700 W power limit


def config():
    """The analysed configuration: the bench's parity config (brick)."""
    from taichi_nerfs_torch.config import config_for_scene

    return config_for_scene(0.5)


def mean_ms(fn, n, warm, device):
    from taichi_nerfs_torch.utils.profiling import time_calls

    ms = time_calls(fn, n, warm, device)
    return sum(ms) / len(ms)


def row_rates(n_rows_table, width, n_rows, device):
    """Rows a second of the brick row-gather and of an ``index_add_`` of the
    same rows, on a (n_rows_table, width) fp32 table at ``n_rows`` random
    row indices."""
    import torch

    sys.path.insert(0, _HERE)
    from torch_microbench_gather import gather_brick

    g = torch.Generator(device).manual_seed(0)
    table = torch.rand((n_rows_table, width), generator=g, device=device)
    idx = torch.randint(0, n_rows_table, (n_rows,), generator=g,
                        device=device, dtype=torch.int32)
    rows = gather_brick(table, idx)
    n, warm = STAGE_REPS
    gather = mean_ms(lambda: gather_brick(table, idx), n, warm, device)
    scatter = mean_ms(lambda: table.index_add_(0, idx, rows), n, warm,
                      device)
    return n_rows / gather * 1e3, n_rows / scatter * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default="")
    ap.add_argument("--settle_steps", type=int, default=800)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    import torch

    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.ops.brick_encoder import build_brick_layout
    from taichi_nerfs_torch.ops.marching import march_rays, perturb_t_start
    from taichi_nerfs_torch.ops.rays import get_rays, ray_aabb_intersect
    from taichi_nerfs_torch.ops._build import launch_counts
    from taichi_nerfs_torch.render.renderer import render_train
    from taichi_nerfs_torch.train.loop import Trainer
    from taichi_nerfs_torch.train.state import tree_leaves
    from taichi_nerfs_torch.train.step import (
        density_grid_step,
        draw_step,
        sample_batch,
    )
    from taichi_nerfs_torch.utils.device import card_line, resolve_device

    device = resolve_device(args.device, "--device cpu")
    card = card_line() if device.type == "cuda" else None
    if card:
        print(card, flush=True)

    cfg = config()
    scene = SyntheticSphereDataset(n_images=N_VIEWS, img_wh=(RES, RES),
                                   variant="checker", n_steps=256,
                                   device=device)
    trainer = Trainer(cfg, scene.as_batch(device), scene.K, scene.img_wh,
                      log_fn=lambda *a, **k: None, device=device)
    t0 = time.perf_counter()
    m = None
    while trainer.step < args.settle_steps:
        for _ in range(16):
            m = trainer.run_step()
        float(m["loss"])
    print(f"settled to step {trainer.step} in "
          f"{time.perf_counter() - t0:.0f}s", flush=True)
    B = cfg.train.batch_size
    S, P = trainer.sample_cap, trainer.pack_cap
    layout = build_brick_layout(cfg.model.brick)
    print(
        f"steady shapes: batch={B} sample_cap={S} pack_cap={P} "
        f"levels={layout.levels} rows/sample={layout.levels} "
        f"rm_s={float(m['rm_samples']) / B:.1f}",
        flush=True,
    )

    state, data = trainer.state, trainer.data
    draws = draw_step(cfg, data, torch.Generator(device).manual_seed(7))
    rgb_gt, pose, direction = sample_batch(data, draws.img_idxs,
                                           draws.pix_idxs)
    rays_o, rays_d = get_rays(direction, pose)
    bitfield = state.occupancy.bitfield
    mcfg, rcfg = cfg.model, cfg.render
    stages = {}
    n, warm = STAGE_REPS

    # march (the marcher as dispatched by render_train)
    hits = ray_aabb_intersect(rays_o, rays_d, mcfg.scale)
    t_start = perturb_t_start(hits, draws.t_noise, rcfg.exp_step_factor,
                              mcfg.grid_size, mcfg.scale)

    def march():
        march_rays(rays_o, rays_d, t_start, hits[:, 1], bitfield,
                   cascades=mcfg.cascades, scale=mcfg.scale,
                   exp_step_factor=rcfg.exp_step_factor,
                   grid_size=mcfg.grid_size, sample_cap=S)

    stages["march"] = mean_ms(march, n, warm, device)

    # field fwd (march + encode + MLPs + composite, as render_train)
    def render(p):
        return render_train(p, mcfg, rcfg, bitfield, rays_o, rays_d, S, P,
                            t_noise=draws.t_noise, bg=draws.bg)

    def fwd():
        with torch.no_grad():
            render(state.params)

    stages["render_fwd"] = mean_ms(fwd, n, warm, device)

    # fwd + bwd (adds the per-level gradient scatters + MLP bwd)
    leaves = tree_leaves(state.params)

    def fwd_bwd():
        loss = torch.mean((render(state.params)["rgb"] - rgb_gt) ** 2)
        torch.autograd.grad(loss, leaves)

    stages["render_fwd_bwd"] = mean_ms(fwd_bwd, n, warm, device)

    # density-grid refresh, amortized over its cadence
    gen = torch.Generator(device).manual_seed(11)
    refresh_ms = mean_ms(
        lambda: density_grid_step(state, cfg, warmup=False, generator=gen),
        *REFRESH_REPS, device)
    stages["grid_refresh/16"] = refresh_ms / cfg.train.update_interval

    # measured full step (cadence included)
    t0 = time.perf_counter()
    for _ in range(STEP_REPS):
        m = trainer.run_step()
    float(m["loss"])
    step_ms = (time.perf_counter() - t0) / STEP_REPS * 1e3
    rays_s = B / step_ms * 1e3

    # stage sum: bwd timing includes the fwd, so the pipeline lower
    # bound is march-in-fwd + fwd_bwd + refresh share
    stage_sum = stages["render_fwd_bwd"] + stages["grid_refresh/16"]
    print("-" * 56)
    for k, v in stages.items():
        print(f"stage {k:16s} {v:8.2f} ms")
    print(
        f"stage lower bound (fwd+bwd + refresh/16): {stage_sum:8.2f} ms"
    )
    print(
        f"measured step:    {step_ms:8.2f} ms ({rays_s / 1e3:.1f}K rays/s)"
        f"  overhead ratio {step_ms / stage_sum:.2f}x"
    )
    # access arithmetic for the dominant stage at these shapes, on this
    # card: the bytes' floor, and the row rates measured here
    rows = (P or B * S) * layout.levels
    row_bytes = layout.row_width * 4
    bytes_ms = 4 * rows * row_bytes / HBM_BYTES_PER_S * 1e3
    gather_rate, scatter_rate = row_rates(layout.n_rows, layout.row_width,
                                          rows, device)
    on = f" on {card}" if card else f" on the {device.type}"
    print(
        f"access context: {rows / 1e6:.1f}M gather rows + "
        f"{rows / 1e6:.1f}M scatter rows per step at row width "
        f"{row_bytes}B; their bytes (4 x rows x row width) over "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s take {bytes_ms:.2f} ms"
    )
    print(
        f"measured row rates{on}: {gather_rate / 1e6:.0f}M gather, "
        f"{scatter_rate / 1e6:.0f}M scatter rows/s; the encoder floor "
        f"alone at these rates is "
        f"{rows / gather_rate * 1e3 + rows / scatter_rate * 1e3:.2f} ms",
        flush=True,
    )
    print(launch_counts(), flush=True)
    if args.json:
        rec = {
            "batch": B, "sample_cap": int(S), "pack_cap": int(P or 0),
            "stages_ms": {k: round(v, 2) for k, v in stages.items()},
            "stage_sum_ms": round(stage_sum, 2),
            "step_ms": round(step_ms, 2),
            "rays_per_s": round(rays_s, 1),
            "overhead_ratio": round(step_ms / stage_sum, 2),
            "gather_rows": rows,
            "settled_step": int(trainer.step),
            "card": card,
        }
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=2)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
