#!/usr/bin/env python3
"""Data-parallel training on every visible card over NCCL, against one
process: ``chip_smoke.py``'s ``parallel`` comparison at N ranks.

On 8 checker views at 256x256 made on the card, N ranks (``cuda:0`` ..
``cuda:N-1``, one each, NCCL) run the flagship NGP configuration (fp32
MLPs, a refresh every 2 steps: both refreshes from the first state, then 4
steps) and the record pyramid at full depth (2 crop-parallel steps, a crop
a rank); one process on ``cuda:0`` runs the same NGP steps and the pyramid
steps as the mean of the ranks' crops' gradients.  The checks are the
phase's (refreshes equal, the first step's loss within 1e-5 and params
within 2e-6 but where a gradient is below 1e-8, every rank's params
bitwise equal); each rank's step times and peak memory are printed beside
the card's name and power limit.  Then ``python -m taichi_nerfs_torch.entry``
(the dry run on every card) and ``python -m taichi_nerfs_torch.train
--model_name pyramid`` with the default ``--num_devices 0`` (every card)
for 8 steps.  Run it where several cards are visible::

    python3 scripts/torch_parallel_cards.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compare(n: int, card: str) -> None:
    import chip_smoke as c

    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.parallel import launch

    ds = SyntheticSphereDataset(n_images=8, img_wh=(256, 256),
                                variant="checker", device="cuda")
    scene = {"rays": np.asarray(ds.rays, np.float32)[..., :3],
             "alphas": np.asarray(ds.alphas, np.float32),
             "poses": np.asarray(ds.poses, np.float32),
             "directions": np.asarray(ds.directions, np.float32),
             "K": np.asarray(ds.K, np.float32), "img_wh": ds.img_wh}
    tag = f"nccl {n} ranks"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = launch(c._parallel_rank, n, device="cuda", backend="nccl",
                      rendezvous_dir=tmp, args=(scene,))
        secs = time.perf_counter() - t0
    ref = c._parallel_reference(torch, scene, outs)
    c._parallel_compare(tag, outs, ref)
    c._same_bits_on_every_rank(torch, tag, outs)
    for o in outs:
        print(f"parallel ({card}): {tag}, rank {o['rank']}: NGP steps "
              f"{c._fmt_ms(o['ngp']['ms'])} ms, pyramid steps "
              f"{c._fmt_ms(o['swr']['ms'])} ms, peak {o['peak_gib']:.3f} "
              f"GiB, launches {o['launches']}", flush=True)
    print(f"parallel ({card}): {tag}: one process NGP steps "
          f"{c._fmt_ms(ref['ngp']['ms'])} ms; launch {secs:.1f} s",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_parallel_cards: no CUDA device")
    sys.path.insert(0, _REPO)
    import chip_smoke as c

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    n = torch.cuda.device_count()
    print(f"{n} CUDA devices", flush=True)
    c.phase_build()
    compare(n, card.splitlines()[0])
    for cmd in (["-m", "taichi_nerfs_torch.entry"],
                ["-m", "taichi_nerfs_torch.train", "--root_dir",
                 "synthetic://lego?views=8&res=256", "--dataset_name",
                 "synthetic", "--model_name", "pyramid", "--max_steps", "8",
                 "--exp_name", "nd", "--eval_views", "1"]):
        r = subprocess.run([sys.executable] + cmd, cwd=_REPO)
        print("exit", r.returncode, " ".join(cmd[:2]), flush=True)
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
