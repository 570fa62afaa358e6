#!/usr/bin/env python3
"""Publish a quality record of the PyTorch port into ``docs/records/``.

Counterpart of ``scripts/publish_record.py``: copies the manifest that
``scripts/torch_quality_run.py`` wrote (config hash, per-view PSNRs, seed,
git commit) to ``docs/records/<name>.manifest.json`` and, with ``--state``,
renders the first held-out view from the recorded checkpoint (uncapped,
through the sweep kernel on the card) into ``<name>_rgb.png``,
``<name>_gt.png`` and ``<name>_depth.png``.  Paths are relative to the
working directory.  The configs are rebuilt from the manifest's plain JSON
with the dataclass constructors; no manifest text is evaluated.

    python3 scripts/torch_publish_record.py \\
        [--manifest results/model_pyramid.manifest.json] \\
        [--state quality_run_state.pt] [--name lego_proxy] [--device cpu]

With ``--state`` it renders on the card unless ``--device cpu`` is given,
and raises without one; copying the manifest alone needs no device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--manifest",
                    default="results/model_pyramid.manifest.json")
    ap.add_argument("--name", default="lego_proxy")
    ap.add_argument("--state", default="")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    from taichi_nerfs_torch.ops._build import launch_counts
    from taichi_nerfs_torch.utils.device import resolve_device

    # copying the manifest needs no device; rendering the view does
    device = resolve_device(args.device, "--device cpu") if args.state \
        else None
    out = os.path.join("docs", "records")
    os.makedirs(out, exist_ok=True)
    with open(args.manifest) as f:
        man = json.load(f)
    shutil.copy(args.manifest, os.path.join(out, f"{args.name}.manifest.json"))
    print(f"published manifest: psnr={man['eval_psnr']} "
          f"ssim={man['eval_ssim']} wall={man['train_wall_s']}s "
          f"views_finite={man['views_finite']}", flush=True)
    if not args.state:
        print(launch_counts(), flush=True)
        return 0

    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.models.pyramid import PyramidConfig
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig, SwrTrainer
    from taichi_nerfs_torch.utils.viz import depth2img, write_png

    cfg_blob = json.loads(man["config"])
    if isinstance(cfg_blob["mcfg"], str):
        raise SystemExit("legacy repr-format manifest: re-generate it with "
                         "scripts/torch_quality_run.py")

    def _tup(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}

    mcfg = PyramidConfig(**_tup(cfg_blob["mcfg"]))
    tcfg = SwrTrainConfig(**_tup(cfg_blob["tcfg"]))
    spec = cfg_blob["spec"]
    train_ds = SyntheticSphereDataset(spec, split="train", device=device)
    tr = SwrTrainer(
        mcfg, tcfg, train_ds.rays, train_ds.poses, train_ds.K,
        train_ds.img_wh,
        alphas=(train_ds.alphas if (tcfg.random_bg or tcfg.alpha_w > 0)
                else None),
        device=device,
    )
    tr.load_state(args.state)
    tr.state = tr.state._replace(opt_state=None)
    test_ds = SyntheticSphereDataset(spec, split="test", device=device)
    w, h = test_ds.img_wh
    s0 = test_ds[0]
    o = tr.render(s0["pose"], K=None, img_wh=(w, h), lat_cap=None)
    rgb = np.clip(o["rgb"].cpu().numpy().reshape(h, w, 3), 0, 1)
    gt = np.clip(np.asarray(s0["rgb"]).reshape(h, w, 3), 0, 1)
    depth = o["depth"].cpu().numpy().reshape(h, w)
    write_png(os.path.join(out, f"{args.name}_rgb.png"),
              (rgb * 255).astype(np.uint8))
    write_png(os.path.join(out, f"{args.name}_gt.png"),
              (gt * 255).astype(np.uint8))
    write_png(os.path.join(out, f"{args.name}_depth.png"), depth2img(depth))
    psnr = -10 * np.log10(((rgb - gt) ** 2).mean())
    print(f"published view 0 renders (psnr {psnr:.2f})", flush=True)
    print(launch_counts(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
