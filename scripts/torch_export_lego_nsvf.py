#!/usr/bin/env python3
"""Write the procedural lego proxy as an on-disk NSVF scene.

Counterpart of ``scripts/export_lego_nsvf.py`` on the PyTorch port: the
train and test views of ``--spec`` (the lego proxy, 100 views at 800x800 by
default) are rendered (on the card unless ``--device cpu``) and written
through ``data/nsvf_export.py`` (rgb PNGs, pose txts, intrinsics, bbox), so
that a run reads them through the file loader::

    python3 scripts/torch_export_lego_nsvf.py [out_root] \\
        [--spec 'synthetic://lego?views=100&res=800'] [--device cpu]
    python -m taichi_nerfs_torch.train --root_dir <out_root> \\
        --dataset_name nsvf --model_name pyramid ...

``out_root`` defaults to ``Synthetic_NSVF/legoproxy`` in the temporary
directory; the NSVF loader needs ``Synthetic`` in the path.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_root", nargs="?",
                    default=os.path.join(tempfile.gettempdir(),
                                         "Synthetic_NSVF", "legoproxy"))
    ap.add_argument("--spec", default="synthetic://lego?views=100&res=800",
                    help="the synthetic scene: variant, views, resolution")
    ap.add_argument("--device", default="cuda",
                    help="where the views are rendered: 'cuda' (the "
                         "default; raises without a card) or 'cpu'")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    sys.path.insert(0, _REPO)
    from taichi_nerfs_torch.data.nsvf_export import export_nsvf_dataset
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.utils.device import resolve_device

    device = resolve_device(args.device, "--device cpu")
    t0 = time.perf_counter()
    tr = SyntheticSphereDataset(root_dir=args.spec, split="train",
                                device=device)
    te = SyntheticSphereDataset(root_dir=args.spec, split="test",
                                device=device)
    print(f"views rendered on {device} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    export_nsvf_dataset(args.out_root, {"train": tr, "test": te})
    print(f"wrote {len(tr)} train + {len(te)} test views to "
          f"{args.out_root}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
