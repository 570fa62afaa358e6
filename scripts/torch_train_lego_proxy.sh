#!/bin/bash
# Lego-proxy quality record on the PyTorch port (the card by default;
# append --device cpu for the CPU): the dense pyramid on the procedural
# lego build (100 views at 800x800, sphere-traced surface GT,
# data/synthetic.py `lego`), evaluated on the 25-view held-out rig.
# Counterpart of train_lego_proxy.sh.  No data is needed: the views are
# rendered on the device at start (nothing is cached on disk).
REPO="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"
python -m taichi_nerfs_torch.train \
    --root_dir "synthetic://lego?views=100&res=800" \
    --dataset_name synthetic \
    --model_name pyramid \
    --max_steps "${MAX_STEPS:-3600}" \
    --exp_name lego_proxy "$@"
