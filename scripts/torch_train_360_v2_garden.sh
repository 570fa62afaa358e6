#!/bin/bash
# Unbounded mip-NeRF-360 garden scene on the PyTorch port (the card by
# default; append --device cpu for the CPU).  Counterpart of
# train_360_v2_garden.sh.  Expects the mip-NeRF 360 "garden" capture (COLMAP
# sparse/0 and images/) in $DATA_DIR/garden; nothing is downloaded.
REPO="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"
export DATA_DIR=${DATA_DIR:-./360_v2}

python -m taichi_nerfs_torch.train \
    --root_dir "$DATA_DIR/garden" \
    --exp_name garden \
    --dataset_name colmap \
    --scale 8.0 \
    --downsample 0.25 \
    --batch_size 4096 \
    "$@"
