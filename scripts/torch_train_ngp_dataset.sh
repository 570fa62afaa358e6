#!/bin/bash
# An instant-ngp transforms.json dataset on the PyTorch port (the card by
# default; append --device cpu for the CPU).  Counterpart of
# train_ngp_dataset.sh.  Expects transforms.json and its images in
# $DATA_DIR; nothing is downloaded.
REPO="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"
export DATA_DIR=${DATA_DIR:-./data/ngp}

python -m taichi_nerfs_torch.train \
    --root_dir "$DATA_DIR" \
    --exp_name ngp_scene \
    --dataset_name ngp \
    --scale 8.0 \
    --downsample 0.5 \
    "$@"
