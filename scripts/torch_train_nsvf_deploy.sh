#!/bin/bash
# Deployment-config training and export on the PyTorch port (the card by
# default; append --device cpu for the CPU).  Counterpart of
# train_nsvf_deploy.sh.  Expects the NSVF Synthetic-NeRF Lego scene
# (bbox.txt, intrinsics.txt, pose/, rgb/) in $DATA_DIR/Lego; nothing is
# downloaded.  Writes the deployment files into ./deploy.
REPO="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"
export DATA_DIR=${DATA_DIR:-./Synthetic_NeRF}

python -m taichi_nerfs_torch.train \
    --root_dir "$DATA_DIR/Lego" \
    --exp_name Lego_deploy \
    --dataset_name nsvf \
    --batch_size 8192 \
    --lr 1e-2 \
    --max_steps 20000 \
    --deployment \
    --deployment_model_path ./deploy \
    "$@"
