#!/bin/bash
# Video -> COLMAP -> train on the PyTorch port (the card).  Counterpart of
# train_from_video.sh.  Expects a video file and the colmap and ffmpeg
# binaries on PATH; writes transforms.json and images into <workdir>.
# usage: torch_train_from_video.sh <video> <workdir>
set -e
VIDEO=${1:?usage: torch_train_from_video.sh <video> <workdir>}
WORK=${2:?usage: torch_train_from_video.sh <video> <workdir>}
REPO="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"

python -m taichi_nerfs_torch.data.colmap2nerf \
    --video "$VIDEO" \
    --out_dir "$WORK" \
    --video_fps 2

python -m taichi_nerfs_torch.train \
    --root_dir "$WORK" \
    --exp_name video_scene \
    --dataset_name ngp \
    --scale 8.0 \
    --gui
