"""Video or image folder -> instant-ngp ``transforms.json``.

Copy of the JAX package's ``data/colmap2nerf.py``: ffmpeg frame extraction
(fps and a time slice), COLMAP feature extraction, matching and mapping as
subprocesses (each gated on its binary being on ``PATH``), a Laplacian
sharpness score per image (numpy here, in place of OpenCV), the intrinsics
of every COLMAP camera model, the pose reorientation (y and z flipped,
recentred on the cameras' centroid, scaled to a mean distance of 4) and the
``transforms.json`` that ``NGPDataset`` reads.  COLMAP's output is read with
the binary parsers of :mod:`.colmap_utils`.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np

from .colmap_utils import (
    read_cameras_binary,
    read_images_binary,
)


def _require(binary: str):
    if shutil.which(binary) is None:
        raise RuntimeError(
            f"'{binary}' not found on PATH — required for this stage"
        )


def extract_frames(
    video_path: str,
    out_dir: str,
    fps: float = 2.0,
    time_slice: Optional[str] = None,
):
    """ffmpeg frame extraction."""
    _require("ffmpeg")
    os.makedirs(out_dir, exist_ok=True)
    args: List[str] = ["ffmpeg", "-y", "-i", video_path]
    vf = f"fps={fps}"
    if time_slice:
        start, end = (float(x) for x in time_slice.split(","))
        vf += f",select='between(t\\,{start}\\,{end})'"
        args += ["-vsync", "vfr"]
    args += ["-vf", vf, os.path.join(out_dir, "%04d.jpg")]
    subprocess.run(args, check=True, capture_output=True)


def run_colmap(
    images_dir: str,
    workspace: str,
    camera_model: str = "OPENCV",
    matcher: str = "sequential",
):
    """COLMAP SfM: features -> matches -> mapper -> bundle adjust."""
    _require("colmap")
    db = os.path.join(workspace, "database.db")
    sparse = os.path.join(workspace, "sparse")
    os.makedirs(sparse, exist_ok=True)
    subprocess.run(
        [
            "colmap", "feature_extractor",
            "--database_path", db,
            "--image_path", images_dir,
            "--ImageReader.camera_model", camera_model,
            "--ImageReader.single_camera", "1",
            "--SiftExtraction.estimate_affine_shape", "1",
            "--SiftExtraction.domain_size_pooling", "1",
        ],
        check=True,
    )
    matcher_cmd = {
        "sequential": "sequential_matcher",
        "exhaustive": "exhaustive_matcher",
    }[matcher]
    subprocess.run(
        [
            "colmap", matcher_cmd,
            "--database_path", db,
            "--SiftMatching.guided_matching", "1",
        ],
        check=True,
    )
    subprocess.run(
        [
            "colmap", "mapper",
            "--database_path", db,
            "--image_path", images_dir,
            "--output_path", sparse,
            "--Mapper.ba_global_function_tolerance", "1e-6",
        ],
        check=True,
    )
    return os.path.join(sparse, "0")


def _gray(img: np.ndarray) -> np.ndarray:
    """8-bit RGB(A) or grey -> 8-bit grey as OpenCV's ``COLOR_BGR2GRAY``
    rounds it: (R, G, B) weighted 19595, 38470, 7471 in 2^-16, rounded."""
    img = np.asarray(img)
    if img.ndim == 2:
        return img.astype(np.uint8)
    r, g, b = (img[..., k].astype(np.int64) for k in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + (1 << 15)) >> 16).astype(
        np.uint8)


def _laplacian(gray: np.ndarray) -> np.ndarray:
    """``cv2.Laplacian(gray, CV_64F)``: the 4-neighbour kernel (ksize 1)
    with the image reflected about its edge pixels (BORDER_REFLECT_101)."""
    g = np.pad(np.asarray(gray, np.float64), 1, mode="reflect")
    return (g[:-2, 1:-1] + g[2:, 1:-1] + g[1:-1, :-2] + g[1:-1, 2:]
            - 4.0 * g[1:-1, 1:-1])


def sharpness(image_path: str) -> float:
    """Laplacian-variance focus measure of the image's grey levels."""
    from .color_utils import imread

    return float(_laplacian(_gray(imread(image_path))).var())


def _camera_intrinsics(cam) -> dict:
    """All COLMAP camera models -> fl/c/k/p params."""
    w, h = cam.width, cam.height
    p = cam.params
    out = dict(
        w=w, h=h, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
        cx=w / 2, cy=h / 2, is_fisheye=False,
    )
    model = cam.model
    if model == "SIMPLE_PINHOLE":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
    elif model == "PINHOLE":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
    elif model == "SIMPLE_RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3])
    elif model == "RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3], k2=p[4])
    elif model == "OPENCV":
        out.update(
            fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
            k1=p[4], k2=p[5], p1=p[6], p2=p[7],
        )
    elif model == "SIMPLE_RADIAL_FISHEYE":
        out.update(
            fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3],
            is_fisheye=True,
        )
    elif model == "RADIAL_FISHEYE":
        out.update(
            fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3], k2=p[4],
            is_fisheye=True,
        )
    elif model == "OPENCV_FISHEYE":
        out.update(
            fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
            k1=p[4], k2=p[5], is_fisheye=True,
        )
    else:
        raise ValueError(f"unsupported COLMAP camera model {model}")
    out["camera_angle_x"] = 2 * math.atan(out["w"] / (2 * out["fl_x"]))
    out["camera_angle_y"] = 2 * math.atan(out["h"] / (2 * out["fl_y"]))
    return out


def colmap_to_transforms(
    sparse_dir: str,
    images_dir: str,
    out_path: str,
    aabb_scale: int = 16,
    keep_world: bool = False,
) -> dict:
    """COLMAP sparse model -> transforms.json."""
    camdata = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
    imdata = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    cam = camdata[min(camdata.keys())]
    meta = _camera_intrinsics(cam)
    meta["aabb_scale"] = aabb_scale

    frames = []
    for k in sorted(imdata.keys(), key=lambda k: imdata[k].name):
        im = imdata[k]
        R = im.qvec2rotmat()
        t = im.tvec.reshape(3, 1)
        w2c = np.concatenate(
            [np.concatenate([R, t], 1), [[0, 0, 0, 1]]], 0
        )
        c2w = np.linalg.inv(w2c)
        if not keep_world:
            # [right down front] -> nerf's [right up back] (flip y/z)
            c2w[0:3, 1] *= -1
            c2w[0:3, 2] *= -1
        img_path = os.path.join(images_dir, im.name)
        frame = {
            "file_path": os.path.relpath(
                img_path, os.path.dirname(out_path)
            ),
            "transform_matrix": c2w,
        }
        if os.path.exists(img_path):
            try:
                frame["sharpness"] = sharpness(img_path)
            except Exception:
                pass
        frames.append(frame)

    if not keep_world and frames:
        # recenter on the camera centroid and normalize scale
        centers = np.stack(
            [f["transform_matrix"][0:3, 3] for f in frames]
        )
        centroid = centers.mean(0)
        for f in frames:
            f["transform_matrix"][0:3, 3] -= centroid
        avglen = np.mean(
            np.linalg.norm(
                [f["transform_matrix"][0:3, 3] for f in frames], axis=-1
            )
        )
        scale = 4.0 / max(avglen, 1e-9)
        for f in frames:
            f["transform_matrix"][0:3, 3] *= scale

    meta["frames"] = [
        {**f, "transform_matrix": f["transform_matrix"].tolist()}
        for f in frames
    ]
    with open(out_path, "w") as fh:
        json.dump(meta, fh, indent=2)
    return meta


def video_to_dataset(
    video_path: str,
    out_dir: str,
    fps: float = 2.0,
    time_slice: Optional[str] = None,
    matcher: str = "sequential",
) -> str:
    """Full pipeline: video -> frames -> COLMAP -> transforms.json."""
    images_dir = os.path.join(out_dir, "images")
    extract_frames(video_path, images_dir, fps=fps, time_slice=time_slice)
    sparse = run_colmap(images_dir, out_dir, matcher=matcher)
    out_path = os.path.join(out_dir, "transforms.json")
    colmap_to_transforms(sparse, images_dir, out_path)
    return out_path


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="video/images -> transforms.json (COLMAP pipeline)"
    )
    ap.add_argument("--video", type=str, default=None)
    ap.add_argument("--images", type=str, default=None)
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--video_fps", type=float, default=2.0)
    ap.add_argument("--time_slice", type=str, default=None)
    ap.add_argument(
        "--matcher", choices=["sequential", "exhaustive"],
        default="sequential",
    )
    ap.add_argument("--aabb_scale", type=int, default=16)
    args = ap.parse_args(argv)

    if args.video:
        video_to_dataset(
            args.video, args.out_dir, fps=args.video_fps,
            time_slice=args.time_slice, matcher=args.matcher,
        )
    elif args.images:
        sparse = run_colmap(args.images, args.out_dir, matcher=args.matcher)
        colmap_to_transforms(
            sparse,
            args.images,
            os.path.join(args.out_dir, "transforms.json"),
            aabb_scale=args.aabb_scale,
        )
    else:
        ap.error("one of --video / --images is required")


if __name__ == "__main__":
    main()
