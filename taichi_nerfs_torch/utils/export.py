"""Deployment export: the ``deployment.npy`` dict and the tagged binary
weight files of the native runner (``native/``).

Port of the JAX package's ``utils/export.py``.  The inputs are the port's
tensors (params, the int32 occupancy bitfield, a pyramid config); the
outputs are numpy arrays and files, byte for byte what the JAX package
writes for the same params, so ``native/`` reads them unchanged:

* ``deployment.npy``: a pickled dict of the poses, the density bitfield
  (uint8 layout), the flat hash table, the per-level scale and the flat MLP
  weights in torch layout (out, in), the rgb output matrix zero-padded to
  a square;
* per-tensor ``.bin`` files: an ``int32(dtype_tag) int32(count)`` header,
  then the raw little-endian buffer.  Tags: 0 f32, 1 f16, 2 i32, 3 i16,
  4 u32, 5 u16;
* ``config.json``: the constants the runner needs.

``deployment_dict`` is defined for the hash encoder only (it ships the hash
table); the train entry refuses ``--deployment`` with another encoder
before it trains.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.hash_encoder import build_layout
from ..ops.math import bitfield_to_u8

DTYPE_TAGS = {
    np.dtype(np.float32): 0,
    np.dtype(np.float16): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int16): 3,
    np.dtype(np.uint32): 4,
    np.dtype(np.uint16): 5,
}


def _np32(x) -> np.ndarray:
    """A tensor or array as an fp32 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _torch_layout(w: np.ndarray) -> np.ndarray:
    """Linear weights are stored (in, out); the export is torch's
    (out, in)."""
    return np.ascontiguousarray(w.T)


def check_deployable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``deployment_dict`` can export a model
    of ``cfg``: the NGP family with the hash encoder."""
    if cfg.name != "ngp" or cfg.pos_encoder_type != "hash":
        raise ValueError(
            "the deployment export ships the hash table: train "
            f"--model_name ngp with --encoder_type hash (got --model_name "
            f"{cfg.name}, --encoder_type {cfg.pos_encoder_type})")


def deployment_dict(params, cfg: ModelConfig, occupancy_bitfield,
                    poses) -> Dict[str, np.ndarray]:
    """The ``deployment.npy`` payload."""
    check_deployable(cfg)
    layout = build_layout(cfg.grid)
    xyz_w = [_torch_layout(_np32(params["xyz_mlp"][f"w{i}"]))
             for i in range(cfg.xyz_net_depth + 1)]
    rgb_w = [_torch_layout(_np32(params["rgb_mlp"][f"w{i}"]))
             for i in range(cfg.rgb_net_depth + 1)]
    # square-pad the rgb output matrix (3, W) -> (W, W) with zero rows
    out = rgb_w[-1]
    pad = np.zeros((out.shape[1] - out.shape[0], out.shape[1]), np.float32)
    rgb_w[-1] = np.concatenate([out, pad], axis=0)

    return {
        "poses": _np32(poses),
        "model.density_bitfield": bitfield_to_u8(
            torch.as_tensor(occupancy_bitfield)).cpu().numpy(),
        # the table is (F, n_entries); the reference interleaves features
        # per entry -> transpose before flattening
        "model.hash_encoder.params": np.ascontiguousarray(
            _np32(params["hash_table"]).T).reshape(-1),
        "model.per_level_scale": np.float32(layout.log_b),
        "model.xyz_encoder.params": np.concatenate(
            [w.reshape(-1) for w in xyz_w]),
        "model.rgb_net.params": np.concatenate(
            [w.reshape(-1) for w in rgb_w]),
    }


def params_from_deployment(dep: Dict[str, np.ndarray], cfg: ModelConfig,
                           device=None):
    """The inverse of :func:`deployment_dict`: the NGP params (fp32
    tensors on ``device``) of a ``deployment.npy`` payload."""
    from ..models.ngp import rgb_mlp_spec, xyz_mlp_spec

    def weights(flat, spec, square_out=False):
        out, k = {}, 0
        dims = spec.layer_dims()
        for i, (fi, fo) in enumerate(dims):
            # the rgb output matrix was zero-padded to (in, in)
            rows = fi if square_out and i == len(dims) - 1 else fo
            w = flat[k:k + rows * fi].reshape(rows, fi)[:fo]
            out[f"w{i}"] = torch.tensor(w.T.copy(), device=device)
            k += rows * fi
        if k != flat.size:
            raise ValueError(f"{flat.size} weights, the model takes {k}")
        return out

    F = cfg.grid.feature_per_level
    table = dep["model.hash_encoder.params"].reshape(-1, F).T
    return {
        "hash_table": torch.tensor(np.ascontiguousarray(table),
                                   device=device),
        "xyz_mlp": weights(dep["model.xyz_encoder.params"],
                           xyz_mlp_spec(cfg)),
        "rgb_mlp": weights(dep["model.rgb_net.params"], rgb_mlp_spec(cfg),
                           square_out=True),
    }


def save_deployment_model(params, cfg: ModelConfig, occupancy_bitfield,
                          poses, save_dir: str) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "deployment.npy")
    np.save(path, deployment_dict(params, cfg, occupancy_bitfield, poses))
    return path


def save_tagged_binary(path: str, arr: np.ndarray):
    """Write one array in the tagged ``.bin`` format."""
    arr = np.ascontiguousarray(arr)
    tag = DTYPE_TAGS.get(arr.dtype)
    if tag is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    header = np.array([tag, arr.size], np.int32)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(arr.reshape(-1).tobytes())


def load_tagged_binary(path: str) -> np.ndarray:
    """Read the tagged ``.bin`` format (inverse of
    :func:`save_tagged_binary`)."""
    inv = {v: k for k, v in DTYPE_TAGS.items()}
    with open(path, "rb") as f:
        tag, count = np.frombuffer(f.read(8), np.int32)
        data = np.frombuffer(f.read(), inv[int(tag)])
    if data.size != count:
        raise ValueError(f"{path}: {data.size} values, the header says "
                         f"{count}")
    return data


def export_native(params, cfg: ModelConfig, occupancy_bitfield, poses, K,
                  img_wh, out_dir: str, render_cfg=None,
                  pose_index: int = 20) -> str:
    """The native runner's export: the tagged ``.bin`` weights and
    ``config.json``."""
    dep = deployment_dict(params, cfg, occupancy_bitfield, poses)
    export_aot_weights(dep, out_dir, pose_index=pose_index)
    layout = build_layout(cfg.grid)
    w, h = img_wh
    K = np.asarray(K, np.float32)
    config = {
        "width": int(w),
        "height": int(h),
        "fx": float(K[0, 0]),
        "fy": float(K[1, 1]),
        "cx": float(K[0, 2]),
        "cy": float(K[1, 2]),
        "scale": float(cfg.scale),
        "grid_size": int(cfg.grid_size),
        "cascades": int(cfg.cascades),
        "levels": int(cfg.grid.levels),
        "feat_per_level": int(cfg.grid.feature_per_level),
        "log2_T": int(cfg.grid.log2_T),
        "base_res": float(cfg.grid.base_res),
        "log_b": float(layout.log_b),
        "xyz_width": int(cfg.xyz_net_width),
        "xyz_out": int(cfg.xyz_net_out_dim),
        "rgb_width": int(cfg.rgb_net_width),
        # hidden depth of the rgb chain: 2 in the default model, 1 in the
        # deployment model
        "rgb_depth": int(cfg.rgb_net_depth),
        "exp_step_factor": float(getattr(render_cfg, "exp_step_factor",
                                         0.0)),
        # the mobile runner's transmittance threshold
        "t_threshold": float(getattr(render_cfg, "t_threshold", 1e-2)),
        "max_samples": int(getattr(render_cfg, "max_samples", 1024)),
        "white_bg": bool(getattr(render_cfg, "white_bg", True)),
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return out_dir


def export_aot_weights(deployment: Dict[str, np.ndarray], out_dir: str,
                       pose_index: int = 20,
                       directions: np.ndarray | None = None):
    """Write the per-tensor ``.bin`` files of a :func:`deployment_dict`."""
    os.makedirs(out_dir, exist_ok=True)
    for name, key in (("hash_embedding", "model.hash_encoder.params"),
                      ("sigma_weights", "model.xyz_encoder.params"),
                      ("rgb_weights", "model.rgb_net.params")):
        save_tagged_binary(os.path.join(out_dir, f"{name}.bin"),
                           deployment[key].astype(np.float32))
    save_tagged_binary(
        os.path.join(out_dir, "density_bitfield.bin"),
        deployment["model.density_bitfield"].view(np.uint32),
    )
    poses = deployment["poses"]
    pose_index = min(pose_index, len(poses) - 1)
    save_tagged_binary(os.path.join(out_dir, "pose.bin"),
                       poses[pose_index].astype(np.float32).reshape(3, 4))
    if directions is not None:
        save_tagged_binary(os.path.join(out_dir, "directions.bin"),
                           directions.astype(np.float32))


def export_pyramid_native(params, pyramid_cfg, pose, K, img_wh,
                          out_dir: str, white_bg: bool = True,
                          t_threshold: float = 1e-2,
                          grid_dtype=np.float16) -> str:
    """Native export of the dense pyramid: the baked grid (the whole field,
    fp16 by default, cast where the params live), the rgb MLP and the
    camera, read by ``native/src/pyramid_model.cpp``."""
    from ..models import pyramid as pyr

    if pyramid_cfg.split:
        raise NotImplementedError(
            "native export of split-resolution grids: bake to a single "
            "grid (sigma_res=0) for deployment")
    if not pyramid_cfg.deferred:
        raise NotImplementedError(
            "the native pyramid renderer shades deferred; train with "
            "deferred=True (the default) for deployment")
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        grid = pyr.bake(params, pyramid_cfg)
        grid = grid.to(torch.from_numpy(np.zeros(0, grid_dtype)).dtype)
    save_tagged_binary(os.path.join(out_dir, "grid.bin"), grid.cpu().numpy())
    for i in range(3):
        save_tagged_binary(os.path.join(out_dir, f"rgb_w{i}.bin"),
                           _torch_layout(_np32(params["rgb_mlp"][f"w{i}"])))
    save_tagged_binary(os.path.join(out_dir, "pose.bin"),
                       np.asarray(pose, np.float32).reshape(3, 4))
    K = np.asarray(K, np.float32)
    w_img, h_img = img_wh
    config = {
        "model": "pyramid",
        "width": int(w_img),
        "height": int(h_img),
        "fx": float(K[0, 0]),
        "fy": float(K[1, 1]),
        "cx": float(K[0, 2]),
        "cy": float(K[1, 2]),
        "scale": float(pyramid_cfg.scale),
        "grid_res": int(pyramid_cfg.grid_res),
        "features": int(pyramid_cfg.features),
        "rgb_width": int(pyramid_cfg.rgb_width),
        "deferred": True,
        "white_bg": bool(white_bg),
        "t_threshold": float(t_threshold),
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return out_dir
