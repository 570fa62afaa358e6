"""Instant-NGP radiance field on a plain dict of parameters.

Port of the JAX package's ``models/ngp.py``: position encoder (hash grid,
brick grid or tri-plane) -> 1-hidden-layer xyz MLP (TruncExp on channel 0
gives sigma) -> SH-16 direction encoding -> 2-hidden-layer rgb MLP with
sigmoid.  The MLPs take their operands in ``cfg.mlp_dtype`` (bf16 by
default, on every device) and accumulate in fp32 (``models/mlp.py``).

Params: ``{"hash_table": (F, n)}``, ``{"brick": {"corners", "bricks"}}``
or ``{"triplane_table": (3, max_res**2, F)}``, plus ``"xyz_mlp"`` and
``"rgb_mlp"`` weight dicts.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..config import ModelConfig
from ..ops.brick_encoder import (
    brick_encode,
    build_brick_layout,
    init_brick_params,
)
from ..ops.hash_encoder import build_layout, hash_encode, init_hash_table
from ..ops.sh import sh_encode
from ..ops.triplane import init_triplane_table, triplane_encode
from ..utils import profiling
from .mlp import MLPSpec, apply_mlp, init_mlp

Params = Dict[str, Any]


class _TruncExp(torch.autograd.Function):
    """exp whose backward clamps its input to [-15, 15]."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def xyz_mlp_spec(cfg: ModelConfig) -> MLPSpec:
    return MLPSpec(
        input_dim=cfg.pos_out_dim,
        output_dim=cfg.xyz_net_out_dim,
        net_depth=cfg.xyz_net_depth,
        net_width=cfg.xyz_net_width,
        bias_enabled=False,
    )


def rgb_mlp_spec(cfg: ModelConfig) -> MLPSpec:
    return MLPSpec(
        input_dim=16 + cfg.xyz_net_out_dim,
        output_dim=3,
        net_depth=cfg.rgb_net_depth,
        net_width=cfg.rgb_net_width,
        bias_enabled=False,
        output_activation="sigmoid",
    )


def init_ngp_params(cfg: ModelConfig,
                    generator: torch.Generator | None = None,
                    device=None) -> Params:
    """Encoder table U[0, 1), Xavier-uniform MLPs, all fp32."""
    params: Params = {}
    if cfg.pos_encoder_type == "hash":
        params["hash_table"] = init_hash_table(build_layout(cfg.grid),
                                               generator, device)
    elif cfg.pos_encoder_type == "brick":
        params["brick"] = init_brick_params(build_brick_layout(cfg.brick),
                                            generator, device)
    elif cfg.pos_encoder_type == "triplane":
        params["triplane_table"] = init_triplane_table(cfg.triplane,
                                                       generator, device)
    else:
        raise NotImplementedError(cfg.pos_encoder_type)
    params["xyz_mlp"] = init_mlp(xyz_mlp_spec(cfg), generator, device)
    params["rgb_mlp"] = init_mlp(rgb_mlp_spec(cfg), generator, device)
    return params


def _encode_position(params: Params, cfg: ModelConfig, x01: torch.Tensor):
    """The position encoding, inside the span ``ngp.encode`` (the encoders'
    backwards open it again on the thread that runs them)."""
    with profiling.span("ngp.encode"):
        return _encode(params, cfg, x01)


def _encode(params: Params, cfg: ModelConfig, x01: torch.Tensor):
    if cfg.pos_encoder_type == "hash":
        table = params["hash_table"]
        if cfg.grid.table_dtype == "bfloat16":
            # bf16 gather, fp32 master params: the cast's gradient is the
            # bf16 table gradient widened to fp32
            table = table.to(torch.bfloat16)
        return hash_encode(table, x01, build_layout(cfg.grid))
    if cfg.pos_encoder_type == "brick":
        # the bf16 cast happens inside the encoder's autograd Function
        return brick_encode(params["brick"], x01,
                            build_brick_layout(cfg.brick))
    return triplane_encode(params["triplane_table"], x01, cfg.triplane)


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.mlp_dtype == "bfloat16" else torch.float32


def density(params: Params, cfg: ModelConfig, x: torch.Tensor,
            return_feat: bool = False):
    """Positions (..., 3) in [-scale, scale] -> sigmas (...,) and, with
    ``return_feat``, the (..., 16) geometry feature."""
    x01 = (x + cfg.scale) / (2.0 * cfg.scale)
    emb = _encode_position(params, cfg, x01)
    h = apply_mlp(params["xyz_mlp"], xyz_mlp_spec(cfg), emb,
                  _compute_dtype(cfg))
    sigmas = trunc_exp(h[..., 0].float())
    if return_feat:
        return sigmas, h
    return sigmas


def forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
            d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions (..., 3) and view directions (..., 3, any length) ->
    sigmas (...,) and rgbs (..., 3)."""
    sigmas, h = density(params, cfg, x, return_feat=True)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d_enc = sh_encode((d + 1.0) / 2.0)
    rgbs = apply_mlp(params["rgb_mlp"], rgb_mlp_spec(cfg),
                     torch.cat([d_enc, h], dim=-1), _compute_dtype(cfg))
    return sigmas, rgbs.float()
