"""Dense multi-resolution feature pyramid — the shear-warp renderer's field.

Port of the JAX package's ``models/pyramid.py``.  Parameters are a plain
dict ``{"levels": [(r, r, r, F_l) tensors], "rgb_mlp": {"w0": ...}}`` with
the JAX layouts: level grids are indexed ``[x, y, z]`` with channels last,
MLP weights are stored ``(in, out)``.  ``bake`` fuses the levels into one
``(R, R, R, F)`` grid whose channel 0 is sigma (TruncExp of the capped
logit) and whose other channels feed the rgb MLP.  A split-resolution
config (``sigma_res``) also has ``params["sigma_level"]``, a single-channel
density level at twice the finest resolution, and bakes to the pair
``(sigma (Rs, Rs, Rs), feats (R, R, R, F-1))``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..ops.sh import sh_encode
from .mlp import MLPSpec, apply_mlp, init_mlp
from .ngp import trunc_exp

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    resolutions: Tuple[int, ...] = (32, 64, 128, 256)
    features: int = 8  # channel 0 = density logit
    rgb_width: int = 64
    rgb_depth: int = 2
    scale: float = 0.5
    # density-logit init bias: start mostly transparent (sigma ~ e^bias)
    sigma_bias: float = -2.0
    # composite features along the ray and shade once per pixel
    deferred: bool = False
    # extra single-channel density level at 2x the finest resolution
    sigma_res: int = 0
    # per-level channel widths (default: `features` everywhere);
    # non-increasing, starting at `features`
    level_features: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.sigma_res and self.sigma_res != 2 * self.resolutions[-1]:
            raise ValueError(
                "sigma_res must be 2x the finest feature level "
                f"(got {self.sigma_res} vs {self.resolutions[-1]})"
            )
        if self.level_features:
            lf = self.level_features
            if len(lf) != len(self.resolutions):
                raise ValueError((lf, self.resolutions))
            if lf[0] != self.features:
                raise ValueError(lf)
            if not all(1 <= b <= a for a, b in zip(lf, lf[1:])):
                raise ValueError(
                    f"level_features must be non-increasing: {lf}"
                )

    def feat_of(self, lv: int) -> int:
        return (
            self.level_features[lv] if self.level_features else self.features
        )

    @property
    def grid_res(self) -> int:
        """Finest *feature* resolution (the slab-sweep granularity)."""
        return self.resolutions[-1]

    @property
    def split(self) -> bool:
        return bool(self.sigma_res)


def truncate(cfg: PyramidConfig, n_levels: int) -> PyramidConfig:
    """Config with only the first ``n_levels`` pyramid levels."""
    if not 1 <= n_levels <= len(cfg.resolutions):
        raise ValueError(n_levels)
    if cfg.split:
        raise ValueError("progressive training requires sigma_res=0")
    return dataclasses.replace(
        cfg,
        resolutions=cfg.resolutions[:n_levels],
        level_features=cfg.level_features[:n_levels],
    )


def rgb_mlp_spec(cfg: PyramidConfig) -> MLPSpec:
    return MLPSpec(
        input_dim=16 + (cfg.features - 1),
        output_dim=3,
        net_depth=cfg.rgb_depth,
        net_width=cfg.rgb_width,
        bias_enabled=False,
        output_activation="sigmoid",
    )


def init_pyramid_params(
    cfg: PyramidConfig,
    generator: torch.Generator | None = None,
    device=None,
) -> Params:
    """Random params: levels ~ 1e-2 N(0, 1), Xavier-uniform rgb MLP and,
    for a split config, ``sigma_level`` ~ 1e-2 N(0, 1).

    Drawn on the CPU from ``generator`` in that order (so a seed gives the
    same params on every device, and a split config the levels and MLP of
    the unsplit one), then moved to ``device``.
    """
    levels = []
    for lv, r in enumerate(cfg.resolutions):
        g = torch.randn(
            (r, r, r, cfg.feat_of(lv)), generator=generator,
            dtype=torch.float32,
        )
        levels.append((1e-2 * g).to(device))
    params = {
        "levels": levels,
        "rgb_mlp": init_mlp(rgb_mlp_spec(cfg), generator, device),
    }
    if cfg.split:
        rs = cfg.sigma_res
        g = torch.randn((rs, rs, rs), generator=generator,
                        dtype=torch.float32)
        params["sigma_level"] = (1e-2 * g).to(device)
    return params


def _upsample_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) trilinear-upsampling band matrix, pixel-center aligned
    with edge clamping (linear image-resize semantics)."""
    pos = (
        torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    ) * (n_in / n_out) - 0.5
    pos = torch.clamp(pos, 0.0, float(n_in - 1))
    m = torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
    return torch.clamp(1.0 - torch.abs(m - pos[None, :]), min=0.0)


def _upsample3(g: torch.Tensor, r_out: int) -> torch.Tensor:
    """Trilinear-upsample (r, r, r, F) -> (r_out, r_out, r_out, F) as three
    separable band-matrix products."""
    w = _upsample_matrix(g.shape[0], r_out, g.device).to(g.dtype)
    g = torch.einsum("xyzf,xu->uyzf", g, w)
    g = torch.einsum("xyzf,yu->xuzf", g, w)
    return torch.einsum("xyzf,zu->xyuf", g, w)


def bake(params: Params, cfg: PyramidConfig, dtype=torch.float32):
    """Fuse the pyramid into one (R, R, R, F) grid of ``dtype``.

    Levels accumulate progressively: the running sum is upsampled to each
    next level's resolution, then that level is added.  A lean level (fewer
    channels) adds into the leading channels only.  Channel 0 becomes
    ``trunc_exp(min(logit + sigma_bias, 11))``: the baked grid carries
    sigma, so the renderer's zero padding outside the scene is empty space.

    A split config returns ``(sigma (Rs, Rs, Rs), feats (R, R, R, F-1))``:
    the density logit is upsampled to ``Rs`` and refined by
    ``params["sigma_level"]`` before TruncExp.

    ``dtype=torch.bfloat16`` runs the whole chain in bf16, as the JAX
    ``bake`` does: the levels are cast, and the upsample matrices, the
    products, the adds, the cap and TruncExp are bf16, so the R^3 F buffers
    and their cotangents are half-width (what lets R=512 train).
    """
    R = cfg.grid_res
    out = None
    for g in params["levels"]:
        g = g.to(dtype)
        if out is not None and out.shape[0] != g.shape[0]:
            out = _upsample3(out, g.shape[0])
        if out is None:
            out = g
        elif g.shape[-1] < out.shape[-1]:
            n = g.shape[-1]
            out = torch.cat([out[..., :n] + g, out[..., n:]], dim=-1)
        else:
            out = out + g
    if out.shape[0] != R:
        out = _upsample3(out, R)
    # forward logit ceiling (TruncExp clamps only its backward)
    if cfg.split:
        logit = _upsample3(out[..., :1], cfg.sigma_res)[..., 0]
        logit = logit + params["sigma_level"].to(dtype)
        sigma = trunc_exp(torch.clamp(logit + cfg.sigma_bias, max=11.0))
        return sigma, out[..., 1:]
    sigma = trunc_exp(
        torch.clamp(out[..., 0] + cfg.sigma_bias, max=11.0)
    )
    return torch.cat([sigma[..., None], out[..., 1:]], dim=-1)


def density_from_grid(grid_slab: torch.Tensor) -> torch.Tensor:
    """Channel 0 of the baked grid is sigma already; clamp resample
    undershoot."""
    return torch.clamp(grid_slab[..., 0], min=0.0)


def rgb_from_features_enc(
    params: Params,
    cfg: PyramidConfig,
    feats: torch.Tensor,
    d_enc: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(..., F-1) features + precomputed (..., 16) SH encoding -> rgb."""
    rgb_in = torch.cat([d_enc, feats], dim=-1)
    return apply_mlp(
        params["rgb_mlp"], rgb_mlp_spec(cfg), rgb_in, compute_dtype
    ).float()


def rgb_from_features(
    params: Params,
    cfg: PyramidConfig,
    feats: torch.Tensor,
    dirs: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(..., F-1) features + (..., 3) unit dirs -> (..., 3) rgb."""
    d_enc = sh_encode((dirs + 1.0) / 2.0)
    return rgb_from_features_enc(params, cfg, feats, d_enc, compute_dtype)
