"""Dense multi-resolution feature pyramid — the shear-warp renderer's field.

Port of the JAX package's ``models/pyramid.py``.  Parameters are a plain
dict ``{"levels": [(r, r, r, F_l) tensors], "rgb_mlp": {"w0": ...}}`` with
the JAX layouts: level grids are indexed ``[x, y, z]`` with channels last,
MLP weights are stored ``(in, out)``.  ``bake`` fuses the levels into one
``(R, R, R, F)`` grid whose channel 0 is sigma (TruncExp of the capped
logit) and whose other channels feed the rgb MLP.

The split-resolution density level (``sigma_res``) is not ported yet:
configs with it raise ``NotImplementedError`` (ROADMAP, "Modules to port",
item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..ops.sh import sh_encode
from .mlp import MLPSpec, apply_mlp, init_mlp
from .ngp import trunc_exp

Params = Dict[str, Any]

_SPLIT_TODO = (
    "split-resolution density (sigma_res) is not ported yet; see ROADMAP "
    "'Modules to port' item 10"
)


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
    """Random params: levels ~ 1e-2 N(0, 1), Xavier-uniform rgb MLP.

    Drawn on the CPU from ``generator`` (so a seed gives the same params on
    every device), then moved to ``device``.
    """
    if cfg.split:
        raise NotImplementedError(_SPLIT_TODO)
    levels = []
    for lv, r in enumerate(cfg.resolutions):
        g = torch.randn(
            (r, r, r, cfg.feat_of(lv)), generator=generator,
            dtype=torch.float32,
        )
        levels.append((1e-2 * g).to(device))
    return {
        "levels": levels,
        "rgb_mlp": init_mlp(rgb_mlp_spec(cfg), generator, device),
    }


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


def bake(params: Params, cfg: PyramidConfig) -> torch.Tensor:
    """Fuse the pyramid into one fp32 (R, R, R, F) grid.

    Levels accumulate progressively: the running sum is upsampled to each
    next level's resolution, then that level is added.  A lean level (fewer
    channels) adds into the leading channels only.  Channel 0 becomes
    ``trunc_exp(min(logit + sigma_bias, 11))``: the baked grid carries
    sigma, so the renderer's zero padding outside the scene is empty space.
    """
    if cfg.split:
        raise NotImplementedError(_SPLIT_TODO)
    R = cfg.grid_res
    out = None
    for g in params["levels"]:
        g = g.float()
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
