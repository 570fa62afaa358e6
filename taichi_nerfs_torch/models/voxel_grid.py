"""Dense SH voxel-grid radiance field (the "svox" model family).

Port of the JAX package's ``models/voxel_grid.py``: a dense grid of
per-cell SH coefficients (``sh_dim`` per RGB channel) and a density
scalar, queried by nearest-neighbour or trilinear interpolation, with
view-dependent colour from :func:`~taichi_nerfs_torch.ops.sh.eval_sh`.

The JAX module fixes three defects of the reference's ``VoxelGrid``, and
so does this one: ``forward`` runs (the reference's names undefined
variables), the trilinear query gathers all 8 corners (the reference
weights one cell 8 times), and the raw density goes through softplus, so
``1 - exp(-sigma * dt)`` stays in [0, 1).

The 8 corners are gathered by one ``index_select`` per field on the
flattened grid, whose backward is one scatter-add into the field's
gradient; :func:`density` (the occupancy refresh's query) gathers the
density field only.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.sh import eval_sh

Params = Dict[str, Any]


def _grid_min(cfg: ModelConfig) -> float:
    """Coordinate of cell (0, 0, 0): cells centred on the origin,
    ``voxel_radius`` apart."""
    return (0 - math.ceil(cfg.voxel_grid_size / 2) + 1) * cfg.voxel_radius


def sh_dim(cfg: ModelConfig) -> int:
    return (1 + cfg.voxel_sh_degree) ** 2


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> Params:
    """Constant fields (``voxel_origin_sh``, ``voxel_origin_sigma``);
    ``generator`` is not used."""
    g = cfg.voxel_grid_size
    return {
        "sh_fields": torch.full((g, g, g, sh_dim(cfg) * 3),
                                cfg.voxel_origin_sh, dtype=torch.float32,
                                device=device),
        "density_fields": torch.full((g, g, g, 1), cfg.voxel_origin_sigma,
                                     dtype=torch.float32, device=device),
    }


def _normalize(cfg: ModelConfig, pts: torch.Tensor) -> torch.Tensor:
    """World points -> fractional grid indices."""
    return (pts - _grid_min(cfg)) / cfg.voxel_radius


def _gather_cell(params: Params, idx: torch.Tensor, in_grid: torch.Tensor,
                 want_sh: bool = True):
    """Cells ``idx`` (..., 3), clipped into the grid, of both fields (the
    SH field only if ``want_sh``); the cells outside (``in_grid`` false)
    gated to zero."""
    dens_f = params["density_fields"]
    g = dens_f.shape[0]
    idx = idx.clamp(0, g - 1)
    rows = ((idx[..., 0] * g + idx[..., 1]) * g + idx[..., 2]).reshape(-1)
    gate = in_grid.to(dens_f.dtype)
    dens = dens_f.reshape(g**3).index_select(0, rows).view(idx.shape[:-1])
    sh = None
    if want_sh:
        sh_f = params["sh_fields"]
        sh = sh_f.reshape(g**3, -1).index_select(0, rows)
        sh = sh.view(*idx.shape[:-1], sh_f.shape[-1]) * gate[..., None]
    return sh, dens * gate


def _query(params: Params, cfg: ModelConfig, pts: torch.Tensor,
           use_trilinear: bool, want_sh: bool):
    g = params["density_fields"].shape[0]
    fidx = _normalize(cfg, pts)
    if not use_trilinear:
        # torch.round rounds half to even, as jnp.round does
        nidx = torch.round(fidx).to(torch.int64)
        in_grid = ((nidx >= 0) & (nidx < g)).all(dim=-1)
        return _gather_cell(params, nidx, in_grid, want_sh)

    base = torch.floor(fidx)
    frac = fidx - base
    base = base.to(torch.int64)
    # corner c's offset along axis d is bit d of c
    offs = (torch.arange(8, device=pts.device)[:, None]
            >> torch.arange(3, device=pts.device)) & 1
    cidx = base[None] + offs.view(8, *([1] * (pts.dim() - 1)), 3)
    in_grid = ((cidx >= 0) & (cidx < g)).all(dim=-1)
    # the 8 corners in one gather per field: (8, ...) leading
    sh_c, dens_c = _gather_cell(params, cidx, in_grid, want_sh)
    sh_acc = dens_acc = None
    for corner in range(8):
        w = None
        for d in range(3):
            f = frac[..., d] if (corner >> d) & 1 else 1.0 - frac[..., d]
            w = f if w is None else w * f
        dens_t = w * dens_c[corner]
        dens_acc = dens_t if dens_acc is None else dens_acc + dens_t
        if want_sh:
            sh_t = w[..., None] * sh_c[corner]
            sh_acc = sh_t if sh_acc is None else sh_acc + sh_t
    return sh_acc, dens_acc


def query_grids(params: Params, cfg: ModelConfig, pts: torch.Tensor,
                use_trilinear: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sh (..., 3 * sh_dim), density (...,)) at world points (..., 3)."""
    return _query(params, cfg, pts, use_trilinear, want_sh=True)


def density(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    """softplus density at world points (the SH field is not read)."""
    _, dens = _query(params, cfg, x, True, want_sh=False)
    return F.softplus(dens)


def forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
            d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions (..., 3) and view directions (..., 3, any length) ->
    sigmas (...,) and rgbs (..., 3)."""
    sh, dens = query_grids(params, cfg, x)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    dim = sh_dim(cfg)
    rgb = torch.stack(
        [eval_sh(cfg.voxel_sh_degree, sh[..., i * dim:(i + 1) * dim], d)
         for i in range(3)],
        dim=-1,
    )
    # SH -> [0, 1] colour (PlenOctree convention: + 0.5, clamp)
    rgb = torch.clamp(rgb + 0.5, 0.0, 1.0)
    return F.softplus(dens), rgb
