"""Occupancy (density) grid: camera-visibility marking, the EMA density
refresh and the bitfield repack.

Port of the JAX package's ``models/occupancy.py`` on one device.  The grid
is ``cascades x G^3`` morton-indexed cells; the bitfield is int32 words
with the JAX uint32 words' bits (``ops/math.py``).

Randomness.  The refresh's draws are inputs (:class:`GridDraws`, one per
cascade): the uniform cells, the keys that pick occupied cells and the
jitter.  :func:`draw_grid_inputs` makes them from a ``torch.Generator``; a
test passes the JAX package's own draws.

Ties.  The sparse refresh picks ``G^3/4`` occupied cells as the top
``G^3/4`` of random keys, with unoccupied cells keyed -1.  With fewer
occupied cells than that, the -1 keys tie, and which tied cells are picked
changes the refreshed grid.  ``lax.top_k`` puts lower indices first among
ties; ``torch.topk`` promises no order, so the port selects with a stable
descending sort, which does.

TF32.  The camera projection of :func:`mark_invisible_cells` is elementwise
fp32: a TF32-rounded ``uv`` flips cells at the image edge.

Multi-device refreshes.  With ``cell_shard=(idx, n)`` a rank probes only
its ``idx``-th 1/n of each cascade's cells (drawn, with their jitter, at
full size from the draws every rank shares), and ``tmp_reduce`` (the max
over the ranks) merges the probe grids before the EMA, so n ranks give the
one-device refresh (``parallel/shard.py``).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import NEAR_DISTANCE, ModelConfig
from ..ops.math import (
    grid_coords_np,
    morton3d,
    morton3d_invert,
    morton3d_np,
    packbits_u32,
)


class OccupancyGrid(NamedTuple):
    density_grid: torch.Tensor  # (cascades, G^3) f32, morton-indexed
    count_grid: torch.Tensor  # (cascades, G^3) f32 camera-coverage share
    bitfield: torch.Tensor  # (cascades * G^3 // 32,) int32 words


class GridDraws(NamedTuple):
    """One cascade's random inputs to :func:`update_density_grid`.
    ``coords1`` (G^3/4, 3) int and ``keys`` (G^3,) U[0, 1) are None on the
    warmup path; ``noise`` is U[-1, 1) of the probed positions' shape."""

    coords1: Optional[torch.Tensor]
    keys: Optional[torch.Tensor]
    noise: torch.Tensor


def init_occupancy(cfg: ModelConfig, device=None) -> OccupancyGrid:
    c, g3 = cfg.cascades, cfg.grid_size**3
    return OccupancyGrid(
        density_grid=torch.zeros((c, g3), device=device),
        count_grid=torch.zeros((c, g3), device=device),
        bitfield=torch.zeros((c * g3 // 32,), dtype=torch.int32,
                             device=device),
    )


def all_cells(grid_size: int, device=None):
    """(coords (G^3, 3) int32, morton indices (G^3,) int64) of every
    cell, x fastest."""
    coords = grid_coords_np(grid_size)
    return (torch.as_tensor(coords, device=device),
            torch.as_tensor(morton3d_np(coords), device=device).long())


def _cascade_scale(c: int, scale: float) -> float:
    # cascade c covers [-2^(c-1), 2^(c-1)]^3, cut at the scene's scale
    return min(2.0 ** (c - 1), scale)


def _project(w2c_r, w2c_t, K, xyzs_w):
    """World points (M, 3) -> camera (N, M, 3) and ``(u v d)`` (N, M, 3),
    as elementwise fp32 sums (no TF32)."""
    xyzs_c = torch.sum(w2c_r[:, None] * xyzs_w[None, :, None, :], dim=-1)
    xyzs_c = xyzs_c + w2c_t[:, None, :]
    uvd = torch.sum(K * xyzs_c[..., None, :], dim=-1)
    return xyzs_c, uvd


def mark_invisible_cells(
    cfg: ModelConfig,
    K,
    poses,
    img_wh,
    chunk: int = 32**3,
    device=None,
) -> OccupancyGrid:
    """Density -1 for cells no camera sees (or that lie too near one),
    0 elsewhere; ``count_grid`` the share of cameras that see each cell.

    ``K`` (3, 3), ``poses`` (N_cams, 3, 4) camera-to-world, ``img_wh``
    (W, H)."""
    g = cfg.grid_size
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)
    poses = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    n_cams = poses.shape[0]
    w2c_r = poses[:, :3, :3].transpose(1, 2)  # (N, 3, 3)
    w2c_t = -torch.sum(w2c_r * poses[:, None, :3, 3], dim=-1)  # (N, 3)
    coords, indices = all_cells(g, device)
    xyzs = coords.float() / (g - 1) * 2.0 - 1.0
    n = xyzs.shape[0]
    density_grid, count_grid = [], []
    for c in range(cfg.cascades):
        s = _cascade_scale(c, cfg.scale)
        half_grid_size = s / g
        count_c = torch.empty(n, device=device)
        dens_c = torch.empty(n, device=device)
        for i in range(0, n, chunk):
            xyzs_w = xyzs[i : i + chunk] * (s - half_grid_size)
            _, uvd = _project(w2c_r, w2c_t, K, xyzs_w)
            d = uvd[..., 2]
            uv = uvd[..., :2] / d[..., None]
            in_image = ((d >= 0) & (uv[..., 0] >= 0) & (uv[..., 0] < img_wh[0])
                        & (uv[..., 1] >= 0) & (uv[..., 1] < img_wh[1]))
            covered = (d >= NEAR_DISTANCE) & in_image
            # times the reciprocal, as XLA rewrites the JAX code's
            # division by a constant: the same bits
            count = torch.sum(covered, dim=0) * (1.0 / n_cams)
            too_near = torch.any((d < NEAR_DISTANCE) & in_image, dim=0)
            valid = (count > 0) & ~too_near
            count_c[i : i + chunk] = count
            dens_c[i : i + chunk] = torch.where(valid, 0.0, -1.0)
        # into morton order
        count_grid.append(torch.zeros(g**3, device=device).index_copy_(
            0, indices, count_c))
        density_grid.append(torch.zeros(g**3, device=device).index_copy_(
            0, indices, dens_c))
    return OccupancyGrid(
        density_grid=torch.stack(density_grid),
        count_grid=torch.stack(count_grid),
        bitfield=torch.zeros((cfg.cascades * g**3 // 32,),
                             dtype=torch.int32, device=device),
    )


def draw_grid_inputs(cfg: ModelConfig, warmup: bool,
                     generator: torch.Generator | None = None,
                     device=None) -> List[GridDraws]:
    """The refresh's random inputs, one :class:`GridDraws` per cascade."""
    g = cfg.grid_size
    g3 = g**3
    out = []
    for _ in range(cfg.cascades):
        if warmup:
            out.append(GridDraws(None, None, 2.0 * torch.rand(
                (g3, 3), generator=generator, device=device) - 1.0))
            continue
        m = g3 // 4
        coords1 = torch.randint(0, g, (m, 3), generator=generator,
                                device=device, dtype=torch.int32)
        keys = torch.rand((g3,), generator=generator, device=device)
        noise = 2.0 * torch.rand((2 * m, 3), generator=generator,
                                 device=device) - 1.0
        out.append(GridDraws(coords1, keys, noise))
    return out


@torch.no_grad()
def update_density_grid(
    params,
    cfg: ModelConfig,
    density_fn: Callable,
    grid: OccupancyGrid,
    draws: List[GridDraws],
    density_threshold: float,
    warmup: bool,
    decay: float = 0.95,
    erode: bool = False,
    chunk: int = 4 * 1024 * 1024,
    cells=None,
    cell_shard: tuple[int, int] | None = None,
    tmp_reduce: Callable | None = None,
) -> OccupancyGrid:
    """EMA density refresh and bitfield repack.

    ``warmup``: probe every cell (``cells``, from :func:`all_cells`, made
    here when None); else ``G^3/4`` uniform cells plus ``G^3/4`` occupied
    cells picked by the top keys.  The probe max-merges into the decayed
    grid; cells marked -1 (invisible) stay so.

    ``cell_shard=(idx, n)`` probes only the ``idx``-th 1/n slice of each
    cascade's cells (their count must divide by n); ``tmp_reduce`` is
    applied to the probe grid before the merge (the max over the ranks).
    """
    g = cfg.grid_size
    g3 = g**3
    dev = grid.density_grid.device
    tmp = torch.zeros_like(grid.density_grid)
    for c in range(cfg.cascades):
        dr = draws[c]
        if warmup:
            coords, indices = cells if cells is not None else all_cells(g,
                                                                        dev)
        else:
            m = g3 // 4
            coords1 = dr.coords1.to(torch.int32)
            indices1 = morton3d(coords1).long()
            occ_mask = grid.density_grid[c] > density_threshold
            keys = torch.where(occ_mask, dr.keys, -1.0)
            # stable: among tied keys the lower cell index comes first, as
            # in lax.top_k
            _, order = torch.sort(keys, descending=True, stable=True)
            sampled = order[:m]
            indices2 = torch.where(torch.any(occ_mask), sampled, indices1)
            coords2 = morton3d_invert(indices2)
            indices = torch.cat([indices1, indices2])
            coords = torch.cat([coords1, coords2])
        s = _cascade_scale(c, cfg.scale)
        half_grid_size = s / g
        xyzs_w = (coords.float() / (g - 1) * 2.0 - 1.0) * (s - half_grid_size)
        # the jitter is drawn at full size: every shard sees the per-cell
        # perturbation of the one-device refresh
        xyzs_w = xyzs_w + dr.noise * half_grid_size
        if cell_shard is not None:
            idx, n_shards = cell_shard
            n_cells = xyzs_w.shape[0]
            if n_cells % n_shards:
                raise ValueError(f"{n_cells} cells not divisible by "
                                 f"{n_shards} shards")
            k = n_cells // n_shards
            xyzs_w = xyzs_w[idx * k:(idx + 1) * k]
            indices = indices[idx * k:(idx + 1) * k]
        sigmas = torch.cat([
            density_fn(params, cfg, xyzs_w[i : i + chunk])
            for i in range(0, xyzs_w.shape[0], chunk)
        ])
        tmp[c].scatter_reduce_(0, indices, sigmas, reduce="amax")
    if tmp_reduce is not None:
        tmp = tmp_reduce(tmp)

    if erode:
        # decay more the cells seen by few cameras
        decay_arr = torch.clamp(
            decay ** (1.0 / torch.clamp(grid.count_grid, min=1e-6)), 0.1, 0.95)
    else:
        decay_arr = decay
    density_grid = torch.where(
        grid.density_grid < 0,
        grid.density_grid,
        torch.maximum(grid.density_grid * decay_arr, tmp),
    )
    positive = density_grid > 0
    mean_density = torch.sum(torch.where(positive, density_grid, 0.0)) / (
        torch.clamp(torch.sum(positive), min=1))
    threshold = torch.clamp(mean_density, max=density_threshold)
    return OccupancyGrid(
        density_grid=density_grid,
        count_grid=grid.count_grid,
        bitfield=packbits_u32(density_grid.reshape(-1), threshold),
    )
