"""Train- and test-time rendering of the sample-gather (NGP) path.

Port of the JAX package's ``render/renderer.py``.  Training: AABB
intersect -> occupancy march -> field eval (dense, or packed to the valid
samples) -> composite -> background.  Test: the JAX ``lax.while_loop`` as a
Python loop of rounds, each marching ``test_chunk_samples`` samples for
every live ray, evaluating and compositing them; rays stop when they leave
the box or their transmittance falls below the threshold.

Randomness is explicit: :func:`render_train` takes the t-start noise and
the random background as tensors.

Host reads.  Packing computes ``nonzero(valid, size=pack_cap)`` with a
cumulative sum and a scatter (no host read, no dynamic shape).  The test
renderer's ``while any(alive)`` is one read per round (the live rays'
indices); the count is returned as ``host_reads``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import Config, ModelConfig, RenderConfig
from ..models.registry import get_model
from ..ops.composite import (
    apply_background,
    composite_test_round,
    composite_train,
)
from ..ops.marching import (
    march_rays,
    perturb_t_start,
    sample_positions,
    valid_mask,
)
from ..ops.rays import ray_aabb_intersect

# profiler spans of the train step (ngp.march / field / composite)
_span = torch.profiler.record_function


def _background(rcfg: RenderConfig, bg, device) -> torch.Tensor:
    if rcfg.random_bg and bg is not None:
        return bg
    return torch.full((3,), 1.0 if rcfg.white_bg else 0.0, device=device)


def _counted(xyzs, keep):
    """``xyzs`` where ``keep``, the cube's centre elsewhere.

    A slot that does not count (an invalid slot of the dense grid, a pad of
    the packed one) gets weight 0, but its field value still enters the
    composite and its backward as ``0 * value``.  The JAX renderer
    evaluates such slots where the march left them, often outside the
    cube, where the tri-plane encoder reads NaN (``ops/triplane.py``): a
    dense tri-plane step there gives a NaN loss and poisons the table.
    Here they are evaluated at the centre: every counted value and
    gradient is unchanged, and nothing reads outside the cube."""
    return torch.where(keep[..., None], xyzs, 0.0)


def _eval_field_dense(params, mcfg, rays_o, rays_d, march, valid):
    """Field eval at every (ray, slot) of the sample grid."""
    xyzs = _counted(sample_positions(rays_o, rays_d, march.ts), valid)
    dirs = rays_d[:, None, :].expand(xyzs.shape)
    return get_model(mcfg.name).forward(params, mcfg, xyzs, dirs)


def pack_indices(valid: torch.Tensor, pack_cap: int) -> torch.Tensor:
    """Flat indices of the first ``pack_cap`` valid samples in row-major
    order, padded with ``valid.numel()``: ``jnp.nonzero(valid, size=
    pack_cap, fill_value=ns)`` with static shapes and no host read."""
    flat = valid.reshape(-1)
    ns = flat.shape[0]
    pos = torch.cumsum(flat, dim=0) - 1
    slot = torch.where(flat & (pos < pack_cap), pos, pack_cap)
    idx = torch.full((pack_cap + 1,), ns, dtype=torch.int64,
                     device=valid.device)
    idx.scatter_(0, slot, torch.arange(ns, device=valid.device))
    return idx[:pack_cap]


def _eval_field_packed(params, mcfg, rays_o, rays_d, march, valid,
                       pack_cap: int):
    """Field eval at only the first ``pack_cap`` valid samples; the rest
    of the grid (and any valid sample past the cap) gets sigma 0, rgb 0."""
    n, s = march.ts.shape
    ns = n * s
    idx = pack_indices(valid, pack_cap)
    in_range = idx < ns
    idx_c = torch.clamp(idx, max=ns - 1)
    ray_id = torch.clamp(idx_c // s, max=n - 1)
    t_pk = march.ts.reshape(-1)[idx_c]
    o_pk, d_pk = rays_o[ray_id], rays_d[ray_id]
    xyz_pk = _counted(o_pk + t_pk[:, None] * d_pk, in_range)
    sig_pk, rgb_pk = get_model(mcfg.name).forward(params, mcfg, xyz_pk, d_pk)
    packed = torch.cat([sig_pk[:, None], rgb_pk], dim=1) * in_range[:, None]
    # pad slots (idx == ns) land on the extra row, which is dropped
    dense = torch.zeros((ns + 1, 4), dtype=packed.dtype,
                        device=packed.device).index_put((idx,), packed)[:ns]
    return dense[:, 0].reshape(n, s), dense[:, 1:4].reshape(n, s, 3)


def render_train(
    params,
    mcfg: ModelConfig,
    rcfg: RenderConfig,
    bitfield: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    sample_cap: int,
    pack_cap: int | None = None,
    *,
    t_noise: torch.Tensor,
    bg: torch.Tensor | None = None,
) -> Dict[str, torch.Tensor]:
    """Differentiable train-time render of rays (N, 3).

    ``t_noise`` (N,) U[0, 1) perturbs each ray's first sample; ``bg`` (3,)
    is the random background, required with ``rcfg.random_bg``.
    ``pack_cap``: evaluate the field at only the first ``pack_cap`` valid
    samples.
    """
    dev = rays_o.device
    if rcfg.random_bg and bg is None:
        raise ValueError("render_train: random_bg needs the drawn bg")
    with _span("ngp.march"):
        hits_t = ray_aabb_intersect(rays_o, rays_d, mcfg.scale)
        t_start = perturb_t_start(hits_t, t_noise, rcfg.exp_step_factor,
                                  mcfg.grid_size, mcfg.scale)
        march = march_rays(
            rays_o, rays_d, t_start, hits_t[:, 1], bitfield,
            cascades=mcfg.cascades, scale=mcfg.scale,
            exp_step_factor=rcfg.exp_step_factor, grid_size=mcfg.grid_size,
            sample_cap=sample_cap,
        )
        valid = valid_mask(march.counts, sample_cap)
    with _span("ngp.field"):
        if pack_cap is None:
            sigmas, rgbs = _eval_field_dense(params, mcfg, rays_o, rays_d,
                                             march, valid)
        else:
            sigmas, rgbs = _eval_field_packed(params, mcfg, rays_o, rays_d,
                                              march, valid, pack_cap)
    with _span("ngp.composite"):
        comp = composite_train(sigmas, rgbs, march.deltas, march.ts, valid,
                               rcfg.t_threshold)
        rgb = apply_background(comp.rgb, comp.opacity,
                               _background(rcfg, bg, dev))
    return {
        "rgb": rgb,
        "opacity": comp.opacity,
        "depth": comp.depth,
        "ws": comp.ws,
        "deltas": march.deltas,
        "ts": march.ts,
        "valid": valid,
        "counts": march.counts,
        "rm_samples": torch.sum(march.counts),
        "vr_samples": comp.vr_samples,
    }


@torch.no_grad()
def render_test_chunk(params, mcfg: ModelConfig, rcfg: RenderConfig,
                      bitfield: torch.Tensor, rays_o: torch.Tensor,
                      rays_d: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Test-time render of one ray chunk: rounds of ``test_chunk_samples``
    samples per live ray until no ray is alive or ``max_samples`` per ray
    are spent.  Returns rgb, opacity, depth, ``total_samples`` (a device
    scalar), ``rounds`` and ``host_reads``.

    Each round reads the live rays' indices back (the JAX loop's ``any(
    alive)``, one read) and marches, evaluates and composites only those
    rays; a dead ray adds nothing in the JAX loop either."""
    n = rays_o.shape[0]
    s_seg = rcfg.test_chunk_samples
    max_rounds = max(rcfg.max_samples // s_seg, 1)
    dev = rays_o.device
    hits_t = ray_aabb_intersect(rays_o, rays_d, mcfg.scale)
    t_cur, t_end = hits_t[:, 0].clone(), hits_t[:, 1]
    alive = t_cur >= 0.0
    opacity = torch.zeros((n,), device=dev)
    depth = torch.zeros((n,), device=dev)
    rgb = torch.zeros((n, 3), device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    # per-round probe window: wide enough that a round rarely comes home
    # empty-handed, small enough to keep the probe cheap
    window = max(8 * s_seg, 256)
    model = get_model(mcfg.name)
    rnd = reads = 0
    while rnd < max_rounds:
        live = torch.nonzero(alive)[:, 0]
        reads += 1
        if live.numel() == 0:
            break
        o, d, te = rays_o[live], rays_d[live], t_end[live]
        march = march_rays(
            o, d, t_cur[live], te, bitfield, cascades=mcfg.cascades,
            scale=mcfg.scale, exp_step_factor=rcfg.exp_step_factor,
            grid_size=mcfg.grid_size, sample_cap=s_seg, n_candidates=window,
        )
        valid = valid_mask(march.counts, s_seg)
        xyzs = _counted(sample_positions(o, d, march.ts), valid)
        sigmas, rgbs = model.forward(params, mcfg, xyzs,
                                     d[:, None, :].expand(xyzs.shape))
        sigmas = torch.where(valid, sigmas, 0.0)
        op, dp, cl, converged = composite_test_round(
            sigmas, rgbs, march.deltas, march.ts, valid, rcfg.t_threshold,
            opacity[live], depth[live], rgb[live],
        )
        opacity[live], depth[live], rgb[live] = op, dp, cl
        # rays that left the box or converged stop
        still = (march.t_final < te) & ~converged
        alive[live] = still
        t_cur[live] = torch.where(still, march.t_final, t_cur[live])
        total = total + torch.sum(march.counts)
        rnd += 1
    rgb = apply_background(rgb, opacity, _background(rcfg, None, dev))
    return {"rgb": rgb, "opacity": opacity, "depth": depth,
            "total_samples": total, "rounds": rnd, "host_reads": reads}


def render_image(params, cfg: Config, bitfield: torch.Tensor,
                 rays_o: torch.Tensor, rays_d: torch.Tensor,
                 chunk: int = 65536) -> Dict[str, torch.Tensor]:
    """Full-image test render in ray chunks of at most ``chunk``.
    ``rounds`` and ``host_reads`` sum over chunks."""
    n = rays_o.shape[0]
    outs = [
        render_test_chunk(params, cfg.model, cfg.render, bitfield,
                          rays_o[i : i + chunk], rays_d[i : i + chunk])
        for i in range(0, n, chunk)
    ]
    res = {k: torch.cat([o[k] for o in outs])
           for k in ("rgb", "opacity", "depth")}
    for k in ("total_samples", "rounds", "host_reads"):
        res[k] = sum(o[k] for o in outs)
    return res
