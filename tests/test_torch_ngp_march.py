"""Port parity of the occupancy grid and the marchers.

Marching: both marchers and the test renderer's window mode, at one and two
cascades.  At least 99.9 % of rays agree: equal counts, ``ts`` to 1e-6,
``deltas`` to 1e-7 and ``t_final`` to 1e-5 (``tests/test_march.py``).  The
others are float ties at a cell boundary (the probe positions round
differently in the two packages), which insert or drop one sample.

Occupancy: the visibility marking is equal except at cells whose
projection lies within 1e-4 px of an image edge (counted and printed); the
density refresh, warmup and sparse, with the JAX package's own draws (the
key splits of ``update_density_grid``), matches at rtol 1e-5 with an equal
bitfield, including a grid with fewer occupied cells than ``G^3/4``, where
the picked cells are decided by how top-k orders tied keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import np32, t32

from taichi_nerfs_torch import config as tconfig
from taichi_nerfs_torch.models import ngp as tngp
from taichi_nerfs_torch.models import occupancy as tocc
from taichi_nerfs_torch.ops import marching as tmarch
from taichi_nerfs_torch.ops.rays import ray_aabb_intersect
from taichi_nerfs_torch.utils.convert import (
    ngp_params_from_numpy,
    occupancy_from_numpy,
)
from taichi_nerfs_tpu import config as jconfig
from taichi_nerfs_tpu.data.synthetic import look_at
from taichi_nerfs_tpu.models import ngp as jngp
from taichi_nerfs_tpu.models import occupancy as jocc
from taichi_nerfs_tpu.ops import marching as jmarch
from taichi_nerfs_tpu.ops.math import packbits_u32

G = 32


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.4
    d = -o + rng.uniform(-0.4, 0.4, (n, 3))
    o[: n // 8] = rng.uniform(-0.45, 0.45, (n // 8, 3))  # rays from inside
    d[: n // 8] = rng.normal(size=(n // 8, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _bitfield(cascades, seed, occupancy=0.3):
    rng = np.random.default_rng(seed)
    dens = (rng.uniform(size=cascades * G**3) < occupancy).astype(np.float32)
    words = np.asarray(packbits_u32(jnp.asarray(dens), 0.5))
    return words, torch.tensor(words.view(np.int32))


def _unmatched(a, b, tol=1e-6):
    """Samples of two ascending ``t`` lists left over by an ordered
    alignment (a tie on a cell boundary inserts or drops one sample)."""
    i = j = matched = 0
    while i < len(a) and j < len(b):
        if abs(a[i] - b[j]) <= tol:
            matched, i, j = matched + 1, i + 1, j + 1
        elif a[i] < b[j]:
            i += 1
        else:
            j += 1
    return len(a) - matched + len(b) - matched


def _compare(t, j, min_share=0.999):
    """At least ``min_share`` of the rays agree: equal counts, ``ts`` to
    1e-6, ``deltas`` to 1e-7, ``t_final`` to 1e-5.  A ray that does not is
    a boundary tie: its sample lists differ by at most two samples (on a
    capped ray one inserted sample also pushes the last one out)."""
    tc, jc = t.counts.numpy(), np.asarray(j.counts)
    tts, jts = np32(t.ts), np.asarray(j.ts)
    agree = (
        (tc == jc)
        & np.all(np.abs(tts - jts) <= 1e-6, axis=1)
        & np.all(np.abs(np32(t.deltas) - np.asarray(j.deltas)) <= 1e-7,
                 axis=1)
        & (np.abs(np32(t.t_final) - np.asarray(j.t_final)) <= 1e-5)
    )
    assert agree.mean() >= min_share, (agree.mean(), np.flatnonzero(~agree))
    assert jc[agree].sum() > 0
    for r in np.flatnonzero(~agree):
        assert _unmatched(tts[r, : tc[r]], jts[r, : jc[r]]) <= 2, r


@pytest.mark.parametrize("cap", [32, 256])
def test_interval_marcher(cap):
    """cascades 1, exp_step_factor 0: the cell-interval marcher."""
    o, d = _rays(2000, 0)
    words, bf = _bitfield(1, 1)
    hits = ray_aabb_intersect(t32(o), t32(d), 0.5)
    rng = np.random.default_rng(2)
    noise = rng.uniform(size=2000).astype(np.float32)
    t0 = tmarch.perturb_t_start(hits, t32(noise), 0.0, G, 0.5)
    kw = dict(cascades=1, scale=0.5, exp_step_factor=0.0, grid_size=G,
              sample_cap=cap)
    t = tmarch.march_rays(t32(o), t32(d), t0, hits[:, 1], bf, **kw)
    j = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(np32(t0)), jnp.asarray(np32(hits[:, 1])),
                          jnp.asarray(words), **kw)
    _compare(t, j)
    assert int(t.counts.max()) == cap or cap > 200  # the cap binds at 32


@pytest.mark.parametrize("scale,exp_f", [(0.5, 1 / 256), (1.0, 0.0),
                                         (1.0, 1 / 256)],
                         ids=["c1-exp", "c2-const", "c2-exp"])
def test_lattice_marcher(scale, exp_f):
    cascades = tconfig.ModelConfig(scale=scale).cascades
    o, d = _rays(1500, 3)
    o = o * 2 * scale
    words, bf = _bitfield(cascades, 4)
    hits = ray_aabb_intersect(t32(o), t32(d), scale)
    kw = dict(cascades=cascades, scale=scale, exp_step_factor=exp_f,
              grid_size=G, sample_cap=128)
    t = tmarch.march_rays(t32(o), t32(d), hits[:, 0], hits[:, 1], bf, **kw)
    j = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(np32(hits[:, 0])),
                          jnp.asarray(np32(hits[:, 1])), jnp.asarray(words),
                          **kw)
    _compare(t, j)
    # the lattice marcher at cascades 1 and exp 0, forced by a window
    if scale == 1.0 and exp_f == 0.0:
        kw1 = dict(cascades=1, scale=0.5, exp_step_factor=0.0, grid_size=G,
                   sample_cap=128,
                   n_candidates=jmarch.num_candidates(0.5, 0.0, G))
        w1, b1 = _bitfield(1, 5)
        h1 = ray_aabb_intersect(t32(o / 2), t32(d), 0.5)
        t = tmarch.march_rays(t32(o / 2), t32(d), h1[:, 0], h1[:, 1], b1,
                              **kw1)
        j = jmarch.march_rays(jnp.asarray(o / 2), jnp.asarray(d),
                              jnp.asarray(np32(h1[:, 0])),
                              jnp.asarray(np32(h1[:, 1])), jnp.asarray(w1),
                              **kw1)
        _compare(t, j)


@pytest.mark.parametrize("scale", [0.5, 1.0], ids=["c1", "c2"])
def test_window_mode_resumes(scale):
    """The test renderer's rounds: 32 samples from a 256-candidate window,
    three rounds, each resuming at the previous ``t_final``."""
    cascades = tconfig.ModelConfig(scale=scale).cascades
    exp_f = 1 / 256 if scale > 0.5 else 0.0
    o, d = _rays(1500, 6)
    o = o * 2 * scale
    words, bf = _bitfield(cascades, 7, occupancy=0.1)
    hits = ray_aabb_intersect(t32(o), t32(d), scale)
    kw = dict(cascades=cascades, scale=scale, exp_step_factor=exp_f,
              grid_size=G, sample_cap=32, n_candidates=256)
    t_cur = hits[:, 0]
    for _ in range(3):
        t = tmarch.march_rays(t32(o), t32(d), t_cur, hits[:, 1], bf, **kw)
        j = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(np32(t_cur)),
                              jnp.asarray(np32(hits[:, 1])),
                              jnp.asarray(words), **kw)
        _compare(t, j)
        t_cur = torch.where(t.t_final < hits[:, 1], t.t_final, -1.0)


def test_helpers():
    counts = torch.tensor([0, 2, 5], dtype=torch.int32)
    np.testing.assert_array_equal(
        tmarch.valid_mask(counts, 4).numpy(),
        np.asarray(jmarch.valid_mask(jnp.asarray(counts.numpy()), 4)))
    for args in ((0.5, 0.0), (0.5, 1 / 256), (1.0, 1 / 256)):
        assert tmarch.num_candidates(*args) == jmarch.num_candidates(*args)
    hits = np.array([[0.5, 1.0], [-1.0, -1.0]], np.float32)
    noise = np.array([0.5, 0.5], np.float32)
    np.testing.assert_array_equal(
        tmarch.perturb_t_start(t32(hits), t32(noise), 0.0, G, 0.5).numpy(),
        np.asarray(jmarch.perturb_t_start(jnp.asarray(hits),
                                          jnp.asarray(noise), 0.0, G, 0.5)))


# ------------------------------------------------------------------ occupancy


def _model(scale):
    kw = dict(scale=scale, pos_encoder_type="hash", grid_size=16,
              xyz_net_width=16, rgb_net_width=16, mlp_dtype="float32")
    hk = dict(levels=4, feature_per_level=2, log2_T=11, base_res=4,
              max_res=32)
    return (tconfig.ModelConfig(grid=tconfig.HashGridConfig(**hk), **kw),
            jconfig.ModelConfig(grid=jconfig.HashGridConfig(**hk), **kw))


def _rig(n=6, w=40, h=30):
    rng = np.random.RandomState(0)
    poses = []
    for i in range(n):
        th = 2 * np.pi * i / n + rng.uniform(0, 0.3)
        ph = rng.uniform(-0.9, 0.9)
        eye = 1.1 * np.array([np.cos(th) * np.cos(ph),
                              np.sin(th) * np.cos(ph), np.sin(ph)])
        poses.append(look_at(eye, np.zeros(3), np.array([0.0, 0.0, 1.0])))
    K = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]],
                 np.float32)
    return np.stack(poses).astype(np.float32), K, (w, h)


def _edge_cells(cfg, K, poses, img_wh, tol=1e-4):
    """Morton indices of cells whose projection (float64) lies within
    ``tol`` px of an image edge, for some camera and cascade."""
    from taichi_nerfs_tpu.ops.math import grid_coords_np, morton3d_np

    g = cfg.grid_size
    coords = grid_coords_np(g)
    idx = morton3d_np(coords)
    xyz = coords / (g - 1) * 2.0 - 1.0
    edge = np.zeros((cfg.cascades, g**3), bool)
    for c in range(cfg.cascades):
        s = min(2.0 ** (c - 1), cfg.scale)
        pts = xyz * (s - s / g)
        for p in poses.astype(np.float64):
            r = p[:, :3].T
            cam = (pts - p[:, 3]) @ r.T
            uvd = cam @ K.astype(np.float64).T
            uv = uvd[:, :2] / uvd[:, 2:3]
            near = np.minimum.reduce([np.abs(uv[:, 0]),
                                      np.abs(uv[:, 0] - img_wh[0]),
                                      np.abs(uv[:, 1]),
                                      np.abs(uv[:, 1] - img_wh[1])])
            edge[c, idx] |= near < tol
    return edge


@pytest.mark.parametrize("scale", [0.5, 1.0], ids=["c1", "c2"])
def test_mark_invisible_cells(scale):
    tm, jm = _model(scale)
    poses, K, wh = _rig()
    j = jocc.mark_invisible_cells(jm, jnp.asarray(K), jnp.asarray(poses), wh)
    t = tocc.mark_invisible_cells(tm, K, poses, wh, chunk=1000)
    edge = _edge_cells(tm, K, poses, wh)
    print(f"cells within 1e-4 px of an image edge: {int(edge.sum())} of "
          f"{edge.size}")
    for a, b in ((t.density_grid, j.density_grid),
                 (t.count_grid, j.count_grid)):
        a, b = np32(a), np.asarray(b)
        np.testing.assert_array_equal(a[~edge], b[~edge])
    assert (np32(t.density_grid) < 0).any() and (np32(t.density_grid)
                                                 == 0).any()


def _jax_draws(key, cfg, warmup):
    """The draws of the JAX ``update_density_grid``, from its key splits."""
    g3 = cfg.grid_size**3
    m = g3 // 4
    out = []
    for _ in range(cfg.cascades):
        key, k_u, k_o, k_n = jax.random.split(key, 4)
        if warmup:
            noise = jax.random.uniform(k_n, (g3, 3), minval=-1.0, maxval=1.0)
            out.append(tocc.GridDraws(None, None, t32(noise)))
            continue
        coords1 = jax.random.randint(k_u, (m, 3), 0, cfg.grid_size,
                                     dtype=jnp.int32)
        r = jax.random.uniform(k_o, (g3,))
        noise = jax.random.uniform(k_n, (2 * m, 3), minval=-1.0, maxval=1.0)
        out.append(tocc.GridDraws(torch.tensor(np.asarray(coords1)),
                                  t32(r), t32(noise)))
    return out


@pytest.mark.parametrize("scale,warmup,occupied", [
    (0.5, True, 0.0), (0.5, False, 0.6), (0.5, False, 0.05),
    (1.0, True, 0.0), (1.0, False, 0.05),
], ids=["c1-warmup", "c1-sparse", "c1-sparse-ties", "c2-warmup",
        "c2-sparse-ties"])
def test_update_density_grid(scale, warmup, occupied):
    tm, jm = _model(scale)
    jp = jngp.init_ngp_params(jax.random.PRNGKey(3), jm)
    tp = ngp_params_from_numpy(jax.device_get(jp))
    g3 = tm.grid_size**3
    rng = np.random.default_rng(8)
    thr = 0.01 * 1024 / np.sqrt(3.0)
    dens = np.where(rng.uniform(size=(tm.cascades, g3)) < occupied,
                    rng.uniform(thr, 4 * thr, (tm.cascades, g3)),
                    rng.uniform(0, 0.5 * thr, (tm.cascades, g3)))
    dens[rng.uniform(size=dens.shape) < 0.1] = -1.0  # invisible cells
    dens = dens.astype(np.float32)
    count = rng.uniform(0, 1, dens.shape).astype(np.float32)
    words = np.asarray(packbits_u32(jnp.asarray(dens.reshape(-1)), thr))
    if not warmup and occupied < 0.25:
        assert (dens > thr).sum(axis=1).max() < g3 // 4  # the tie case
    jgrid = jocc.OccupancyGrid(jnp.asarray(dens), jnp.asarray(count),
                               jnp.asarray(words))
    tgrid = occupancy_from_numpy(dens, count, words)
    key = jax.random.PRNGKey(11)
    j = jocc.update_density_grid(jp, jm, jngp.density, jgrid, key, thr,
                                 warmup=warmup)
    t = tocc.update_density_grid(tp, tm, tngp.density, tgrid,
                                 _jax_draws(key, tm, warmup), thr,
                                 warmup=warmup)
    np.testing.assert_allclose(np32(t.density_grid),
                               np.asarray(j.density_grid), rtol=1e-5,
                               atol=0)
    np.testing.assert_array_equal(t.bitfield.numpy().view(np.uint32),
                                  np.asarray(j.bitfield))
    assert (np32(t.density_grid) == -1.0).sum() > 0  # invisible cells stay
