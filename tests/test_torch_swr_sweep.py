"""Port parity: the shear-warp chunk sweep.

``chunk_sweep_reference`` (the plain PyTorch sweep) against the JAX
package's Pallas kernel run in interpret mode, on the shapes of
``tests/test_swr_pallas.py``.  Tolerance 2e-5, as the JAX package's own
kernel-vs-oracle test.  The CUDA kernel itself is held against the plain
version in the ``cuda``-marked test, which skips without a card.

JAX is imported inside the parity tests only, so that the ``cuda`` tests
also run on a GPU machine without JAX (``tests/conftest.py`` imports JAX,
hence ``--noconftest`` there)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_swr_sweep.py
"""

import numpy as np
import pytest
import torch
from torch_port_helpers import np32, rand_sweep_inputs, t32

from taichi_nerfs_torch.ops import swr_sweep as tsw

KINDS = ["linear", "cubic"]
TOL = 2e-5


def _jax_sweep(vol, rs, z_rel, ch, nq, kind):
    import jax.numpy as jnp

    from taichi_nerfs_tpu.ops.swr_pallas import chunk_sweep as j_chunk_sweep

    return np.asarray(
        j_chunk_sweep(jnp.asarray(vol), jnp.asarray(rs), jnp.asarray(z_rel),
                      jnp.asarray(ch), nq, jnp.float32, True, kind)
    )


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize(
    "shape",
    [dict(seed=0), dict(seed=3), dict(seed=7, nc=1, dc=2, Rb=6, Rc=6),
     dict(seed=11, nc=1, dc=4, Rb=10, Rc=7, nq=13)],
    ids=["rand0", "rand3", "single_chunk", "single_chunk_ragged"],
)
def test_reference_matches_pallas_forward(kind, shape):
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(**shape)
    want = _jax_sweep(vol, rs, z_rel, ch, nq, kind)
    got = tsw.chunk_sweep_reference(t32(vol), t32(rs), t32(z_rel), t32(ch),
                                    nq, kind)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(np32(got), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_grad_matches_pallas_backward(kind):
    """The plain sweep under autograd against the Pallas reverse sweep,
    with a random cotangent on every channel (tolerance 2e-4, as the JAX
    package's own gradient test)."""
    import jax
    import jax.numpy as jnp

    from taichi_nerfs_tpu.ops.swr_pallas import chunk_sweep as j_chunk_sweep

    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=3)
    g = np.random.default_rng(9).normal(
        size=(vol.shape[0], vol.shape[2] + 2, nq, nq)
    ).astype(np.float32)
    _, vjp = jax.vjp(
        lambda v: j_chunk_sweep(v, jnp.asarray(rs), jnp.asarray(z_rel),
                                jnp.asarray(ch), nq, jnp.float32, True,
                                kind),
        jnp.asarray(vol),
    )
    (want,) = vjp(jnp.asarray(g))
    vt = t32(vol).requires_grad_(True)
    out = tsw.chunk_sweep_reference(vt, t32(rs), t32(z_rel), t32(ch), nq,
                                    kind)
    out.backward(t32(g))
    np.testing.assert_allclose(np32(vt.grad), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_chunk_sweep_on_cpu_is_the_reference():
    vol, rs, z_rel, ch, nq = (
        t32(a) if isinstance(a, np.ndarray) else a
        for a in rand_sweep_inputs(seed=1)
    )
    before = tsw.chunk_sweep.launches
    got = tsw.chunk_sweep(vol, rs, z_rel, ch, nq, "cubic")
    want = tsw.chunk_sweep_reference(vol, rs, z_rel, ch, nq, "cubic")
    assert torch.equal(got, want)
    assert tsw.chunk_sweep.launches == before  # no kernel launched


def _args(**over):
    vol, rs, z_rel, ch, nq = (
        t32(a) if isinstance(a, np.ndarray) else a
        for a in rand_sweep_inputs(seed=2, F=8)
    )
    a = dict(vol_cs=vol, rs_par=rs, z_rel=z_rel, ch_par=ch, nq=nq,
             kind="linear")
    a.update(over)
    return a


@pytest.mark.parametrize(
    "over,exc",
    [
        (lambda a: dict(vol_cs=a["vol_cs"].bfloat16()), TypeError),
        (lambda a: dict(rs_par=a["rs_par"].double()), TypeError),
        (lambda a: dict(rs_par=a["rs_par"][:, :, :3].contiguous()),
         ValueError),
        (lambda a: dict(z_rel=a["z_rel"].T.contiguous()), ValueError),
        (lambda a: dict(vol_cs=a["vol_cs"].transpose(3, 4)), ValueError),
        (lambda a: dict(vol_cs=a["vol_cs"][:, :, :5].contiguous()),
         ValueError),
        (lambda a: dict(kind="nearest"), ValueError),
    ],
    ids=["bf16_vol", "f64_params", "rs_shape", "zrel_shape",
         "noncontiguous", "F5", "kind"],
)
def test_kernel_arg_checks(over, exc):
    a = _args()
    a.update(over(a))
    with pytest.raises(exc):
        tsw._check_kernel_args(**a)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sweep kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("F", [4, 8, 16])
def test_kernel_matches_reference_on_card(cuda_device, kind, F):
    """The CUDA kernel against the plain sweep on the card, ragged nq.
    Tolerance 1e-4: the kernel sums taps where the plain version runs
    dense fp32 matmuls (another summation order)."""
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=4, nc=3, dc=5, Rb=40,
                                               Rc=33, F=F, nq=37)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (vol, rs, z_rel, ch)]
    before = tsw.chunk_sweep.launches
    got = tsw.chunk_sweep(*args, nq, kind)
    want = tsw.chunk_sweep_reference(*args, nq, kind)
    torch.cuda.synchronize()
    assert tsw.chunk_sweep.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # with a gradient asked for, the same kernel runs under autograd (its
    # backward is tested in tests/test_torch_swr_sweep_bwd.py)
    diff = tsw.chunk_sweep(args[0].clone().requires_grad_(True), *args[1:],
                           nq, kind)
    assert diff.grad_fn is not None
    assert torch.equal(diff.detach(), got)


# the kernel's edge cases: (seed, nc, dc, R, nq, start range, step range).
# A negative step; a step >= 3 on a 256-voxel source, whose full 64-column
# tiles have slab windows wider than the kernel's shared-memory rows, so
# their warps read the taps from device memory; positions that are not
# finite (NON_FINITE_RS), read tap by tap or skipped with all weights 0; a
# lattice that starts and ends outside the source; whole tiles outside the
# source (rows and columns that reach no voxel skip the resample); an nq
# that is no multiple of the tiles (4 x 64 cubic, 8 x 32 linear)
EDGE_CASES = {
    "negative_step": (5, 2, 4, 64, 90, (60.0, 70.0), (-0.9, -0.6)),
    "step_ge_3": (6, 2, 3, 256, 70, (-5.0, 0.0), (3.0, 3.5)),
    "non_finite": (10, 2, 3, 64, 70, (-2.0, 0.0), (0.9, 1.1)),
    "partly_outside": (7, 2, 3, 48, 101, (-40.0, -30.0), (0.9, 1.1)),
    "far_outside": (9, 1, 2, 48, 200, (-150.0, -140.0), (0.95, 1.05)),
    "ragged_tile": (8, 1, 5, 96, 107, (-6.0, 0.0), (0.8, 1.0)),
}
# (chunk, slab, rs_par entry, value): a NaN column start, an infinite
# column step, a NaN row start
NON_FINITE_RS = ((0, 1, 2, np.nan), (1, 0, 3, np.inf), (1, 1, 0, np.nan))
# the widest slab window (source columns) the cubic kernel resamples from
# shared memory, and its tile width (csrc/swr_sweep_fwd.cu: kRowCols, Tile)
ROW_COLS, TILE_J = 160, 64


def _edge_inputs(case, F):
    seed, nc, dc, R, nq, start, step = EDGE_CASES[case]
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=seed, nc=nc, dc=dc,
                                               Rb=R, Rc=R, F=F, nq=nq)
    rng = np.random.default_rng(seed)
    rs[..., 0::2] = rng.uniform(*start, (nc, dc, 2))
    rs[..., 1::2] = rng.uniform(*step, (nc, dc, 2))
    if case == "non_finite":
        for c, s, k, v in NON_FINITE_RS:
            rs[c, s, k] = v
    return vol, rs, z_rel, ch, nq


def _tap_path_warps(rs, nq, R):
    """How many (chunk, slab, lattice row, tile) warps the cubic kernel
    resamples tap by tap from device memory: those whose row reaches the
    source and whose tile's column window is not finite or wider than
    ROW_COLS.  A mirror of the kernel's warp_taps / axis_window in fp32."""
    f32 = np.float32
    j0 = np.arange(0, nq, TILE_J)
    j1 = np.minimum(j0 + TILE_J, nq) - 1
    with np.errstate(invalid="ignore", over="ignore"):
        # rows: a row is in when a tap of it lies in [0, R)
        pb = rs[..., 0:1] + f32(np.arange(nq)) * rs[..., 1:2]
        near = (pb > -4) & (pb < R + 4)
        m0 = np.floor(np.where(near, pb, 0)) - 1
        rows_in = (near & (m0 + 3 >= 0) & (m0 < R)).sum(-1)
        # columns: the window of each tile's first and last live column
        pa = rs[..., 2:3] + f32(j0) * rs[..., 3:4]
        pz = rs[..., 2:3] + f32(j1) * rs[..., 3:4]
        finite = np.isfinite(pa) & np.isfinite(pz)
        p_lo = np.clip(np.fmin(pa, pz), -8, R + 8)
        p_hi = np.clip(np.fmax(pa, pz), -8, R + 8)
        lo, hi = np.floor(p_lo) - 1, np.floor(p_hi) + 2
        first = np.maximum(lo - 1, 0)
        ncol = np.where((hi < 0) | (lo >= R), 0,
                        np.minimum(hi + 1, R - 1) - first + 1)
    taps = (~finite | (ncol > ROW_COLS)).sum(-1)
    return int((rows_in * taps).sum())


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_cases_reach_the_tap_path(case):
    """The step >= 3 and non-finite cases, and only they, have cubic warps
    that read their taps from device memory, so the card test below runs
    both of the kernel's resample paths."""
    _, rs, _, _, nq = _edge_inputs(case, 4)
    R = EDGE_CASES[case][3]
    want = case in ("step_ge_3", "non_finite")
    assert (_tap_path_warps(rs, nq, R) > 0) == want


# non-finite positions cubic only: the plain linear tent, clamp(1 - |x|),
# turns a NaN distance into a NaN weight where the kernel (and the plain
# Catmull-Rom) gives it weight 0; linear never takes the shared-memory path
EDGE_RUNS = [(case, kind) for case in sorted(EDGE_CASES) for kind in KINDS
             if (case, kind) != ("non_finite", "linear")]


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 8, 16])
@pytest.mark.parametrize("case,kind", EDGE_RUNS)
def test_kernel_edge_cases_on_card(cuda_device, case, kind, F):
    """The kernel against the plain sweep (1e-4) where its slab windows are
    hardest to get right: every lattice point's taps must be inside its
    warp's window or be read from device memory."""
    vol, rs, z_rel, ch, nq = _edge_inputs(case, F)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (vol, rs, z_rel, ch)]
    got = tsw.chunk_sweep(*args, nq, kind)
    want = tsw.chunk_sweep_reference(*args, nq, kind)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
