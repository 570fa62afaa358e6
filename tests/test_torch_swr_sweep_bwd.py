"""Port parity: the backward of the shear-warp chunk sweep.

The port's ``chunk_sweep`` under autograd (on the CPU: the plain sweep,
``chunk_sweep_reference``) and its ``chunk_sweep_bwd`` wrapper against the
VJP of the JAX package's ``chunk_sweep`` with ``interpret=True`` (the
Pallas reverse sweep in interpret mode), on the inputs of
``tests/test_swr_pallas.py``.  Tolerance 2e-4, as the JAX package's own
gradient tests.  The CUDA kernel ``csrc/swr_sweep_bwd.cu`` is held against
the plain version's autograd in the ``cuda``-marked tests, which skip
without a card and run on one with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_swr_sweep_bwd.py
"""

import numpy as np
import pytest
import torch
from torch_port_helpers import np32, rand_sweep_inputs, t32

from test_torch_swr_sweep import (
    EDGE_CASES,
    EDGE_RUNS,
    ROW_COLS,
    TILE_J,
    _edge_inputs,
)
from taichi_nerfs_torch.ops import swr_sweep as tsw
from taichi_nerfs_torch.ops._build import LAUNCHES
from taichi_nerfs_torch.ops.warp import interp_kernel

KINDS = ["linear", "cubic"]
TOL = 2e-4


def _jax_vjp(vol, rs, z_rel, ch, nq, kind, g):
    import jax
    import jax.numpy as jnp

    from taichi_nerfs_tpu.ops.swr_pallas import chunk_sweep as j_chunk_sweep

    _, vjp = jax.vjp(
        lambda v: j_chunk_sweep(v, jnp.asarray(rs), jnp.asarray(z_rel),
                                jnp.asarray(ch), nq, jnp.float32, True, kind),
        jnp.asarray(vol),
    )
    (dvol,) = vjp(jnp.asarray(g))
    return np.asarray(dvol)


def _cotangent(vol, nq, seed=9):
    return np.random.default_rng(seed).normal(
        size=(vol.shape[0], vol.shape[2] + 2, nq, nq)
    ).astype(np.float32)


def _port_grad(vol, rs, z_rel, ch, nq, kind, g):
    vt = t32(vol).requires_grad_(True)
    out = tsw.chunk_sweep(vt, t32(rs), t32(z_rel), t32(ch), nq, kind)
    out.backward(t32(g))
    return np32(vt.grad)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize(
    "shape",
    [dict(seed=0), dict(seed=3), dict(seed=11, nc=1, dc=4, Rb=10, Rc=7,
                                      nq=13)],
    ids=["rand0", "clamp_binds", "ragged"],
)
def test_grad_matches_pallas_vjp_all_channels(kind, shape):
    """Random cotangent on all F+2 channels, tau included."""
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(**shape)
    g = _cotangent(vol, nq)
    want = _jax_vjp(vol, rs, z_rel, ch, nq, kind, g)
    np.testing.assert_allclose(_port_grad(vol, rs, z_rel, ch, nq, kind, g),
                               want, rtol=TOL, atol=TOL)


def test_cubic_clamp_binds():
    """The seed-3 inputs drive cubic-resampled sigma below 0, so the clamp
    case above is exercised (tests/test_swr_pallas.py:157-176)."""
    vol, rs, _, _, nq = rand_sweep_inputs(seed=3)
    nc, dc, F, Rb, Rc = vol.shape
    lat = torch.arange(nq, dtype=torch.float32)
    n_neg = 0
    for c in range(nc):
        for s in range(dc):
            sb, stb, sc, stc = (float(v) for v in rs[c, s])
            wb = interp_kernel(torch.arange(Rb)[None] - (sb + lat[:, None]
                                                         * stb), "cubic")
            wc = interp_kernel(torch.arange(Rc)[None] - (sc + lat[:, None]
                                                         * stc), "cubic")
            x2 = wb @ t32(vol[c, s, 0]) @ wc.T
            n_neg += int((x2 < -1e-3).sum())
    assert n_neg > 0


@pytest.mark.parametrize("kind", KINDS)
def test_zero_density_gets_no_sigma_gradient(kind):
    """Resampled sigma exactly 0 everywhere: the Pallas backward gates
    d sigma on x2 > 0, so the plain version must give 0 there too (a
    ``clamp`` would pass the tau cotangent through)."""
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=2)
    vol[:, :, 0] = 0.0
    g = _cotangent(vol, nq, seed=4)
    got = _port_grad(vol, rs, z_rel, ch, nq, kind, g)
    want = _jax_vjp(vol, rs, z_rel, ch, nq, kind, g)
    assert np.all(want[:, :, 0] == 0.0)
    np.testing.assert_array_equal(got[:, :, 0], 0.0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_tau_only_cotangent():
    """d tau / d sigma_k = dt: a tau-only cotangent gives a nonzero density
    gradient and exactly zero feature gradients."""
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=5)
    F = vol.shape[2]
    g = np.zeros((vol.shape[0], F + 2, nq, nq), np.float32)
    g[:, F + 1] = 1.0
    got = _port_grad(vol, rs, z_rel, ch, nq, "linear", g)
    assert np.abs(got[:, :, 0]).max() > 1e-3
    np.testing.assert_array_equal(got[:, :, 1:], 0.0)
    np.testing.assert_allclose(
        got, _jax_vjp(vol, rs, z_rel, ch, nq, "linear", g), rtol=TOL,
        atol=TOL,
    )


def test_chunk_sweep_bwd_on_cpu_is_the_reference():
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=1)
    args = [t32(a) for a in (vol, rs, z_rel, ch)]
    g = t32(_cotangent(vol, nq))
    frames = tsw.chunk_sweep(*args, nq, "cubic")
    before = LAUNCHES["swr_sweep_bwd"]
    got = tsw.chunk_sweep_bwd(*args, frames, g, nq, "cubic")
    want = tsw.chunk_sweep_bwd_reference(*args, g, nq, "cubic")
    assert torch.equal(got, want)
    assert LAUNCHES["swr_sweep_bwd"] == before  # no kernel launched


@pytest.mark.parametrize(
    "over,exc",
    [
        (lambda a: dict(g=a["g"][:, :-1].contiguous()), ValueError),
        (lambda a: dict(frames=a["frames"].double()), TypeError),
        (lambda a: dict(frames=a["frames"].transpose(2, 3)), ValueError),
    ],
    ids=["g_shape", "frames_f64", "frames_noncontiguous"],
)
def test_bwd_arg_checks(over, exc):
    vol, _, _, _, nq = rand_sweep_inputs(seed=2, F=8)
    a = dict(vol_cs=t32(vol), frames=torch.zeros(2, 10, nq, nq),
             g=torch.zeros(2, 10, nq, nq), nq=nq)
    a.update(over(a))
    with pytest.raises(exc):
        tsw._check_bwd_args(**a)


@pytest.mark.parametrize("vol_dtype,op_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("kind", KINDS)
def test_operators_hand_the_kernels_their_arguments(kind, vol_dtype,
                                                    op_dtype):
    """What both sweep operators pass to their C entries, recorded on CPU
    tensors by the ``launch`` the implementations are given, the outputs
    allocated by the fake versions: the device, the pointers in the
    entries' order, (n_chunks, dc, F, Rb, Rc, nq, kind, volume dtype,
    operand dtype); the backward's scratch (and its count of the rows
    kernel) exactly with a bf16 volume or bf16 operands."""
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(seed=3, nc=2, dc=3, Rb=9,
                                               Rc=7, F=8, nq=11)
    args = [t32(vol).to(getattr(torch, vol_dtype)), t32(rs), t32(z_rel),
            t32(ch)]
    dtype = getattr(torch, op_dtype)
    seen = []

    def launch(device, *c_args):
        seen.append((device, c_args))

    fwd = (*args, nq, kind, dtype)
    frames = tsw._sweep_fwd_fake(*fwd)
    tsw._sweep_fwd_op(launch, frames, *fwd)
    bwd = (*args, frames, torch.zeros_like(frames), nq, kind, dtype)
    dvol = tsw._sweep_bwd_fake(*bwd)
    rows = LAUNCHES["swr_sweep_bwd_rows"]
    tsw._sweep_bwd_op(launch, dvol, *bwd)
    bf16 = "bfloat16" in (vol_dtype, op_dtype)
    assert LAUNCHES["swr_sweep_bwd_rows"] == rows + bf16
    (fdev, fa), (bdev, ba) = seen
    assert fdev == bdev == args[0].device
    assert frames.shape == (2, 10, nq, nq) and frames.dtype == torch.float32
    assert dvol.shape == args[0].shape and dvol.dtype == args[0].dtype
    sizes = (2, 3, 8, 9, 7, nq, {"linear": 0, "cubic": 1}[kind],
             int(vol_dtype == "bfloat16"), int(op_dtype == "bfloat16"))
    assert fa == (*(t.data_ptr() for t in (*args, frames)), *sizes)
    assert ba[:7] == tuple(t.data_ptr() for t in (*args, frames, bwd[5],
                                                  dvol))
    assert (ba[7] is not None) == bf16 and ba[8:] == sizes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sweep kernels have no CPU mode)")
    return torch.device("cuda")


def _card_case(device, **shape):
    vol, rs, z_rel, ch, nq = rand_sweep_inputs(**shape)
    args = [torch.as_tensor(a, device=device) for a in (vol, rs, z_rel, ch)]
    g = torch.as_tensor(_cotangent(vol, nq), device=device)
    return args, g, nq


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("F", [4, 8, 16])
def test_kernel_grad_matches_reference_on_card(cuda_device, kind, F):
    """Gradient through ``chunk_sweep`` on the card (forward and backward
    kernels) against the plain version's autograd, ragged shapes.
    Elementwise 2e-4 abs + 2e-4 rel: the kernels sum taps where the plain
    version runs dense fp32 matmuls (another summation order)."""
    args, g, nq = _card_case(cuda_device, seed=4, nc=3, dc=5, Rb=40, Rc=33,
                             F=F, nq=37)
    vol = args[0].clone().requires_grad_(True)
    f0, b0 = LAUNCHES["swr_sweep_fwd"], LAUNCHES["swr_sweep_bwd"]
    tsw.chunk_sweep(vol, *args[1:], nq, kind).backward(g)
    want = tsw.chunk_sweep_bwd_reference(*args, g, nq, kind)
    torch.cuda.synchronize()
    assert LAUNCHES["swr_sweep_fwd"] == f0 + 1
    assert LAUNCHES["swr_sweep_bwd"] == b0 + 1
    torch.testing.assert_close(vol.grad, want, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_grad_clamp_binds_on_card(cuda_device, kind):
    args, g, nq = _card_case(cuda_device, seed=3)
    frames = tsw.chunk_sweep(*args, nq, kind)
    got = tsw.chunk_sweep_bwd(*args, frames, g, nq, kind)
    want = tsw.chunk_sweep_bwd_reference(*args, g, nq, kind)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    # the tiles' sums are added with atomics, in the order the blocks reach
    # them: a second run agrees to the last bits of fp32
    again = tsw.chunk_sweep_bwd(*args, frames, g, nq, kind)
    torch.testing.assert_close(again, got, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 8, 16])
@pytest.mark.parametrize("case,kind", EDGE_RUNS)
def test_kernel_grad_edge_cases_on_card(cuda_device, case, kind, F):
    """The backward kernel against the plain version's autograd (2e-4) at
    the forward's edge cases: a negative step, a step >= 3 and non-finite
    positions (the tap-by-tap path), lattices partly and wholly outside
    the source, a ragged tile."""
    vol, rs, z_rel, ch, nq = _edge_inputs(case, F)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (vol, rs, z_rel, ch)]
    g = torch.as_tensor(_cotangent(vol, nq), device=cuda_device)
    frames = tsw.chunk_sweep(*args, nq, kind)
    got = tsw.chunk_sweep_bwd(*args, frames, g, nq, kind)
    want = tsw.chunk_sweep_bwd_reference(*args, g, nq, kind)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def _bwd_paths(rs, nq, Rc, NT=4):
    """How the backward kernel treats each (chunk, slab, 64-column tile):
    counts of tiles on the tap-by-tap path (a column window that is not
    finite or wider than ROW_COLS, its dx2 scattered point by point), on
    the window path adding 16 bytes at a time (Rc a multiple of 4), and on
    the window path adding one float at a time.  A mirror of the kernel's
    axis_window and its widening to whole float4s, in fp32."""
    f32 = np.float32
    j0 = np.arange(0, nq, TILE_J)
    j1 = np.minimum(j0 + TILE_J, nq) - 1
    with np.errstate(invalid="ignore", over="ignore"):
        pa = rs[..., 2:3] + f32(j0) * rs[..., 3:4]
        pz = rs[..., 2:3] + f32(j1) * rs[..., 3:4]
        finite = np.isfinite(pa) & np.isfinite(pz)
        p_lo = np.clip(np.fmin(pa, pz), -8, Rc + 8)
        p_hi = np.clip(np.fmax(pa, pz), -8, Rc + 8)
        lo = np.floor(p_lo) - (NT // 2 - 1)
        hi = np.floor(p_hi) + NT // 2
    empty = (hi < 0) | (lo >= Rc)
    c0 = np.maximum(lo - 1, 0)
    end = np.minimum(hi + 1, Rc - 1) + 1
    vec = Rc % 4 == 0
    if vec:
        end = np.minimum((end + 3) // 4 * 4, Rc)
        c0 = c0 // 4 * 4
    ncol = np.where(empty, 0, end - c0)
    taps = ~finite | (ncol > ROW_COLS)
    window = int((~taps).sum())
    return {"taps": int(taps.sum()), "float4": window if vec else 0,
            "float": 0 if vec else window}


@pytest.mark.parametrize("case", sorted(EDGE_CASES) + ["ragged_card"])
def test_bwd_cases_reach_each_path(case):
    """Which of the backward kernel's paths the card tests run: the step
    >= 3 and non-finite cases, and only they, scatter point by point; the
    others sum on the window path, 16 bytes at a time where the source
    rows hold whole float4s (every edge case) and one float at a time
    where they do not (the ragged card case, Rc = 33)."""
    if case == "ragged_card":
        _, rs, _, _, nq = rand_sweep_inputs(seed=4, nc=3, dc=5, Rb=40, Rc=33,
                                            F=4, nq=37)
        Rc = 33
    else:
        _, rs, _, _, nq = _edge_inputs(case, 4)
        Rc = EDGE_CASES[case][3]
    paths = _bwd_paths(rs, nq, Rc)
    assert (paths["taps"] > 0) == (case in ("step_ge_3", "non_finite"))
    assert (paths["float"] > 0) == (case == "ragged_card")
    assert (paths["float4"] > 0) == (case != "ragged_card")


# the bf16 instances (chip_smoke.py's limits, set on the H100 against
# copies of the kernels built without the operand rounding): frames with
# fp32 / bf16 operands, max abs (a bf16 operand rounding can land on the
# neighbouring bf16 value where the two sum the taps in another order)
# and, with bf16 operands, relative norm; d vol, relative norm
BF16_FWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BF16_FWD_REL_TOL = 3e-4
BF16_DVOL_TOL = 2.5e-4
DTYPE_PAIRS = [(v, o) for v in ("float32", "bfloat16")
               for o in ("float32", "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 8, 16])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("vol_dtype,op_dtype", DTYPE_PAIRS,
                         ids=[f"vol_{v}-ops_{o}" for v, o in DTYPE_PAIRS])
def test_bf16_kernels_match_reference_on_card(cuda_device, vol_dtype,
                                              op_dtype, kind, F):
    """Both kernels at each (volume, operand) dtype pair against the plain
    versions on the card, ragged shapes: frames within BF16_FWD_TOL (and
    BF16_FWD_REL_TOL with bf16 operands), d vol in the volume's dtype
    within BF16_DVOL_TOL relative norm, each kernel launched once, and the
    backward's finishing kernel once where the volume or the operands are
    bf16."""
    args, g, nq = _card_case(cuda_device, seed=4, nc=3, dc=5, Rb=40, Rc=33,
                             F=F, nq=37)
    args[0] = args[0].to(getattr(torch, vol_dtype))
    dt = getattr(torch, op_dtype)
    v = args[0].clone().requires_grad_(True)
    f0, b0 = LAUNCHES["swr_sweep_fwd"], LAUNCHES["swr_sweep_bwd"]
    r0 = LAUNCHES["swr_sweep_bwd_rows"]
    out = tsw.chunk_sweep(v, *args[1:], nq, kind, dtype=dt)
    out.backward(g)
    want = tsw.chunk_sweep_reference(*args, nq, kind, dtype=dt)
    want_d = tsw.chunk_sweep_bwd_reference(*args, g, nq, kind, dtype=dt)
    torch.cuda.synchronize()
    assert LAUNCHES["swr_sweep_fwd"] == f0 + 1
    assert LAUNCHES["swr_sweep_bwd"] == b0 + 1
    bf16 = "bfloat16" in (vol_dtype, op_dtype)
    assert LAUNCHES["swr_sweep_bwd_rows"] == r0 + bf16
    assert float((out.detach() - want).abs().max()) <= BF16_FWD_TOL[op_dtype]
    if op_dtype == "bfloat16":
        frel = torch.linalg.norm(out.detach() - want) / torch.linalg.norm(
            want)
        assert float(frel) <= BF16_FWD_REL_TOL
    assert v.grad.dtype == args[0].dtype
    rel = torch.linalg.norm((v.grad - want_d).float()) / torch.linalg.norm(
        want_d.float())
    assert float(rel) <= BF16_DVOL_TOL
