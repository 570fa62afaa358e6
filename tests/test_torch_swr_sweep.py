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
