"""The hash encoder's CUDA kernels and their plain version.

``csrc/hash_encode.cu`` computes each position's cells, table entries and
weights in registers, with the level table ``ops/hash_encoder.py:
_kernel_levels`` builds and the primes ``_PRIMES`` holds at the call.  The
kernel has no CPU mode, so its index arithmetic is written in numpy's
uint32 here (:func:`_kernel_corners`) and held on the CPU to
``hash_indices`` bit for bit; the operators' fake versions, argument checks
and the C arguments they pass are checked on ``meta`` and CPU tensors.  The
``cuda``-marked tests hold the kernels to ``hash_encode_reference`` on the
card, count their launches and run a training step through them::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_hash_kernel.py

This file imports no JAX.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from taichi_nerfs_torch.config import HashGridConfig
from taichi_nerfs_torch.ops import hash_encoder as th
from taichi_nerfs_torch.ops._build import LAUNCHES

torch.set_num_threads(2)

# (levels, F, log2_T, base_res, max_res): dense and hashed levels at each F
# the kernels are built for, and the NGP cell's 16 x 2 at T = 2^19
LAYOUTS = {
    "F1": (4, 1, 11, 4, 32),
    "F2": (4, 2, 11, 4, 32),
    "F4": (4, 4, 11, 4, 32),
    "F8": (3, 8, 11, 4, 32),
    "cell_16x2": (16, 2, 19, 16, 1024),
}


def _layout(name):
    L, F, log2_T, base, top = LAYOUTS[name]
    return th.build_layout(HashGridConfig(
        levels=L, feature_per_level=F, log2_T=log2_T, base_res=base,
        max_res=top))


def _table(layout, dtype="float32", device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    return th.init_hash_table(layout, gen).to(device, getattr(torch, dtype))


def _positions(m, seed, device="cpu"):
    """``m`` positions: rays of 34 samples 1/200 apart (neighbouring samples
    share the coarse cells, as the marcher's do), cube corners, points on
    the cells' faces of every level, and a few slightly outside [0, 1] (a
    cell below 0 wraps to uint32)."""
    rng = np.random.default_rng(seed)
    n_rays = (m + 33) // 34
    o = rng.uniform(0.1, 0.9, (n_rays, 1, 3))
    d = rng.normal(size=(n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = (o + d * (np.arange(34)[None, :, None] / 200.0)).reshape(-1, 3)[:m]
    if m >= 60:
        x[:8] = rng.integers(0, 2, (8, 3))
        res = rng.choice([16, 22, 32, 64, 128], (20, 1))
        x[8:28] = rng.integers(0, 17, (20, 3)) / res
        x[28:60] = rng.uniform(-0.05, 1.05, (32, 3))
    return torch.tensor(x, dtype=torch.float32, device=device)


def _kernel_corners(xyz, layout, primes=th._PRIMES):
    """The kernels' index arithmetic in numpy's uint32 and fp32, each
    operation rounded as the kernel rounds it: (M, L, 8) entries and
    weights."""
    scales, info = th._kernel_levels(layout)
    p = [np.uint32(v) for v in primes]
    x = xyz.numpy()
    entries, weights = [], []
    for lv in range(layout.levels):
        pos = x * np.float32(scales[lv]) + np.float32(0.5)
        pg = np.floor(pos)
        g = pg.astype(np.int32).astype(np.uint32)
        hi = pos - pg
        lo = np.float32(1.0) - hi
        res, size, off, hashed = (np.uint32(v) for v in
                                  info[4 * lv : 4 * lv + 4])
        e, w = [], []
        for k in range(8):
            c = [g[:, d] + np.uint32((k >> d) & 1) for d in range(3)]
            h = ((c[0] * p[0]) ^ (c[1] * p[1]) ^ (c[2] * p[2]) if hashed
                 else c[0] + c[1] * res + (c[2] * res) * res)
            e.append((h % size).astype(np.int64) + int(off))
            wd = [np.where((k >> d) & 1, hi[:, d], lo[:, d])
                  for d in range(3)]
            w.append((wd[0] * wd[1]) * wd[2])
        entries.append(np.stack(e, axis=1))
        weights.append(np.stack(w, axis=1))
    return (torch.from_numpy(np.stack(entries, axis=1)),
            torch.from_numpy(np.stack(weights, axis=1)))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_kernel_arithmetic_equals_hash_indices(name):
    """The kernels' cells, entries and weights are the plain version's bit
    for bit, positions outside [0, 1] (wrapped cells) included."""
    layout = _layout(name)
    xyz = _positions(700, seed=1)
    want_idx, want_w = th.hash_indices(xyz, layout)
    with np.errstate(over="ignore"):
        got_idx, got_w = _kernel_corners(xyz, layout)
    assert torch.equal(got_idx, want_idx)
    assert torch.equal(got_w, want_w)
    assert bool((xyz < 0).any()) and layout.begin_fast_hash_level < (
        layout.levels)


def test_level_table():
    """The kernels' table of the NGP cell's layout: six dense levels, then
    ten hashed levels of 2^19 entries each; the scales are
    ``level_scales``' fp32 values."""
    layout = th.build_layout(HashGridConfig())
    scales, info = th._kernel_levels(layout)
    assert scales == tuple(float(s) for s in th.level_scales(layout))
    for lv in range(16):
        assert info[4 * lv : 4 * lv + 4] == (
            layout.resolutions[lv], layout.map_sizes[lv], layout.offsets[lv],
            int(lv >= 6))
    assert layout.begin_fast_hash_level == 6
    assert set(info[4 * 6 + 1 :: 4]) == {2**19}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_positions_run_the_plain_version(dtype):
    """On the CPU ``hash_encode`` is ``hash_encode_reference``: the same
    features and table gradient bit for bit, and no launch."""
    layout = _layout("F2")
    table = _table(layout, dtype, seed=2)
    xyz = _positions(300, seed=3).reshape(10, 30, 3)
    cot = torch.randn((10, 30, layout.out_dim),
                      generator=torch.Generator().manual_seed(4))
    before = dict(LAUNCHES)
    outs = []
    for encode in (th.hash_encode, th.hash_encode_reference):
        leaf = table.clone().requires_grad_()
        out = encode(leaf, xyz, layout)
        (g,) = torch.autograd.grad(torch.sum(out * cot), leaf)
        outs.append((out, g))
    assert dict(LAUNCHES) == before
    (a, ga), (b, gb) = outs
    assert a.shape == (10, 30, layout.out_dim)
    assert torch.equal(a, b) and torch.equal(ga, gb)
    assert ga.dtype == table.dtype


def _meta(layout, m=40, dtype=torch.float32):
    table = torch.empty((layout.feature_per_level, layout.n_entries),
                        dtype=dtype, device="meta")
    return table, torch.empty((m, 3), device="meta")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_fakes_give_the_shapes(name, dtype):
    layout = _layout(name)
    table, xyz = _meta(layout, dtype=getattr(torch, dtype))
    args = th._kernel_args(layout)
    ops = torch.ops.taichi_nerfs_torch
    out = ops.hash_encode_fwd(table, xyz, *args)
    assert out.shape == (40, layout.out_dim) and out.dtype == torch.float32
    assert out.device.type == "meta"
    grad = ops.hash_encode_bwd(out, xyz, layout.n_entries, table.dtype, *args)
    assert grad.shape == table.shape and grad.dtype == table.dtype


def _bad(change):
    layout = _layout("F2")
    table, xyz = _meta(layout)
    scales, info, primes = th._kernel_args(layout)
    args = dict(table=table, xyz=xyz, scales=scales, info=info,
                primes=primes)
    change(args)
    return args


BAD = {
    "F=3": (lambda a: a.update(table=torch.empty((3, 4096), device="meta")),
            ValueError),
    "17 levels": (lambda a: a.update(scales=(1.0,) * 17,
                                     info=(2, 8, 0, 0) * 17), ValueError),
    "info length": (lambda a: a.update(info=a["info"][:-1]), ValueError),
    "strided table": (lambda a: a.update(
        table=torch.empty((a["table"].shape[1], 2), device="meta").T),
        ValueError),
    "fp64 table": (lambda a: a.update(table=a["table"].double()), TypeError),
    "fp16 table": (lambda a: a.update(table=a["table"].half()), TypeError),
    "bf16 positions": (lambda a: a.update(xyz=a["xyz"].bfloat16()),
                       TypeError),
    "strided positions": (lambda a: a.update(
        xyz=torch.empty((3, 40), device="meta").T), ValueError),
    "level past the table": (lambda a: a.update(
        table=a["table"][:, :-8].contiguous()), ValueError),
    "a prime past uint32": (lambda a: a.update(
        primes=a["primes"][:2] + (2**32,)), ValueError),
    "two primes": (lambda a: a.update(primes=a["primes"][:2]), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_argument_checks_raise(case):
    change, err = BAD[case]
    a = _bad(change)
    with pytest.raises(err):
        torch.ops.taichi_nerfs_torch.hash_encode_fwd(
            a["table"], a["xyz"], a["scales"], a["info"], a["primes"])


def test_backward_checks_raise():
    """The backward takes an fp32 or bf16 gradient and the cotangent of the
    forward's shape."""
    layout = _layout("F2")
    table, xyz = _meta(layout)
    args = th._kernel_args(layout)
    dout = torch.empty((40, layout.out_dim), device="meta")
    bwd = torch.ops.taichi_nerfs_torch.hash_encode_bwd
    with pytest.raises(TypeError):
        bwd(dout, xyz, layout.n_entries, torch.float16, *args)
    with pytest.raises(ValueError):
        bwd(dout[:, :-1], xyz, layout.n_entries, torch.float32, *args)


def test_no_kernel_off_the_card():
    """Positions on a device that is neither the CPU nor CUDA raise: there
    is no fallback."""
    layout = _layout("F2")
    table, xyz = _meta(layout)
    with pytest.raises(ValueError, match="no hash-encode kernel"):
        th.hash_encode(table, xyz, layout)


def test_operators_hand_the_kernels_their_arguments():
    """What the operators pass to the C entries, recorded on CPU tensors by
    the ``launch`` the implementations are given, the outputs allocated by
    the fake versions: the device, the tensors' pointers in the entries'
    order, the sizes and flags, and the level table and primes as C arrays;
    the backward entry's second kernel (the transpose) counted under its
    own key; with no positions, nothing is launched and the gradient is
    zero."""
    layout = _layout("F4")
    table = _table(layout, "bfloat16")
    xyz = _positions(100, seed=5)
    args = th._kernel_args(layout)
    seen = []

    def launch(device, *c_args):
        seen.append((device, c_args))

    def run(xyz):
        out = th._fwd_fake(table, xyz, *args)
        th._fwd_op(launch, out, table, xyz, *args)
        bwd = (out, xyz, layout.n_entries, table.dtype, *args)
        grad = th._bwd_fake(*bwd)
        th._bwd_op(launch, grad, *bwd)
        return out, grad

    transposes = LAUNCHES["hash_encode_bwd_transpose"]
    out, grad = run(xyz)
    assert LAUNCHES["hash_encode_bwd_transpose"] == transposes + 1
    (fdev, fa), (bdev, ba) = seen
    assert fdev == bdev == xyz.device
    assert fa[:3] == (xyz.data_ptr(), table.data_ptr(), out.data_ptr())
    assert fa[3:8] == (100, layout.n_entries, layout.levels, 4, 1)
    assert ba[:2] == (out.data_ptr(), xyz.data_ptr())
    assert ba[3] == grad.data_ptr()
    assert ba[4:9] == (100, layout.n_entries, layout.levels, 4, 1)
    assert grad.shape == table.shape and grad.dtype == torch.bfloat16
    c_arrays = th._c_levels(*args)
    for c_args in (fa[-3:], ba[-3:]):
        assert c_args == tuple(ctypes.addressof(a) for a in c_arrays)
    assert tuple(c_arrays[0]) == args[0]
    assert tuple(c_arrays[1]) == args[1]
    assert tuple(c_arrays[2]) == th._PRIMES
    _, grad = run(xyz[:0])
    assert len(seen) == 2
    assert LAUNCHES["hash_encode_bwd_transpose"] == transposes + 1
    assert not grad.any()


def test_planted_faults_reach_the_operators(monkeypatch):
    """The benchmark's planted faults patch ``_PRIMES`` and the layout
    (``build_layout``): the operators get the patched primes and levels at
    the call, in the forward and again in the backward.  Recorded through
    the CUDA branch of ``hash_encode`` with the operators replaced by
    recorders that return their fake versions' outputs."""
    layout = _layout("F2")
    table = _table(layout).requires_grad_()
    xyz = _positions(50, seed=6)
    calls = []

    def fwd(table, xyz, *args):
        calls.append(("fwd", args))
        return th._fwd_fake(table, xyz, *args).zero_()

    def bwd(dout, xyz, n, dtype, *args):
        calls.append(("bwd", args[:3]))
        return th._bwd_fake(dout, xyz, n, dtype, *args).zero_()

    ops = torch.ops.taichi_nerfs_torch
    monkeypatch.setattr(ops, "hash_encode_fwd", fwd)
    monkeypatch.setattr(ops, "hash_encode_bwd", bwd)
    monkeypatch.setattr(th, "on_cuda", lambda t, what: True)
    primes = th._PRIMES[:2] + (th._PRIMES[2] + 2,)
    monkeypatch.setattr(th, "_PRIMES", primes)
    moved = dataclasses.replace(
        layout, begin_fast_hash_level=layout.begin_fast_hash_level - 1)
    out = th.hash_encode(table, xyz, moved)
    torch.autograd.grad(out.sum(), table)
    (f, fargs), (b, bargs) = calls
    assert (f, b) == ("fwd", "bwd") and fargs == bargs
    scales, info, got_primes = fargs
    assert got_primes == primes
    hashed = [info[4 * lv + 3] for lv in range(layout.levels)]
    first = layout.begin_fast_hash_level - 1
    assert hashed == [int(lv >= first) for lv in range(layout.levels)]


# ---- on the card ----------------------------------------------------------


def _hash_launches():
    """The gathers, the scatters and the scatters' transposes launched so
    far."""
    return (LAUNCHES["hash_encode_fwd"], LAUNCHES["hash_encode_bwd"],
            LAUNCHES["hash_encode_bwd_transpose"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hash-encode kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _reference_and_grad(table, xyz, dout, layout):
    leaf = table.clone().requires_grad_()
    out = th.hash_encode_reference(leaf, xyz, layout)
    (g,) = torch.autograd.grad(torch.sum(out * dout), leaf)
    return out.detach(), g


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 33, 4099, 70_001])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_kernels_match_the_reference_on_card(cuda_device, name, dtype, m):
    layout = _layout(name)
    table = _table(layout, dtype, cuda_device, seed=m)
    xyz = _positions(m, seed=m, device=cuda_device)
    dout = torch.randn((m, layout.out_dim), device=cuda_device)
    want, want_g = _reference_and_grad(table, xyz, dout, layout)
    leaf = table.clone().requires_grad_()
    before = _hash_launches()
    got = th.hash_encode(leaf, xyz, layout)
    (g,) = torch.autograd.grad(torch.sum(got * dout), leaf)
    torch.cuda.synchronize()
    assert _hash_launches() == tuple(b + 1 for b in before)
    top = float(want.abs().max())
    err = float((got.detach() - want).abs().max())
    assert err <= th.FEATURE_REL_TOL * top
    assert g.dtype == table.dtype and g.shape == table.shape
    room = th.kernel_grad_room(xyz, dout, layout, want_g)
    diff = (g.float() - want_g.float()).abs()
    assert bool((diff <= room).all()), float(
        (diff / room.clamp_min(1e-30)).max())


@pytest.mark.cuda
def test_no_positions_no_launch(cuda_device):
    layout = _layout("F2")
    leaf = _table(layout, device=cuda_device).requires_grad_()
    before = dict(LAUNCHES)
    out = th.hash_encode(leaf, torch.empty((0, 3), device=cuda_device),
                         layout)
    assert out.shape == (0, layout.out_dim)
    (g,) = torch.autograd.grad(out.sum(), leaf)
    assert dict(LAUNCHES) == before
    assert not g.any()


@pytest.mark.cuda
def test_training_step_runs_the_kernels(cuda_device):
    """A hash-grid NGP training step with no refresh launches one gather,
    one scatter and its transpose."""
    from taichi_nerfs_torch.config import config_for_scene
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.train.loop import Trainer

    ds = SyntheticSphereDataset(n_images=2, img_wh=(64, 64),
                                variant="checker", device=cuda_device)
    trainer = Trainer(config_for_scene(0.5, pos_encoder_type="hash"),
                      ds.as_batch(cuda_device), ds.K, ds.img_wh,
                      device=cuda_device)
    trainer.run_step()  # step 0 opens with the grid's refresh
    torch.cuda.synchronize()
    before = _hash_launches()
    trainer.run_step()
    torch.cuda.synchronize()
    assert _hash_launches() == tuple(b + 1 for b in before)
