"""The brick encoder's CUDA kernels and their plain version.

``csrc/brick_encode.cu`` reads each dense level's 8 corner entries where
they lie in its corner grid and each hashed level's row where it lies in
the brick table, with the level table ``ops/brick_encoder.py:
_kernel_levels`` builds.  The kernel has no CPU mode, so its algorithm is
written in PyTorch here (:func:`_in_place_encode`, the gradient by the
same indices) and held on the CPU to ``brick_encode_reference``, which
materialises the table; the operators' fake versions and argument checks
are checked on ``meta`` tensors.  The ``cuda``-marked tests hold the
kernels to the plain version on the card, count their launches and run a
training step through them::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_brick_kernel.py

This file imports no JAX.
"""

import ctypes

import numpy as np
import pytest
import torch

from taichi_nerfs_torch.config import BrickGridConfig
from taichi_nerfs_torch.ops import brick_encoder as tb
from taichi_nerfs_torch.ops._build import LAUNCHES
from taichi_nerfs_torch.ops.hash_encoder import fast_hash
from taichi_nerfs_torch.ops.math import as_u32

torch.set_num_threads(2)

# (levels, F, log2_rows, base_res, max_res, table dtype): dense and hashed
# levels at each F the kernels are built for, a layout of dense levels
# only, and the NGP cell's 8 x 4 at a smaller table
LAYOUTS = {
    "F1": (4, 1, 9, 4, 32, "float32"),
    "F2": (4, 2, 9, 4, 32, "float32"),
    "F4": (4, 4, 9, 4, 32, "float32"),
    "F4_bf16": (4, 4, 9, 4, 32, "bfloat16"),
    "F8_bf16": (3, 8, 9, 4, 32, "bfloat16"),
    "dense_only": (2, 4, 12, 4, 8, "float32"),
    "cell_8x4": (8, 4, 12, 16, 1024, "float32"),
}
# the kernels' 8-corner sum runs in another order than the plain version's
# torch.sum: a few ulps of features below 8 (weights <= 1, values < 1)
FEATURE_TOL = 1e-6
# the gradient's sums in another order (and, on the card, the atomics'),
# relative to the largest entry of each table gradient
GRAD_REL_TOL = 1e-5


def _layout(name):
    L, F, log2_rows, base, top, dtype = LAYOUTS[name]
    return tb.build_brick_layout(BrickGridConfig(
        levels=L, feature_per_level=F, log2_rows=log2_rows, base_res=base,
        max_res=top, table_dtype=dtype))


def _params(layout, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {k: v.to(device) for k, v in
            tb.init_brick_params(layout, gen).items()}


def _positions(m, seed, device="cpu"):
    """``m`` positions: rays of 34 samples 1/200 apart (neighbouring samples
    share the coarse cells, as the marcher's do), cube corners and faces,
    and a few outside the cube (clamped)."""
    rng = np.random.default_rng(seed)
    n_rays = (m + 33) // 34
    o = rng.uniform(0.1, 0.9, (n_rays, 1, 3))
    d = rng.normal(size=(n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = (o + d * (np.arange(34)[None, :, None] / 200.0)).reshape(-1, 3)[:m]
    if m >= 30:
        x[:20] = rng.integers(0, 2, (20, 3))
        x[20:30] += 0.7
    return torch.tensor(x, dtype=torch.float32, device=device)


def _corner_entries(layout, g, lv):
    """(M, 8) corner entries of dense level ``lv`` at cells ``g`` (M, 3),
    corner k = cx + 2 cy + 4 cz, from the kernels' level table."""
    res, _, start = tb._kernel_levels(layout)[1][3 * lv : 3 * lv + 3]
    n = res + 1
    return torch.stack(
        [start + ((g[:, 2] + (k >> 2)) * n + g[:, 1] + ((k >> 1) & 1)) * n
         + g[:, 0] + (k & 1) for k in range(8)], dim=1)


def _levels(xyz, layout):
    """Per level: (dense, (M, 8) entries or (M,) rows, (M, 8) weights),
    the kernels' indices."""
    scales, info = tb._kernel_levels(layout)
    x = torch.clamp(xyz, 0.0, 1.0)
    out = []
    for lv in range(layout.levels):
        pos = x * torch.tensor(scales[lv]) + 0.5
        g = torch.floor(pos)
        hi = pos - g
        lo = 1.0 - hi
        w = torch.stack(
            [(torch.where(torch.tensor(k & 4 > 0), hi[:, 2], lo[:, 2])
              * torch.where(torch.tensor(k & 2 > 0), hi[:, 1], lo[:, 1]))
             * torch.where(torch.tensor(k & 1 > 0), hi[:, 0], lo[:, 0])
             for k in range(8)], dim=1)
        g = g.to(torch.int64)
        rows, start = info[3 * lv + 1], info[3 * lv + 2]
        if rows == 0:
            out.append((True, _corner_entries(layout, g, lv), w))
        else:
            c = as_u32(g)
            h = fast_hash(c[:, 0], c[:, 1], c[:, 2]) % rows
            out.append((False, start + h, w))
    return out


def _in_place_encode(params, xyz, layout):
    """The kernels' forward in PyTorch: each corner read where it lies,
    rounded to bf16 with a bf16 table, the 8 products summed in order."""
    F = layout.F
    corners, bricks = params["corners"], params["bricks"]
    feats = []
    for dense, idx, w in _levels(xyz, layout):
        e = (corners[idx] if dense
             else bricks[idx].reshape(-1, 8, F))  # (M, 8, F)
        if layout.table_dtype == "bfloat16":
            e = e.bfloat16().float()
        acc = torch.zeros((xyz.shape[0], F))
        for k in range(8):
            acc = acc + e[:, k] * w[:, k : k + 1]
        feats.append(acc)
    return torch.cat(feats, dim=1)


def _in_place_grads(params, xyz, dout, layout):
    """The kernels' backward in PyTorch: w[k] * dout added into the entries
    the forward read."""
    F = layout.F
    dc = torch.zeros_like(params["corners"])
    db = torch.zeros_like(params["bricks"])
    for lv, (dense, idx, w) in enumerate(_levels(xyz, layout)):
        d = dout[:, lv * F : (lv + 1) * F]
        v = w[:, :, None] * d[:, None, :]  # (M, 8, F)
        if dense:
            dc.index_add_(0, idx.reshape(-1), v.reshape(-1, F))
        else:
            db.index_add_(0, idx, v.reshape(-1, 8 * F))
    return dc, db


def _reference_and_grads(params, xyz, dout, layout):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    out = tb.brick_encode_reference(leaves, xyz, layout)
    grads = torch.autograd.grad(torch.sum(out * dout),
                                (leaves["corners"], leaves["bricks"]))
    return out.detach(), grads


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_in_place_reads_equal_the_reference(name):
    layout = _layout(name)
    params = _params(layout, seed=1)
    xyz = _positions(700, seed=2)
    dout = torch.randn((700, layout.out_dim),
                       generator=torch.Generator().manual_seed(3))
    want, (dc, db) = _reference_and_grads(params, xyz, dout, layout)
    got = _in_place_encode(params, xyz, layout)
    assert float((got - want).abs().max()) <= FEATURE_TOL
    gc, gb = _in_place_grads(params, xyz, dout, layout)
    assert _rel(gc, dc) <= GRAD_REL_TOL
    if layout.hashed_rows:
        assert _rel(gb, db) <= GRAD_REL_TOL
    assert float(dc.abs().max()) > 0


def test_level_table():
    """The kernels' table of the NGP cell's layout: two dense corner
    grids, then six hashed levels of 2^17 rows each."""
    layout = tb.build_brick_layout(BrickGridConfig())
    scales, info = tb._kernel_levels(layout)
    assert scales == tuple(float(s) for s in tb.level_scales(layout))
    assert info[:6] == (16, 0, 0, 29, 0, 17**3)
    assert info[6:] == tuple(v for lv in range(6) for v in
                             (layout.resolutions[lv + 2], 2**17,
                              lv * 2**17))


def _meta(layout, m=40):
    meta = dict(device="meta")
    corners = torch.empty((layout.n_corner_params, layout.F), **meta)
    bricks = torch.empty((max(layout.hashed_rows, 1), layout.row_width),
                         **meta)
    return corners, bricks, torch.empty((m, 3), **meta)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_fakes_give_the_shapes(name):
    layout = _layout(name)
    corners, bricks, xyz = _meta(layout)
    scales, info = tb._kernel_levels(layout)
    ops = torch.ops.taichi_nerfs_torch
    out = ops.brick_encode_fwd(corners, bricks, xyz, scales, info, False)
    assert out.shape == (40, layout.out_dim) and out.device.type == "meta"
    dc, db = ops.brick_encode_bwd(out, xyz, corners.shape[0],
                                  bricks.shape[0], scales, info)
    assert dc.shape == corners.shape and db.shape == bricks.shape
    assert dc.dtype == db.dtype == torch.float32


def _bad(change):
    layout = _layout("F4")
    corners, bricks, xyz = _meta(layout)
    scales, info = tb._kernel_levels(layout)
    args = dict(corners=corners, bricks=bricks, xyz=xyz, scales=scales,
                info=info)
    change(args)
    return args


BAD = {
    "F=3": (lambda a: a.update(corners=torch.empty((10, 3), device="meta"),
                               bricks=torch.empty((10, 24), device="meta")),
            ValueError),
    "17 levels": (lambda a: a.update(scales=(1.0,) * 17,
                                     info=(2, 0, 0) * 17), ValueError),
    "info length": (lambda a: a.update(info=a["info"][:-1]), ValueError),
    "fp64 table": (lambda a: a.update(corners=a["corners"].double()),
                   TypeError),
    "bf16 positions": (lambda a: a.update(xyz=a["xyz"].bfloat16()),
                       TypeError),
    "strided positions": (lambda a: a.update(
        xyz=torch.empty((3, 40), device="meta").T), ValueError),
    "rows past the table": (lambda a: a.update(
        bricks=a["bricks"][:-1]), ValueError),
    "corners past the grid": (lambda a: a.update(
        corners=a["corners"][:-1]), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_argument_checks_raise(case):
    change, err = BAD[case]
    a = _bad(change)
    with pytest.raises(err):
        torch.ops.taichi_nerfs_torch.brick_encode_fwd(
            a["corners"], a["bricks"], a["xyz"], a["scales"], a["info"],
            False)


def test_operators_hand_the_kernels_their_arguments():
    """What the operators pass to the C entries, recorded on CPU tensors by
    the ``launch`` the implementations are given, the outputs allocated by
    the fake versions: the device, the tensors' pointers in the entries'
    order, the sizes, the bf16 flag and the level table as C arrays; with
    no positions, nothing is launched."""
    layout = _layout("F4_bf16")
    params = _params(layout)
    xyz = _positions(100, seed=5)
    scales, info = tb._kernel_levels(layout)
    seen = []

    def launch(device, *args):
        seen.append((device, args))

    def run(xyz):
        fwd = (params["corners"], params["bricks"], xyz, scales, info, True)
        out = tb._fwd_fake(*fwd)
        tb._fwd_op(launch, out, *fwd)
        bwd = (out, xyz, *(params[k].shape[0] for k in ("corners", "bricks")),
               scales, info)
        grads = tb._bwd_fake(*bwd)
        tb._bwd_op(launch, grads, *bwd)
        return out, grads

    out, (dc, db) = run(xyz)
    (fdev, fa), (bdev, ba) = seen
    assert fdev == bdev == xyz.device
    assert fa[:4] == tuple(t.data_ptr() for t in (
        xyz, params["corners"], params["bricks"], out))
    assert fa[4:8] == (100, layout.levels, layout.F, 1)
    assert ba[:4] == tuple(t.data_ptr() for t in (out, xyz, dc, db))
    assert ba[4:7] == (100, layout.levels, layout.F)
    assert dc.shape == params["corners"].shape
    assert db.shape == params["bricks"].shape
    assert not dc.any() and not db.any()  # the kernel adds into them
    for args in (fa[-2:], ba[-2:]):
        c_scales, c_info = tb._c_levels(scales, info)
        assert args == (ctypes.addressof(c_scales),
                        ctypes.addressof(c_info))
        assert tuple(c_info) == info
        assert tuple(c_scales) == scales
    run(xyz[:0])
    assert len(seen) == 2


def test_unaligned_tables_raise():
    """The kernel reads the tables in 16-byte vectors: a table that starts
    elsewhere (a view into a larger buffer) raises before any launch."""
    layout = _layout("F4")
    params = _params(layout)
    xyz = _positions(50, seed=6)
    scales, info = tb._kernel_levels(layout)
    flat = torch.zeros(params["corners"].numel() + 1)
    corners = flat[1:].view_as(params["corners"])
    args = (corners, params["bricks"], xyz, scales, info, False)

    def launch(*a):
        pytest.fail("launched")

    with pytest.raises(ValueError, match="16-byte aligned"):
        tb._fwd_op(launch, tb._fwd_fake(*args), *args)


def test_no_kernel_off_the_card():
    """Positions on a device that is neither the CPU nor CUDA raise: there
    is no fallback."""
    layout = _layout("F4")
    corners, bricks, xyz = _meta(layout)
    with pytest.raises(ValueError, match="no brick-encode kernel"):
        tb.brick_encode({"corners": corners, "bricks": bricks}, xyz, layout)


# ---- on the card ----------------------------------------------------------


def _brick_launches():
    """The gathers and the scatters launched so far."""
    return LAUNCHES["brick_encode_fwd"], LAUNCHES["brick_encode_bwd"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the brick-encode kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 33, 4099, 70_001])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_kernels_match_the_reference_on_card(cuda_device, name, m):
    layout = _layout(name)
    params = _params(layout, cuda_device, seed=m)
    xyz = _positions(m, seed=m, device=cuda_device)
    dout = torch.randn((m, layout.out_dim), device=cuda_device)
    want, (dc, db) = _reference_and_grads(params, xyz, dout, layout)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    before = _brick_launches()
    got = tb.brick_encode(leaves, xyz, layout)
    gc, gb = torch.autograd.grad(torch.sum(got * dout),
                                 (leaves["corners"], leaves["bricks"]))
    torch.cuda.synchronize()
    assert _brick_launches() == (before[0] + 1, before[1] + 1)
    assert float((got - want).abs().max()) <= FEATURE_TOL
    assert _rel(gc, dc) <= GRAD_REL_TOL
    if layout.hashed_rows:
        assert _rel(gb, db) <= GRAD_REL_TOL


@pytest.mark.cuda
def test_no_positions_no_launch(cuda_device):
    layout = _layout("F4")
    leaves = {k: v.requires_grad_() for k, v in
              _params(layout, cuda_device).items()}
    before = dict(LAUNCHES)
    out = tb.brick_encode(leaves, torch.empty((0, 3), device=cuda_device),
                          layout)
    assert out.shape == (0, layout.out_dim)
    gc, gb = torch.autograd.grad(out.sum(), (leaves["corners"],
                                             leaves["bricks"]))
    assert dict(LAUNCHES) == before
    assert not gc.any() and not gb.any()


@pytest.mark.cuda
def test_training_step_runs_the_kernels(cuda_device):
    """An NGP training step launches the gather and the scatter, and the
    patched backward the benchmark plants as a fault reaches the table
    gradient."""
    from taichi_nerfs_torch.config import config_for_scene
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.train.loop import Trainer

    ds = SyntheticSphereDataset(n_images=2, img_wh=(64, 64),
                                variant="checker", device=cuda_device)
    trainer = Trainer(config_for_scene(0.5), ds.as_batch(cuda_device), ds.K,
                      ds.img_wh, device=cuda_device)
    before = _brick_launches()
    trainer.run_step()
    torch.cuda.synchronize()
    after = _brick_launches()
    assert after[0] >= before[0] + 1 and after[1] >= before[1] + 1

    layout = tb.build_brick_layout(BrickGridConfig())
    params = _params(layout, cuda_device)
    xyz = _positions(5000, seed=4, device=cuda_device)
    real = tb._BrickEncode.backward

    def half(ctx, dout):
        dout = dout.clone()
        dout[1::2] = 0.0
        return real(ctx, dout)

    grads = []
    for patch in (real, half):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tb._BrickEncode, "backward", patch)
            leaves = {k: v.clone().requires_grad_() for k, v in
                      params.items()}
            out = tb.brick_encode(leaves, xyz, layout)
            grads.append(torch.autograd.grad(out.sum(), leaves["bricks"])[0])
    assert _rel(grads[1], grads[0]) > 0.1
