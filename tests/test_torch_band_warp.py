"""The shear-warp renderer's final band warp: plain version and kernel.

``band_warp_reference`` (``ops/warp.py``) is the renderer's two-pass
band-matrix warp moved out of ``render/swr.py`` with its operations
unchanged; it is held bit for bit to a frozen copy of that inline branch,
and to the 2-tap sums the CUDA kernel ``csrc/swr_warp.cu`` computes (the
kernel's algorithm written in PyTorch here, since the kernel has no CPU
mode).  The wrapper ``band_warp`` and the operator
``taichi_nerfs_torch::swr_band_warp`` are checked on the CPU and on
``meta`` tensors; the ``cuda``-marked tests hold the kernel to the plain
version on the card, a served frame to the frame through the plain warp,
and count the launches::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_band_warp.py

This file imports no JAX.
"""

import numpy as np
import pytest
import torch
from torch_port_helpers import numpy_pyramid_params

from taichi_nerfs_torch.data.cameras import look_at
from taichi_nerfs_torch.models import pyramid as tpyr
from taichi_nerfs_torch.ops import warp as tw
from taichi_nerfs_torch.ops._build import LAUNCHES
from taichi_nerfs_torch.render import swr as tswr
from taichi_nerfs_torch.utils.convert import pyramid_params_from_numpy

WARPS = ["matmul", "matmul_x"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# fp32: the kernel and cuBLAS add each pass's two nonzero products in their
# own orders (an fma, or two rounded products), so each pass may differ by
# an ulp of its largest term; two passes of weights <= 1 stay within a few
# ulps of max |img| (~1e-6 relative to it).  bf16 operands: every product
# is exact in fp32, so each sum is one rounding whatever the order, and the
# same limit holds with room.
KERNEL_TOL = 1e-6
# the benchmark's limit of a served frame's rgb RMS gap
RGB_RMS_TOL = 1e-5


def _inline_branch(img, lj, behind, pose, K, frame, axis, warp, rs_dtype):
    """The renderer's band-matrix branch as it stood inline in
    ``render_swr_fixed_axis`` before it moved to ``ops/warp.py``, frozen
    here (with its trailing ``behind`` mask)."""
    def _round_to(x, dtype):
        return x if dtype == torch.float32 else x.to(dtype).float()

    z_g, g_b0, g_db, g_c0, g_dc = frame
    f32, dev = torch.float32, img.device
    nq = img.shape[1]
    h_img, w_img = lj.shape
    b_axis, c_axis = [d for d in range(3) if d != axis]
    o = pose[:, 3]
    o_a, o_b, o_c = o[axis], o[b_axis], o[c_axis]
    r = pose[:, :3]  # world = r @ cam
    ra, rb, rc = r[axis], r[b_axis], r[c_axis]
    xs_pix = (torch.arange(w_img, dtype=f32, device=dev) - K[0, 2]
              + 0.5) / K[0, 0]
    ys_pix = (torch.arange(h_img, dtype=f32, device=dev) - K[1, 2]
              + 0.5) / K[1, 1]
    j_ar = torch.arange(nq, dtype=f32, device=dev)
    oa_rel = o_a - z_g
    gam = o_c - g_c0 - j_ar * g_dc  # (J,)
    if warp == "matmul_x":
        fidx, sidx, free = 1, 0, ys_pix
    else:
        fidx, sidx, free = 0, 1, xs_pix
    num = (oa_rel * rc[fidx] - gam[:, None] * ra[fidx]) * free[
        None, :
    ] + (oa_rel * rc[2] - gam[:, None] * ra[2])  # (J, N)
    den = (
        gam[:, None] * ra[sidx] - oa_rel * rc[sidx]
        + torch.zeros_like(num)
    )
    sol = num / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    if warp == "matmul_x":
        x_p, y_p = sol, free[None, :] + torch.zeros_like(sol)
    else:
        x_p, y_p = free[None, :] + torch.zeros_like(sol), sol
    da_j = ra[0] * x_p + ra[1] * y_p + ra[2]  # (J, N)
    db_j = rb[0] * x_p + rb[1] * y_p + rb[2]
    posA = ((o_b - g_b0) * da_j - oa_rel * db_j) / (
        g_db * torch.where(torch.abs(da_j) < 1e-12, 1e-12, da_j)
    )  # (J, N): source-i position for (row j, output line n)
    posA = torch.where(torch.isfinite(posA), posA, -1e9)
    i_ar = torch.arange(nq, dtype=f32, device=dev)
    WA = _round_to(torch.clamp(
        1.0 - torch.abs(i_ar[None, :, None] - posA[:, None, :]), min=0.0
    ), rs_dtype)  # (J, I, N)
    inter = torch.bmm(_round_to(img.permute(2, 0, 1), rs_dtype),
                      WA)  # (J, C, N)
    posB = lj if warp == "matmul_x" else lj.T  # (N', N)
    posB = torch.where(torch.isfinite(posB), posB, -1e9)
    WB = _round_to(torch.clamp(
        1.0 - torch.abs(j_ar[None, :, None] - posB[:, None, :]), min=0.0
    ), rs_dtype)  # (N, J, N')
    pixT = torch.bmm(_round_to(inter.permute(2, 1, 0), rs_dtype),
                     WB)  # (N, C, N')
    if warp == "matmul_x":
        pix = pixT.permute(1, 0, 2)  # (C, H, W)
    else:
        pix = pixT.permute(1, 2, 0)  # (C, H, W)
    return torch.where(behind[None], 0.0, pix)


def _taps_warp(img, lj, behind, pose, K, frame, axis, warp, rs_dtype):
    """What ``csrc/swr_warp.cu`` computes, in PyTorch: per pixel the two j
    taps of lj, at each the position solve for its two i taps, and the
    sums of those taps only (a tap outside [0, nq) adds nothing)."""
    rnd = lambda x: tw._round_to(x, rs_dtype)  # noqa: E731
    z_g, g_b0, g_db, g_c0, g_dc = frame
    f32 = torch.float32
    C, nq = img.shape[:2]
    H, W = lj.shape
    b_axis, c_axis = [d for d in range(3) if d != axis]
    ra, rb, rc = pose[axis], pose[b_axis], pose[c_axis]
    o_a, o_b, o_c = ra[3], rb[3], rc[3]
    mode_x = warp == "matmul_x"
    fidx, sidx = (1, 0) if mode_x else (0, 1)
    v, u = torch.meshgrid(torch.arange(H, dtype=f32),
                          torch.arange(W, dtype=f32), indexing="ij")
    free = ((v - K[1, 2] + 0.5) / K[1, 1] if mode_x
            else (u - K[0, 2] + 0.5) / K[0, 0])
    oa_rel = o_a - z_g

    def guard(x):
        return torch.where(torch.abs(x) < 1e-12, 1e-12, x)

    def pos_a(j):
        gam = o_c - g_c0 - j * g_dc
        num = ((oa_rel * rc[fidx] - gam * ra[fidx]) * free
               + (oa_rel * rc[2] - gam * ra[2]))
        sol = num / guard(gam * ra[sidx] - oa_rel * rc[sidx] + 0.0)
        x_p, y_p = (sol, free + 0.0) if mode_x else (free + 0.0, sol)
        da = ra[0] * x_p + ra[1] * y_p + ra[2]
        db = rb[0] * x_p + rb[1] * y_p + rb[2]
        p = ((o_b - g_b0) * da - oa_rel * db) / (g_db * guard(da))
        return torch.where(torch.isfinite(p), p, -1e9)

    def taps(p):
        inside = (p > -1.0) & (p < nq)
        m0 = torch.where(inside, torch.floor(p), 0.0)
        w = [rnd(torch.clamp(1.0 - torch.abs((m0 + t) - p), min=0.0))
             for t in (0, 1)]
        ok = [inside & (m0 + t >= 0) & (m0 + t < nq) for t in (0, 1)]
        return m0.long(), w, ok

    def tap_sum(a, w, ok):
        return (torch.where(ok[0], a[0] * w[0], 0.0)
                + torch.where(ok[1], a[1] * w[1], 0.0))

    pb = torch.where(torch.isfinite(lj), lj, -1e9)
    j0, wj, okj = taps(pb)
    x = []
    for t in (0, 1):
        i0, wi, oki = taps(torch.where(okj[t], pos_a((j0 + t).to(f32)),
                                       -1e9))
        a = [rnd(img[:, (i0 + s).clamp(0, nq - 1), (j0 + t).clamp(0, nq - 1)])
             for s in (0, 1)]
        x.append(rnd(tap_sum(a, wi, oki)))
    return torch.where(behind[None], 0.0, tap_sum(x, wj, okj))


def _scene(device, seed=0):
    cfg = tpyr.PyramidConfig(resolutions=(8, 16), features=4, rgb_width=16,
                             scale=0.5, deferred=True)
    tree = numpy_pyramid_params((8, 16), (4, 4), 16, 2, seed=seed, blob=2.0)
    params = pyramid_params_from_numpy(tree, device)
    return cfg, params, tpyr.bake(params, cfg)


def _captured(device, nq, wh, eye, focal, C, seed):
    """The warp's arguments as ``render_swr_fixed_axis`` builds them for a
    camera at ``eye`` looking at the centre (focal ``focal * w``), its
    lattice ``nq``, with the global frame replaced by ``C`` seeded channels
    (their own scale each, some negative)."""
    cfg, params, grid = _scene(device)
    w, h = wh
    pose = look_at(np.array(eye, np.float32), np.zeros(3, np.float32),
                   np.array([0.0, 0.0, 1.0], np.float32))
    K = np.array([[focal * w, 0, w / 2], [0, focal * w, h / 2], [0, 0, 1]],
                 np.float32)
    axis, flip = tswr.sweep_axis(pose)
    seen = {}

    def record(img, lj, behind, pose, K, frame, axis, warp, rs_dtype):
        seen.update(lj=lj, behind=behind, pose=pose, K=K, frame=frame,
                    axis=axis)
        return tw.band_warp_reference(img, lj, behind, pose, K, frame, axis,
                                      warp, rs_dtype)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(tswr, "band_warp", record)
        tswr.render_swr_fixed_axis(params, grid, cfg, pose, K, wh, axis,
                                   flip, n_chunks=4, lat_size=nq,
                                   lat_pad=2 if nq < 64 else 16)
    gen = torch.Generator().manual_seed(seed)
    scale = torch.rand((C, 1, 1), generator=gen) * 4.0
    img = (torch.randn((C, nq, nq), generator=gen) * scale).to(device)
    return dict(seen, img=img)


def _planted(args):
    """``args`` with the edge cases planted: lj non-finite, at both clamp
    ends and on whole lattice indices, and a block of pixels behind."""
    lj, behind = args["lj"].clone(), args["behind"].clone()
    nq = args["img"].shape[1]
    lj[0, :3] = float("nan")
    lj[1, 0], lj[1, 1], lj[1, 2] = -1.0, float(nq), float(nq - 1)
    lj[2, :4] = torch.tensor([0.0, 1.0, 2.0, 3.0])
    behind[-2:, -3:] = True
    return dict(args, lj=lj, behind=behind)


def _degenerate(args):
    """``args`` on a camera whose solves hit every guard: K's focal tiny, so
    the outer lines' free coordinates overflow to infinity (positions that
    are not finite, replaced by -1e9), and a pose and lattice of exact
    binary values on which the denominator of lattice column 10 ("matmul")
    or of every column ("matmul_x") is exactly 0."""
    pose = torch.tensor([[1.0, 0.0, 0.0, 0.25], [0.0, 0.5, -1.0, 2.0],
                         [0.0, -0.25, 0.5, 0.5]])
    K = torch.tensor([[1.5e-38, 0.0, 3.5], [0.0, 1.5e-38, 0.5],
                      [0.0, 0.0, 1.0]])
    dev = args["img"].device
    frame = tuple(torch.tensor(x, device=dev)
                  for x in (0.0, -0.5, 0.125, 0.25, 0.125))
    return dict(args, pose=pose.to(dev), K=K.to(dev), frame=frame, axis=1)


# camera eyes and focals (z-, x- and y-dominant; the last close, wide and
# oblique, so that some rays leave the global frame's plane and some reach
# past its lattice)
EYES = {"z": ((0.3, 0.2, -1.3), 0.9), "x": ((1.3, 0.35, 0.2), 0.9),
        "y_wide": ((0.5, -0.55, 0.05), 0.15)}
CASES = {
    **{f"camera_{k}": (lambda a: a) for k in EYES},
    "planted": _planted,
    "degenerate": _degenerate,
}


def _call(fn, a, warp, dtype):
    return fn(a["img"], a["lj"], a["behind"], a["pose"], a["K"], a["frame"],
              a["axis"], warp, dtype)


@pytest.fixture(scope="module")
def cpu_inputs():
    """Each CPU case at a small odd lattice and a non-square image."""
    out = {}
    for name, (eye, focal) in EYES.items():
        out[name] = _captured("cpu", 13, (11, 7), eye, focal, 5, seed=1)
    base = out["z"]
    out = {f"camera_{k}": v for k, v in out.items()}
    out["planted"], out["degenerate"] = _planted(base), _degenerate(base)
    return out


def test_cases_reach_the_guards(cpu_inputs):
    """The cases hold what they are for: pixels behind the plane, lj
    beyond the lattice, and positions that are not finite."""
    wide = cpu_inputs["camera_y_wide"]
    assert wide["behind"].any() and not wide["behind"].all()
    lj = cpu_inputs["planted"]["lj"]
    assert torch.isnan(lj).any() and (lj == -1.0).any()
    assert ((wide["lj"] <= 0) | (wide["lj"] >= 12)).any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("warp", WARPS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_the_inline_branch(cpu_inputs, case, warp, dtype):
    a = cpu_inputs[case]
    got = _call(tw.band_warp_reference, a, warp, DTYPES[dtype])
    want = _call(_inline_branch, a, warp, DTYPES[dtype])
    assert got.shape == (a["img"].shape[0], *a["lj"].shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("warp", WARPS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_two_tap_sums_equal_the_reference(cpu_inputs, case, warp, dtype):
    """The kernel's algorithm against the dense matrices: the same tents,
    so the same pixels up to the order of each pass's two-term sum."""
    a = cpu_inputs[case]
    got = _call(_taps_warp, a, warp, DTYPES[dtype])
    want = _call(tw.band_warp_reference, a, warp, DTYPES[dtype])
    lim = KERNEL_TOL * float(a["img"].abs().max())
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= lim


def test_wrapper_takes_the_reference_on_the_cpu(cpu_inputs):
    a = cpu_inputs["camera_x"]
    n = LAUNCHES["swr_warp"]
    got = _call(tw.band_warp, a, "matmul", torch.float32)
    assert torch.equal(got, _call(tw.band_warp_reference, a, "matmul",
                                  torch.float32))
    assert LAUNCHES["swr_warp"] == n


def test_wrapper_takes_the_reference_under_autograd(cpu_inputs):
    """A warp that must keep a gradient takes the plain version on any
    device: on ``meta`` tensors, where without a gradient the wrapper
    raises (no kernel there), it returns the reference's shapes, and on
    the CPU the gradient reaches the global frame."""
    a = cpu_inputs["camera_z"]
    meta = {k: (tuple(x.to("meta") for x in v) if k == "frame" else
                v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in a.items()}
    with pytest.raises(ValueError, match="no band-warp kernel"):
        _call(tw.band_warp, meta, "matmul", torch.float32)
    meta["img"] = meta["img"].requires_grad_(True)
    out = _call(tw.band_warp, meta, "matmul", torch.float32)
    assert out.device.type == "meta"
    assert out.shape == (a["img"].shape[0], *a["lj"].shape)
    img = a["img"].clone().requires_grad_(True)
    _call(tw.band_warp, dict(a, img=img), "matmul", torch.float32).sum(
        ).backward()
    assert img.grad is not None and bool(img.grad.abs().sum() > 0)


def _meta_args(C=5, nq=13, H=7, W=11):
    m = dict(device="meta")
    return [torch.empty((C, nq, nq), **m), torch.empty((H, W), **m),
            torch.empty((H, W), dtype=torch.bool, **m),
            torch.empty((tw.GEO_LEN,), **m), 1, "matmul", torch.float32]


@pytest.mark.parametrize("warp", WARPS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fake_gives_the_shape_and_dtype(warp, dtype):
    args = _meta_args()
    args[5], args[6] = warp, DTYPES[dtype]
    out = torch.ops.taichi_nerfs_torch.swr_band_warp(*args)
    assert out.device.type == "meta"
    assert out.shape == (5, 7, 11) and out.dtype == torch.float32


@pytest.mark.parametrize("warp", WARPS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_operator_hands_the_kernel_its_arguments(warp, dtype):
    """What the operator passes to the C entry, recorded on CPU tensors by
    the ``launch`` the implementation is given, the output allocated by the
    fake version: the device, the pointers (img, lj, behind, geo, out), then
    (C, nq, H, W, axis, warp, operand dtype)."""
    args = [torch.zeros((5, 13, 13)), torch.zeros((7, 11)),
            torch.zeros((7, 11), dtype=torch.bool),
            torch.zeros((tw.GEO_LEN,)), 2, warp, DTYPES[dtype]]
    seen = []
    out = tw._band_warp_fake(*args)
    tw._band_warp_op(lambda device, *a: seen.append((device, a)), out, *args)
    ((device, a),) = seen
    assert device == args[0].device
    assert out.shape == (5, 7, 11) and out.dtype == torch.float32
    assert a == (*(t.data_ptr() for t in (*args[:4], out)), 5, 13, 7, 11, 2,
                 WARPS.index(warp), int(dtype == "bfloat16"))


def _bad(k, v):
    def make():
        args = _meta_args()
        args[k] = v(args[k]) if callable(v) else v
        return args
    return make


BAD = {
    "warp gather": (_bad(5, "gather"), ValueError),
    "operand fp16": (_bad(6, torch.float16), TypeError),
    "axis 3": (_bad(4, 3), ValueError),
    "img not square": (_bad(0, torch.empty((5, 13, 12), device="meta")),
                       ValueError),
    "img 2-D": (_bad(0, torch.empty((13, 13), device="meta")), ValueError),
    "img fp64": (_bad(0, lambda t: t.double()), TypeError),
    "img strided": (_bad(0, lambda t: t.transpose(1, 2)), ValueError),
    "lj vs behind": (_bad(2, torch.empty((7, 10), dtype=torch.bool,
                                         device="meta")), ValueError),
    "behind uint8": (_bad(2, lambda t: t.to(torch.uint8)), TypeError),
    "lj strided": (_bad(1, torch.empty((11, 7), device="meta").T),
                   ValueError),
    "geo length": (_bad(3, torch.empty((25,), device="meta")), ValueError),
    "geo on cpu": (_bad(3, torch.empty((tw.GEO_LEN,))), ValueError),
    "empty": (_bad(0, torch.empty((0, 13, 13), device="meta")), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_argument_checks_raise(case):
    make, err = BAD[case]
    with pytest.raises(err):
        torch.ops.taichi_nerfs_torch.swr_band_warp(*make())


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the band-warp kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("warp", WARPS)
@pytest.mark.parametrize("C", [9, 10, 11])
@pytest.mark.parametrize("nq", [272, 336, 816])
def test_kernel_matches_reference_on_card(cuda_device, nq, C, warp, dtype):
    """800x800 pixels at the training, capped and uncapped lattices, two
    cameras (one wide, with pixels behind the plane)."""
    for eye, focal in (EYES["z"], EYES["y_wide"]):
        a = _captured(cuda_device, nq, (800, 800), eye, focal, C, seed=nq)
        n = LAUNCHES["swr_warp"]
        got = _call(tw.band_warp, a, warp, DTYPES[dtype])
        torch.cuda.synchronize()
        assert LAUNCHES["swr_warp"] == n + 1
        want = _call(tw.band_warp_reference, a, warp, DTYPES[dtype])
        lim = KERNEL_TOL * float(a["img"].abs().max())
        err = float((got - want).abs().max())
        assert bool(torch.isfinite(got).all()) and err <= lim, (err, lim)


@pytest.mark.cuda
@pytest.mark.parametrize("warp", WARPS)
@pytest.mark.parametrize("case", ["planted", "degenerate"])
def test_kernel_edge_cases_on_card(cuda_device, case, warp):
    base = _captured(cuda_device, 13, (11, 7), *EYES["z"], 5, seed=1)
    a = CASES[case](base)
    for dtype in DTYPES.values():
        got = _call(tw.band_warp, a, warp, dtype)
        want = _call(tw.band_warp_reference, a, warp, dtype)
        lim = KERNEL_TOL * float(a["img"].abs().max())
        assert float((got - want).abs().max()) <= lim


def _served(device):
    from taichi_nerfs_torch.data.cameras import intrinsics, orbit_poses
    from taichi_nerfs_torch.render.serve import PyramidRenderer, record_config

    cfg = record_config()
    gen = torch.Generator().manual_seed(0)
    params = tpyr.init_pyramid_params(cfg, generator=gen, device=device)
    R = cfg.grid_res
    c = (torch.arange(R, dtype=torch.float32, device=device) + 0.5) / R - 0.5
    xx, yy, zz = torch.meshgrid(c, c, c, indexing="ij")
    r = torch.sqrt(xx**2 + yy**2 + zz**2)
    params["levels"][-1][..., 0] += 8.0 * torch.exp(-((r / 0.25) ** 2))
    rend = PyramidRenderer(params, cfg, intrinsics(800, 800), (800, 800),
                           resample_kind="cubic")
    return rend, orbit_poses(3)


@pytest.mark.cuda
@pytest.mark.parametrize("lat_cap", ["auto", None], ids=["capped",
                                                         "uncapped"])
def test_served_frame_matches_the_reference_path(cuda_device, lat_cap):
    rend, poses = _served(cuda_device)
    for pose in poses:
        n = LAUNCHES["swr_warp"]
        got = rend.render(pose, lat_cap=lat_cap)["rgb"]
        assert LAUNCHES["swr_warp"] == n + 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tswr, "band_warp", tw.band_warp_reference)
            want = rend.render(pose, lat_cap=lat_cap)["rgb"]
        gap = float(torch.sqrt(((got - want) ** 2).mean()))
        assert gap <= RGB_RMS_TOL and float(want.max()) > 0.0


@pytest.mark.cuda
def test_training_step_never_launches_the_kernel(cuda_device):
    from taichi_nerfs_torch.data.synthetic import SyntheticSphereDataset
    from taichi_nerfs_torch.train.swr_step import SwrTrainConfig, SwrTrainer

    ds = SyntheticSphereDataset("synthetic://sphere?views=2&res=64",
                                split="train", device="cpu")
    trainer = SwrTrainer(
        tpyr.PyramidConfig(resolutions=(16, 32), features=8, deferred=True),
        SwrTrainConfig(crop=64, n_chunks=4, resample_kind="cubic"),
        ds.rays, ds.poses, ds.K, ds.img_wh, device=cuda_device)
    n = LAUNCHES["swr_warp"]
    for _ in range(3):
        trainer.run_step()
    torch.cuda.synchronize()
    assert LAUNCHES["swr_warp"] == n
