"""The frozen counts: the sweep bounds at the shapes of PERF.md's kernel
table, and each operation count by hand at a tiny shape."""

from __future__ import annotations

import pytest

from benchmark.counts import flops as fl
from benchmark.counts.peaks import FLOPS_PER_S
import numpy as np

from benchmark.counts.sweep import (resample_flops, sweep_bwd_bound,
                                    sweep_fwd_bound, sweep_needed, touched)


@pytest.mark.parametrize("shape, fwd, bwd", [
    ((16, 16, 8, 256, 256, 272, "cubic"), 0.1744, 0.3361),
    ((1, 16, 8, 256, 256, 336, "cubic"), 0.0114, None),
    ((1, 16, 8, 256, 256, 816, "cubic"), 0.0180, None),
    ((16, 16, 16, 256, 256, 272, "linear"), 0.3460, 0.6679),
])
def test_bounds_reproduce_the_kernel_table(shape, fwd, bwd):
    ms, by, _, _ = sweep_fwd_bound(*shape)
    assert round(ms, 4) == fwd and by == "bytes"
    if bwd is not None:
        assert round(sweep_bwd_bound(*shape)[0], 4) == bwd


def test_resample_by_hand():
    # 1 chunk, 1 slab, 1 channel, Rc = 3, nq = 2, linear: the b pass has
    # 2 x 3 outputs, the c pass 2 x 2, each 2 taps of 2 flops
    assert resample_flops(1, 1, 1, 3, 2, "linear") == 2 * 2 * (6 + 4)
    assert resample_flops(1, 1, 1, 3, 2, "cubic") == 2 * 4 * (6 + 4)


TINY = {"resolutions": [2, 4], "features": 2, "rgb_width": 4,
        "rgb_depth": 1}


def test_pyramid_terms_by_hand():
    # the rgb MLP: 16 SH + 1 feature -> 4 -> 3
    assert fl.pyramid_mlp_dims(TINY) == [(17, 4), (4, 3)]
    assert fl.mlp_macs(fl.pyramid_mlp_dims(TINY)) == 17 * 4 + 4 * 3
    # one upsample 2 -> 4 of F = 2: passes of 4*2*2, 4*4*2 and 4^3 outputs,
    # 2 taps of 2 flops; the level add 2 * 4^3; sigma 3 * 4^3
    assert fl.bake_flops(TINY) == 4 * 2 * (16 + 32 + 64) + 128 + 192
    assert fl.param_count(TINY) == 2 * (8 + 64) + 17 * 4 + 4 * 3
    # fold of one chunk: F + 1 = 3 channels, nq = 5, linear: two passes of
    # 3 * 25 outputs, 2 taps of 2 flops, and (2 * 2 + 3) flops a point
    assert fl.fold_flops(TINY, 5, "linear", 1) == 2 * 2 * 2 * 3 * 25 + 7 * 25
    # the warp: 3 channels, nq x w then w x h outputs, 2 taps of 2 flops
    assert fl.warp_flops(TINY, 5, 4, 3) == 2 * 2 * 3 * (5 * 4 + 4 * 3)
    sh = dict((n, (f, p)) for n, f, p in fl.shade_terms(TINY, 10, False))
    assert sh["shade_mlp"] == (2 * 80 * 10, "bf16")
    assert sh["shade_other"] == ((60 + 4) * 10, "fp32")


def test_pyramid_step_and_frame_terms():
    model = dict(TINY, resolutions=[2, 4])
    train = {"crop": 4, "resample_kind": "linear", "n_chunks": 2}
    terms = {n: (f, p) for n, f, p in fl.pyramid_step(model, train, 5.0,
                                                       7.0)}
    assert terms["sweep_fwd"] == (5.0, "fp32")
    assert terms["sweep_bwd"] == (7.0, "fp32")
    assert terms["adam"] == (12 * fl.param_count(model), "fp32")
    assert terms["shade_mlp"][1] == "bf16"
    frame = {n: f for n, f, _ in fl.pyramid_frame(model, 4, 4, 20, "linear",
                                                  1, 3.0)}
    assert frame["sweep_fwd"] == 3.0
    assert frame["fold"] == fl.fold_flops(model, 20, "linear", 1)
    # a second of each precision's peak over a 4-second window: 50 %
    from types import SimpleNamespace

    from benchmark.harness.readers import mfu

    r = SimpleNamespace(kind="train", units=2, window_s=4.0, flops=[
        ("a", FLOPS_PER_S["fp32"], "fp32"), ("b", FLOPS_PER_S["bf16"],
                                             "bf16")])
    assert mfu(r, "train") == pytest.approx(50.0)
    assert mfu(r, "view") is None


def test_needed_window_by_hand():
    # 3 outputs at 1.5, 2.5, 3.5 on a 10-long axis: linear taps reach 1..4,
    # cubic 0..5; at whole positions a tap of weight 0 is not read; a
    # lattice running off the source is cut at its end
    assert touched(1.5, 1.0, 3, 10, "linear") == 4
    assert touched(1.5, 1.0, 3, 10, "cubic") == 6
    assert touched(1.0, 1.0, 3, 10, "linear") == 3
    assert touched(1.0, 1.0, 3, 10, "cubic") == 5
    assert touched(8.5, 1.0, 3, 10, "linear") == 2
    assert touched(3.5, -1.0, 3, 10, "linear") == 4
    # a lattice covering the whole volume reads it all: the shape's bound
    R, nq = 64, 80
    rs = np.zeros((2, 4, 4))
    rs[..., 1] = rs[..., 3] = (R - 1) / (nq - 1)
    for bwd, full in ((False, sweep_fwd_bound), (True, sweep_bwd_bound)):
        got = sweep_needed(rs, 8, R, R, nq, "cubic", backward=bwd)
        want = full(2, 4, 8, R, R, nq, "cubic")
        assert got[2] == want[2] and got[3] == want[3]
    # a lattice on a quarter of each axis reads a sixteenth of the slabs
    rs[..., 1] = rs[..., 3] = (R / 4 - 1) / (nq - 1)
    part = sweep_needed(rs, 8, R, R, nq, "linear")
    assert part[2] == 4 * 8 * 8 * (R // 4) ** 2 + 4 * (8 * 5 + 12
                                                      + 2 * 10 * nq * nq)


@pytest.mark.parametrize("kernel, short", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul>)",
     "vectorized_elementwise_kernel[CUDAFunctor_add]"),
    ("void (anonymous namespace)::swr_sweep_fwd_kernel<8, 1, float, false>"
     "(float const*, float const*)", "swr_sweep_fwd_kernel"),
    ("void at::native::elementwise_kernel<128, 2, at::native::"
     "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(at::"
     "TensorIteratorBase&)::{lambda()#3}> >(int)",
     "elementwise_kernel[direct_copy_kernel_cuda]"),
])
def test_kernel_short_names(kernel, short):
    from benchmark.harness.trace import short_name

    assert short_name(kernel) == short
