"""The NGP counts (``counts/ngp.py``) at a tiny case, and the NGP cell's
per-layer readers on readings made by hand."""

from __future__ import annotations

import math
import time

import pytest
import torch

from benchmark.counts import ngp as counts
from benchmark.counts.flops import mlp_macs
from benchmark.harness import trace as tr
from benchmark.harness.spec import CHECKOUT, Spec
from benchmark.reference.ngp import PRIMES, BrickGeometry, brick_encode
from benchmark.systems.ngp import make_params

BRICK = {"levels": 4, "feature_per_level": 4, "log2_rows": 8, "base_res": 4,
         "max_res": 32}


def _brute_entries(x01, geo):
    """Per level, the set of entries the positions read, one position and
    corner at a time in Python."""
    out = []
    for lv in range(len(geo.res)):
        seen = set()
        for x in x01.tolist():
            cell = [math.floor(min(max(v, 0.0), 1.0) * geo.scale[lv] + 0.5)
                    for v in x]
            if geo.dense[lv]:
                n = geo.res[lv] + 1
                for c in range(8):
                    b = [(c >> d) & 1 for d in range(3)]
                    seen.add(((cell[2] + b[2]) * n + cell[1] + b[1]) * n
                             + cell[0] + b[0])
            else:
                h = 0
                for d in range(3):
                    h ^= (cell[d] * PRIMES[d]) & 0xFFFFFFFF
                seen.add(h % geo.rows)
        out.append(len(seen))
    return out


def test_distinct_entries_and_bytes_by_brute_force():
    geo = BrickGeometry.of(BRICK)
    x = torch.rand((400, 3), generator=torch.Generator().manual_seed(1))
    x[:50] = x[50:100]  # repeated positions read their entries once
    want = _brute_entries(x, geo)
    assert counts.distinct_entries(x, geo) == want
    assert geo.dense[0] and not geo.dense[-1]
    table = sum(n * (16 if d else 128) for n, d in zip(want, geo.dense))
    _, _, fwd, _ = counts.encode_bound(x, geo, backward=False)
    _, _, both, flops = counts.encode_bound(x, geo, backward=True)
    assert fwd == 12 * 400 + table and both == 12 * 400 + 2 * table
    assert flops == 2 * 2 * 8 * 4 * 4 * 400


def test_least_time_below_a_plain_encoder():
    """The bound, at the H100's peaks, under what the plain encoder takes
    here at the same positions (forward and table gradient)."""
    geo = BrickGeometry.of(BRICK)
    cfg = {"model": {"brick": BRICK, "xyz_net_depth": 1, "xyz_net_width": 8,
                     "xyz_net_out_dim": 4, "rgb_net_depth": 1,
                     "rgb_net_width": 8, "sh_degree": 4}}
    p = make_params(cfg, 3, "cpu")
    corners = p["brick.corners"].requires_grad_(True)
    bricks = p["brick.bricks"].requires_grad_(True)
    x = torch.rand((4096, 3), generator=torch.Generator().manual_seed(2))
    t = time.perf_counter()
    y = brick_encode(corners, bricks, x, geo)
    torch.autograd.grad(y.sum(), [corners, bricks])
    plain_ms = (time.perf_counter() - t) * 1e3
    ms, by, _, _ = counts.encode_bound(x, geo, backward=True)
    assert 0 < ms < plain_ms and by == "bytes"


def test_step_terms_by_hand():
    model = {"brick": BRICK, "xyz_net_depth": 1, "xyz_net_width": 8,
             "xyz_net_out_dim": 4, "rgb_net_depth": 2, "rgb_net_width": 8,
             "sh_degree": 4, "grid_size": 8}
    xyz, rgb = counts.mlp_dims(model)
    assert xyz == [(16, 8), (8, 4)] and rgb == [(20, 8), (8, 8), (8, 3)]
    params = make_params({"model": model}, 1, "cpu")
    assert counts.param_count(model) == sum(v.numel() for v in
                                            params.values())
    terms = {n: (f, p) for n, f, p in counts.step_terms(model, 10, 2, 30)}
    macs = mlp_macs(xyz) + mlp_macs(rgb)
    assert terms["mlp"] == (3 * 2 * macs * 10, "bf16")
    assert terms["encode"] == (2 * 2 * 8 * 4 * 4 * 10, "fp32")
    assert terms["adam"] == (12 * counts.param_count(model), "fp32")
    assert terms["march"] == (counts.PROBE_FLOPS * 30, "fp32")
    ref = {n: (f, p) for n, f, p in counts.refresh_terms(model, 7)}
    assert ref["refresh_mlp"] == (2 * mlp_macs(xyz) * 7, "bf16")
    assert ref["refresh_grid"] == (counts.GRID_FLOPS * 8 ** 3, "fp32")


# --------------------------------------------------------------- readers

SPANS = {"ngp_field_ms.train": "ngp.field", "ngp_march_ms.train": "ngp.march",
         "ngp_backward_ms.train": "ngp.backward",
         "ngp_grid_ms.train": "ngp.grid"}


@pytest.fixture(scope="module")
def spec():
    return Spec(CHECKOUT)


def _reading(span_device_s, context=None, kind="train", units=4):
    return tr.Reading(kind=kind, units=units, window_s=0.5, busy_s=0.1,
                      kernels=[tr.Kernel("k", 0.0, 1.0, 1)], ops={},
                      span_device_s=span_device_s, context=context or {})


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_readers(spec, metric):
    r = _reading({SPANS[metric]: 0.024, "ngp.step": 1.0})
    assert spec.reader(metric).read(r) == pytest.approx(6.0)
    assert spec.reader(metric).read(_reading({"ngp.step": 1.0})) is None
    assert spec.reader(metric).read(
        _reading({SPANS[metric]: 0.024}, kind="view")) is None


def test_encode_roofline_and_samples_readers(spec):
    roof = spec.reader("ngp_encode_roofline.train")
    per_ray = spec.reader("ngp_samples_per_ray.train")
    ctx = {"ngp_encode_bound_ms": 2.0, "ngp_samples_per_ray": 41.5}
    # 8 ms of kernels under ngp.encode over 4 steps; a 2-ms bound: 25 %
    assert roof.read(_reading({"ngp.encode": 0.008}, ctx)) == pytest.approx(
        25.0)
    assert per_ray.read(_reading({}, ctx)) == 41.5
    # a program without the span (or a pyramid reading): nothing to read
    assert roof.read(_reading({"ngp.field": 0.008}, ctx)) is None
    assert roof.read(_reading({"ngp.encode": 0.008})) is None
    assert per_ray.read(_reading({})) is None
    assert per_ray.read(None) is None
