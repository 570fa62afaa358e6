"""The readers of the pyramid step's spans (`swr_bake_ms.train`,
`swr_backward_ms.train`, `swr_adam_ms.train`) on readings made by hand: a
value a step where the span launched kernels, None where it is absent or
the reading is another kind's; and, from a trace, the backward's kernels
charged to the range open on the thread that launched them."""

from __future__ import annotations

import pytest

from benchmark.harness import trace as tr
from benchmark.harness.spec import CHECKOUT, Spec

SPANS = {"swr_bake_ms.train": "swr.bake",
         "swr_backward_ms.train": "swr.backward",
         "swr_adam_ms.train": "swr.adam"}


@pytest.fixture(scope="module")
def spec():
    return Spec(CHECKOUT)


def _reading(span_device_s, kind="train", units=4):
    return tr.Reading(kind=kind, units=units, window_s=0.5, busy_s=0.1,
                      kernels=[tr.Kernel("k", 0.0, 1.0, 1)], ops={},
                      span_device_s=span_device_s)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reads_its_span_a_step(spec, metric):
    other = {s: 9.0 for s in SPANS.values() if s != SPANS[metric]}
    r = _reading({SPANS[metric]: 0.024, **other})
    assert spec.reader(metric).read(r) == pytest.approx(6.0)


@pytest.mark.parametrize("metric", sorted(SPANS))
@pytest.mark.parametrize("case", ["absent", "no_kernels", "view", "none"])
def test_none_without_its_span(spec, metric, case):
    r = {"absent": _reading({"swr.step": 0.1}),
         "no_kernels": _reading({SPANS[metric]: 0.0}),
         "view": _reading({SPANS[metric]: 0.024}, kind="view"),
         "none": None}[case]
    assert spec.reader(metric).read(r) is None


def _x(name, cat, ts, dur, tid, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_backward_kernels_go_to_the_range_on_their_thread(spec):
    """The step's ranges on the main thread (1), the backward's on
    autograd's (2): a kernel launched on thread 2 inside `swr.backward`
    counts for it; one launched on thread 1 at the same time does not."""
    events = [
        _x(tr.WINDOW_SPAN, "user_annotation", 0, 1000, 1),
        _x("swr.forward", "user_annotation", 10, 90, 1),
        _x("swr.bake", "user_annotation", 10, 30, 1),
        _x("swr.backward", "user_annotation", 120, 300, 2),
        _x("swr.adam", "user_annotation", 500, 100, 1),
        _x("cudaLaunchKernel", "cuda_runtime", 20, 2, 1, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 200, 2, 2, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 210, 2, 1, correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", 520, 2, 1, correlation=4),
        _x("bake_k", "kernel", 25, 40, 0, correlation=1),
        _x("swr_sweep_bwd_kernel", "kernel", 205, 80, 0, correlation=2),
        _x("stray_k", "kernel", 290, 8, 0, correlation=3),
        _x("adam_k", "kernel", 530, 16, 0, correlation=4),
    ]
    r = tr.reading(tr.parse({"traceEvents": events}), "train", 2, [], {})
    got = {m: spec.reader(m).read(r) for m in SPANS}
    assert got == pytest.approx({"swr_bake_ms.train": 0.02,
                                 "swr_backward_ms.train": 0.04,
                                 "swr_adam_ms.train": 0.008})
