"""The port's tracing: named profiler ranges that cost nothing with no
profiler, host timers of device work, and :func:`report_profile`, the op
table and device-busy share that the entries' ``--profile`` /
``--profile_dir`` print.

:func:`span` and :func:`backward_span` are the ranges the benchmark reads
(``benchmark/harness/trace.py`` charges each kernel to the ranges open on
the thread that launched it, and labels each idle gap of the device with
the innermost range the host was in).  They enter a range only while the
autograd profiler is on: otherwise a span is one flag check and a
backward span installs no hook.  The train entry's ``--profile_dir``
turns the profiler on.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Sequence

import torch

_OFF = contextlib.nullcontext()


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A context that is ``torch.profiler.record_function(name)`` while the
    profiler runs, and does nothing otherwise."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF


class _BackwardRange:
    """The range ``name`` over the backward from ``root`` to ``leaves``,
    on the thread that runs it: opened by a pre-hook of ``root.grad_fn``,
    closed by the hook of the last leaf whose gradient is made (or on leaving
    the block, should the backward raise or skip a leaf)."""

    def __init__(self, name: str, root: torch.Tensor,
                 leaves: Sequence[torch.Tensor]):
        self.name = name
        self.root = root
        self.leaves = leaves
        self.left = len(leaves)
        self.handles: List = []
        self.record = None

    def __enter__(self):
        self.handles.append(self.root.grad_fn.register_prehook(self._open))
        self.handles += [t.register_hook(self._leaf_done)
                         for t in self.leaves]
        return self

    def __exit__(self, *exc):
        self._close()
        return False

    def _open(self, grad_outputs):
        self.record = torch.ops.profiler._record_function_enter_new(
            self.name, None)

    def _leaf_done(self, grad):
        self.left -= 1
        if self.left == 0:
            self._close()

    def _close(self):
        for h in self.handles:
            h.remove()
        self.handles = []
        if self.record is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(
                self.record)
            self.record = None


def backward_span(name: str, root: torch.Tensor,
                  leaves: Sequence[torch.Tensor]):
    """A context around the backward of ``root`` to ``leaves`` (a
    ``torch.autograd.grad`` call): while the profiler runs, the range
    ``name`` opens on the thread that runs the backward when it starts and
    closes there when the last leaf's gradient is made, so the kernels it
    launches on autograd's device thread fall inside.  Otherwise nothing."""
    if not _profiling() or root.grad_fn is None:
        return _OFF
    return _BackwardRange(name, root, leaves)


def time_calls(fn, n: int, warm: int, device) -> List[float]:
    """Milliseconds of each of ``n`` calls of ``fn()``, after ``warm``
    untimed ones.  On a CUDA device each call runs between two CUDA events
    behind ``torch.cuda.synchronize()``; on the CPU the host clock times
    it."""
    for _ in range(warm):
        fn()
    cuda = torch.device(device).type == "cuda"
    ms = []
    for _ in range(n):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def spread(ms: List[float]) -> str:
    """``median M ms (min a, max b, n runs)``."""
    s = sorted(ms)
    mid = len(s) // 2
    med = s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])
    return (f"median {med:8.3f} ms (min {s[0]:.3f}, max {s[-1]:.3f}, "
            f"{len(s)} runs)")


def report_profile(prof, wall_us: float, what: str, cuda: bool,
                   out_dir: str | None) -> float:
    """Print a finished profile's op table (by self device time on the
    card, self CPU time otherwise) and, on the card, the device-busy share
    of ``wall_us``; write ``trace.json`` to ``out_dir`` (if given).
    Returns the device-busy microseconds (0 off the card)."""
    from torch.autograd import DeviceType

    avgs = prof.key_averages()
    key = "self_device_time_total" if cuda else "self_cpu_time_total"
    print(avgs.table(sort_by=key, row_limit=25), flush=True)
    busy_us = 0.0
    if cuda:
        # kernel time only: the spans' device-side ranges (user
        # annotations) would count their kernels twice
        busy_us = sum(
            e.self_device_time_total for e in avgs
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
        )
        print(f"profile: {what} in {wall_us / 1e3:.3f} ms wall, "
              f"device busy {busy_us / 1e3:.3f} ms "
              f"({100.0 * busy_us / wall_us:.1f}%)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    return busy_us
