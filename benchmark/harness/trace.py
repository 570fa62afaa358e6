"""The traced run's profile: a bounded sub-window, its parse, and what the
per-layer readers read.

:class:`SubWindow` profiles a fixed number of steps or frames once the
window is half over, with ``torch.profiler`` (CPU and CUDA activities,
the call shapes recorded).  The device is synchronised at both ends, inside
the range ``bench.profiled``, so the range holds all of those units' device
work; its length is the sub-window's wall time.  The chrome trace goes to
``$TMPDIR`` and is deleted once parsed into a :class:`Reading`.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.profiled"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Kernel:
    name: str
    ts: float  # microseconds, the trace's clock
    dur: float
    corr: Optional[int]


@dataclass
class Op:
    """A host operator (``cpu_op``) with its recorded arguments."""

    name: str
    ts: float
    dur: float
    dims: list
    concrete: list


@dataclass
class Reading:
    """What a per-layer reader reads: the profiled sub-window's device
    activity, host ranges and the traffic kind's counts.

    ``kind`` the traffic kind ("train", "view"); ``units`` the steps or
    frames profiled; ``window_s`` the sub-window's wall seconds; ``busy_s``
    the seconds in which some device operation ran; ``flops`` the
    algorithm's operations over the profiled units as ``[(term, flops,
    precision)]``; ``context`` the system's facts (shapes, kinds) and the
    traffic driver's (a view run's ``frame_ms_p95``)."""

    kind: str
    units: int
    window_s: float
    busy_s: float
    kernels: List[Kernel]
    ops: Dict[str, List[Op]]
    span_device_s: Dict[str, float]
    flops: list = field(default_factory=list)
    context: dict = field(default_factory=dict)

    def kernels_matching(self, pattern: str) -> List[Kernel]:
        rx = re.compile(pattern)
        return [k for k in self.kernels if rx.search(k.name)]


class SubWindow:
    """Profile ``units`` consecutive units starting at the first unit that
    begins ``start_s`` or more into the window (never, unless
    ``enabled``)."""

    def __init__(self, enabled: bool, units: int, start_s: float, device):
        self.enabled = enabled
        self.units = units
        self.start_s = start_s
        self.device = device
        self.prof = None
        self.count = 0
        self.done = False
        self.first_unit = None
        self._range = None

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def before(self, elapsed: float, unit: int) -> None:
        if not self.enabled or self.done or self.active:
            return
        if elapsed < self.start_s:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        from .device import sync

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, record_shapes=True)
        self.prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW_SPAN)
        self._range.__enter__()
        sync(self.device)
        self.first_unit = unit
        self.count = 0

    def after(self) -> None:
        if not self.active:
            return
        self.count += 1
        if self.count < self.units:
            return
        from .device import sync

        sync(self.device)
        self._range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.done = True

    def finish(self):
        """The parsed profile (:func:`parse`), or None without one."""
        if self.prof is None or not self.done:
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        return parse(events)


@dataclass
class Parsed:
    window: Tuple[float, float]
    kernels: List[Kernel]
    device: List[Tuple[float, float]]  # every device operation's interval
    ops: Dict[str, List[Op]]
    spans: Dict[str, List[Tuple[float, float, int]]]  # (ts, end, tid)
    launches: Dict[int, Tuple[float, int]]  # correlation -> (ts, tid)
    host: List[Tuple[float, float, int, str, str]]  # (ts, end, tid, cat, name)

    def busy_us(self) -> float:
        w0, w1 = self.window
        total, cur0, cur1 = 0.0, None, None
        for a, b in sorted(self.device):
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            if cur1 is None or a > cur1:
                if cur1 is not None:
                    total += cur1 - cur0
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
        if cur1 is not None:
            total += cur1 - cur0
        return total

    def idle_gaps(self) -> List[Tuple[float, float]]:
        w0, w1 = self.window
        gaps, t = [], w0
        for a, b in sorted(self.device):
            if a > t:
                gaps.append((t, min(a, w1)))
            t = max(t, b)
            if t >= w1:
                break
        if t < w1:
            gaps.append((t, w1))
        return [(a, b) for a, b in gaps if b > a]

    def span_device_s(self) -> Dict[str, float]:
        """Device seconds of the kernels launched while the host was inside
        each named range (a kernel under nested ranges counts for each)."""
        out = {}
        for name, ranges in self.spans.items():
            if name == WINDOW_SPAN:
                continue
            by_tid = defaultdict(list)
            for a, b, tid in ranges:
                by_tid[tid].append((a, b))
            for v in by_tid.values():
                v.sort()
            total = 0.0
            for k in self.kernels:
                launch = self.launches.get(k.corr)
                if launch is None:
                    continue
                ts, tid = launch
                rs = by_tid.get(tid)
                if not rs:
                    continue
                i = bisect.bisect_right(rs, (ts, float("inf"))) - 1
                # ranges of one name do not overlap on one thread
                if i >= 0 and rs[i][0] <= ts <= rs[i][1]:
                    total += k.dur
            out[name] = total / 1e6
        return out

    def host_labels(self, times: List[float]) -> List[str]:
        """What the host was doing at each of the ascending ``times``: the
        innermost range and the innermost operator or runtime call covering
        it on any thread (the backward runs on autograd's), else "python"
        (the thread that ran the window between calls)."""
        evs = sorted((a, b, cat, name) for a, b, _, cat, name in self.host)
        out, active, j = [], [], 0
        for t in times:
            while j < len(evs) and evs[j][0] <= t:
                active.append(evs[j])
                j += 1
            active = [e for e in active if e[1] >= t]
            rng = min((e for e in active if e[2] == "user_annotation"
                       and e[3] != WINDOW_SPAN),
                      key=lambda e: e[1] - e[0], default=None)
            call = min((e for e in active if e[2] != "user_annotation"),
                       key=lambda e: e[1] - e[0], default=None)
            name = call[3] if call else "python"
            out.append(f"{rng[3]}: {name}" if rng else name)
        return out

    def breakdown(self) -> dict:
        by_name = defaultdict(float)
        for k in self.kernels:
            by_name[short_name(k.name)] += k.dur / 1e6
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
        gaps = defaultdict(float)
        idle = self.idle_gaps()
        labels = self.host_labels([0.5 * (a + b) for a, b in idle])
        for (a, b), label in zip(idle, labels):
            gaps[label] += (b - a) / 1e6
        idle = sorted(gaps.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, namespaces and arguments,
    its template arguments cut to the functors and kernels they name: e.g.
    ``elementwise_kernel[direct_copy_kernel_cuda]``."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    cut = min([i for i in (name.find("<"), name.find("(")) if i >= 0],
              default=len(name))
    base = name[:cut].split("::")[-1].strip()
    inner = [w for w in re.findall(r"[A-Za-z_]\w*(?:Functor\w*|_kernel\w*)",
                                   name[cut:])
             if w != base and not w.startswith("gpu_kernel")]
    label = f"{base}[{','.join(dict.fromkeys(inner))}]" if inner else base
    return label[:96]


def parse(trace: dict) -> Parsed:
    """The sub-window's events from a chrome trace of :class:`SubWindow`."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW_SPAN} range")
    w = win[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    kernels, device, host = [], [], []
    ops = defaultdict(list)
    spans = defaultdict(list)
    launches = {}
    for e in events:
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            if ts + dur < w0 or ts > w1:
                continue
            device.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append(Kernel(e["name"], ts, dur,
                                      args.get("correlation")))
            continue
        if ts + dur < w0 or ts > w1:
            continue
        tid = e.get("tid")
        if cat in LAUNCH_CATS:
            if args.get("correlation") is not None:
                launches[args["correlation"]] = (ts, tid)
            host.append((ts, ts + dur, tid, cat, e["name"]))
        elif cat == "user_annotation":
            spans[e["name"]].append((ts, ts + dur, tid))
            host.append((ts, ts + dur, tid, cat, e["name"]))
        elif cat == "cpu_op":
            ops[e["name"]].append(Op(e["name"], ts, dur,
                                     args.get("Input Dims", []),
                                     args.get("Concrete Inputs", [])))
            host.append((ts, ts + dur, tid, cat, e["name"]))
    for v in ops.values():
        v.sort(key=lambda o: o.ts)
    kernels.sort(key=lambda k: k.ts)
    p = Parsed((w0, w1), kernels, device, dict(ops), dict(spans), launches,
               host)
    return p


def reading(parsed: Parsed, kind: str, units: int, flops, context) -> Reading:
    w0, w1 = parsed.window
    return Reading(kind=kind, units=units, window_s=(w1 - w0) / 1e6,
                   busy_s=parsed.busy_us() / 1e6, kernels=parsed.kernels,
                   ops=parsed.ops, span_device_s=parsed.span_device_s(),
                   flops=list(flops), context=dict(context))
