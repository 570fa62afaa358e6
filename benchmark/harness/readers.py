"""What the per-layer metric files share: each file under
``benchmark/metrics/`` names its kind, kernels and spans and calls one of
these.  Each returns None where the profile holds nothing to read, and the
metric is then left out of the result."""

from __future__ import annotations

from benchmark.counts.peaks import FLOPS_PER_S


def _ours(r, kind: str) -> bool:
    return r is not None and r.kind == kind and r.units > 0


def launches(r, kind: str):
    """Kernel launches the device ran a step (frame)."""
    if not _ours(r, kind) or not r.kernels:
        return None
    return len(r.kernels) / r.units


def idle(r, kind: str):
    """Per cent of the profiled wall time in which no device operation
    ran."""
    if not _ours(r, kind) or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)


def mfu(r, kind: str):
    """Per cent of the profiled wall time that the algorithm's operations
    would take at the published peaks of their precisions."""
    if not _ours(r, kind) or not r.flops or r.window_s <= 0:
        return None
    at_peak = sum(f / FLOPS_PER_S[p] for _, f, p in r.flops)
    return 100.0 * at_peak / r.window_s


def span_ms(r, kind: str, span: str):
    """Device ms a step (frame) of the kernels launched under ``span``."""
    if not _ours(r, kind) or not r.span_device_s.get(span):
        return None
    return 1e3 * r.span_device_s[span] / r.units


def roofline(r, kind: str, kernels, bound_key: str):
    """Per cent: the least time of the profiled units' calls of a kernel
    (the system's ``bound_key``: each call's bytes and operations at its
    inputs, ``counts/sweep.py``) over the device time of every launch of
    the kernels matching ``kernels``."""
    if not _ours(r, kind) or bound_key not in r.context:
        return None
    launched = [k for pat in kernels for k in r.kernels_matching(pat)]
    dev_ms = sum(k.dur for k in launched) / 1e3
    if dev_ms <= 0:
        return None
    return 100.0 * r.context[bound_key] / dev_ms
