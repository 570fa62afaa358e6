"""Wall-clock phase accounting of the training loop.

Port of the JAX package's ``utils/profiling.py:PhaseTimer`` (its
``jax.profiler`` trace is ``torch.profiler`` in the port's train entry,
``--profile_dir``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List


class PhaseTimer:
    """Accumulates wall-clock seconds and calls per named phase."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None) -> Iterator[None]:
        """Time a block.  ``sync``: a callable that waits for the device
        (a host read), so this phase's device time is not counted in the
        next one."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def summary(self, reset: bool = False) -> str:
        total = sum(self.seconds.values()) or 1.0
        out = " | ".join(
            f"{k} {self.calls[k]}x {v:.2f}s ({100.0 * v / total:.1f}%)"
            for k, v in sorted(self.seconds.items(), key=lambda kv: -kv[1])
        )
        if reset:
            self.seconds.clear()
            self.calls.clear()
        return out


def time_calls(fn, n: int, warm: int, device) -> List[float]:
    """Milliseconds of each of ``n`` calls of ``fn()``, after ``warm``
    untimed ones.  On a CUDA device each call runs between two CUDA events
    behind ``torch.cuda.synchronize()``; on the CPU the host clock times
    it."""
    import torch

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
