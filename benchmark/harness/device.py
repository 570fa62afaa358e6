"""The card a run measures, the caches it keeps, its seeds and its clock."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "taichi_nerfs_tpu")


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> None:
    """Raise :class:`NoCard` unless ``n`` CUDA devices are visible."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark "
                     "measures the card and never runs on the CPU")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} card(s); torch.cuda.device_count() "
                     f"is {torch.cuda.device_count()}")


def keep_caches_in(checkout: str) -> None:
    """Point every kernel and build cache a run may fill at fixed
    directories inside the checkout, so only a checkout's first run builds.
    (The program's own kernels build into ``build/torch_kernels/`` there.)"""
    base = os.path.join(checkout, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def power_limit() -> str:
    """``name, power limit`` of the first card as ``nvidia-smi`` gives them,
    or "" where it cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else ""


def describe(device, chips: int) -> dict:
    """The result's ``device`` entry (without the peak)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "power": power_limit()}
    return {"platform": dev.type, "kind": dev.type, "count": chips}


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def seeds(seed: int, n: int) -> list:
    """``n`` independent 31-bit seeds drawn from ``seed`` (any whole number
    of up to 64 bits)."""
    words = np.random.SeedSequence(int(seed)).generate_state(n, np.uint32)
    return [int(w) & 0x7FFFFFFF for w in words]


def forbidden_loaded() -> list:
    """Top-level names of modules loaded that the benchmark must not load,
    compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


now = time.perf_counter


def collect() -> None:
    """Collect what set-up left behind before the window opens.  The
    collector stays on, as in any process of the program: a collection
    inside the window is part of what the window measures."""
    import gc

    gc.collect()


def build_kernels(names, device) -> float:
    """Build (where this checkout has not built them yet) and load the
    program's CUDA kernels ``names``; returns the seconds ``nvcc`` took,
    0 where every library was built already.  They count in ``setup_s``
    too: this number says how much of it was the build."""
    import torch

    if torch.device(device).type != "cuda":
        return 0.0
    from taichi_nerfs_torch.ops import _build

    secs = sum(_build.build(n)[2] for n in names)
    for n in names:
        _build.load(n)
    return float(secs)
