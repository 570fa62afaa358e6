"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface.  It is
compiled on first use for Hopper (``sm_90a``) into
``build/torch_kernels/lib<name>-<hash>.so`` at the root of the checkout;
the hash covers the source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header rebuilds.
Nothing is built when the module is imported, and a failed build raises:
there is no fallback.

The module is also the one boundary between the port and its kernels:
:func:`declare` makes a C entry the operator ``taichi_nerfs_torch::<name>``
(on :data:`LIB`), :data:`LAUNCHES` counts every launch, and
:func:`on_cuda` is the one device rule of the wrappers (CUDA: the operator;
CPU: the plain version; anything else raises).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


# The kernels as registered operators, so that ``torch.export`` traces each
# call as one graph node (``utils/aot.py``): a traced tensor has no storage
# for the ctypes launch, so tracing runs each operator's fake version, which
# gives the output's shape and dtype only.  Defined on a ``Library`` rather
# than with ``torch.library.custom_op``, whose kernel wrapper imports
# ``torch._dynamo`` at a process's first call (~2 s on a CPU, ~8.5 s on the
# H100 machine's host: every new process that renders).
LIB = torch.library.Library("taichi_nerfs_torch", "DEF")


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA kernels need the CUDA toolkit"
    )


def kernel_names() -> tuple[str, ...]:
    """Every kernel of ``csrc/`` (one ``<name>.cu`` each)."""
    return tuple(sorted(f[:-3] for f in os.listdir(CSRC)
                        if f.endswith(".cu")))


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: the file name hashes the source,
    every header in ``csrc/`` (``*.cuh``) and the flags."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def build(name: str) -> tuple[str, str, float]:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.

    Returns ``(library path, nvcc's output, build seconds)``; seconds is 0
    and the output empty when the library was already built.
    """
    out = library_path(name)
    if os.path.exists(out):
        return out, "", 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    # build into a temporary file and rename: another process never
    # sees (or loads) a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) for {name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr, secs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name``."""
    path, _, _ = build(name)
    return ctypes.CDLL(path)


# Every launch in this process, by C entry, and the second kernels of two
# entries under keys of their own: ``swr_sweep_bwd_rows``, which the entry
# ``swr_sweep_bwd`` launches for a bf16 volume or bf16 operands, and
# ``hash_encode_bwd_transpose``, which ``hash_encode_bwd`` launches after
# its scatter.  A fake (traced) call counts nothing.
LAUNCHES: collections.Counter = collections.Counter()


def launch_counts() -> str:
    """This process's launches so far, on a line of their own as the
    scripts print them: ``launches: swr_sweep_fwd=N swr_sweep_bwd=M
    band_warp=K``."""
    return (f"launches: swr_sweep_fwd={LAUNCHES['swr_sweep_fwd']} "
            f"swr_sweep_bwd={LAUNCHES['swr_sweep_bwd']} "
            f"band_warp={LAUNCHES['swr_warp']}")


def on_cuda(t: torch.Tensor, what: str) -> bool:
    """Whether ``t`` takes the ``what`` kernel: True on CUDA, False on the
    CPU (the caller runs the plain version); any other device raises, as
    there is no kernel and no fallback."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind != "cpu":
        raise ValueError(f"no {what} kernel for device {t.device}")
    return False


def declare(schema: str, library: str, argtypes: tuple, fake, impl,
            symbol: str | None = None):
    """Declare the operator ``taichi_nerfs_torch::<name>`` of ``schema`` on
    the C entry ``symbol`` (default ``library``) of ``csrc/<library>.cu``,
    which returns a CUDA error code and takes ``argtypes``, then the stream.

    ``fake(*args)`` checks the operator's arguments and allocates its
    outputs: tracing (``torch.export``) runs it for their shapes, and a
    CUDA call for the outputs the kernel writes.  ``impl(launch, outputs,
    *args)`` passes the kernel its pointers and sizes: ``launch(device, *C
    arguments)``, or nothing with nothing to do.  ``launch`` binds the entry
    at its first call, launches on ``device``'s current stream, raises on a
    CUDA error and counts the launch in :data:`LAUNCHES` under ``symbol``.
    """
    name = schema[: schema.index("(")]
    symbol = symbol or library
    fn = None

    def launch(device, *c_args):
        nonlocal fn
        if fn is None:
            fn = getattr(load(library), symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = [*argtypes, ctypes.c_void_p]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*c_args, stream)
        if rc != 0:
            raise RuntimeError(f"{symbol} launch failed: cudaError {rc}")
        LAUNCHES[symbol] += 1

    def cuda(*args):
        out = fake(*args)
        impl(launch, out, *args)
        return out

    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{LIB.ns}::{name}", fake, lib=LIB)
