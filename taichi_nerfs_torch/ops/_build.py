"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface.  It is
compiled on first use for Hopper (``sm_90a``) into
``build/torch_kernels/lib<name>-<hash>.so`` at the root of the checkout;
the hash covers the source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header rebuilds.
Nothing is built when the module is imported, and a failed build raises:
there is no fallback.  The module also holds the operator namespace
``taichi_nerfs_torch`` (:data:`LIB`) on which the wrappers register their
kernels, :func:`entry`, which binds a kernel's C entry, and :func:`launch`,
which calls it on PyTorch's current stream.
"""

from __future__ import annotations

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


@functools.lru_cache(maxsize=None)
def entry(name: str, argtypes: tuple, symbol: str | None = None):
    """The C entry ``symbol`` (default ``name``) of ``csrc/<name>.cu``
    (built and loaded if needed): it returns a CUDA error code and takes
    ``argtypes``, then the stream."""
    fn = getattr(load(name), symbol or name)
    fn.restype = ctypes.c_int
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    return fn


def launch(name: str, fn, device, *args) -> None:
    """Call the C entry ``fn`` (of kernel ``name``) with ``args`` and the
    current stream of ``device``; raise if it returns a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
