"""Process-group "mesh": one process a device, and the collectives of the
data-parallel trainers.

Port of the JAX package's ``parallel/mesh.py``.  A JAX mesh is one program
over the devices; here it is one process a rank, joined by
``torch.distributed``.  :func:`launch` spawns the ranks, joins them into a
process group and hands each a :class:`Mesh`: its rank, the world size,
its ``torch.device`` and the group.  Params, optimizer state and occupancy
are replicated by construction (every rank starts from the same seed and
applies the same reduced update), so no tensor is ever broadcast.

The backend is an explicit argument: ``"nccl"`` when each rank owns a
CUDA device, ``"gloo"`` on the CPU or when ranks share one card (NCCL
refuses two ranks on one GPU).  Gloo reduces host memory: a CUDA tensor is
copied to the host, reduced there and copied back.  Nothing switches
backend or device when a collective fails.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the process group."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Any = None

    def _all_reduce(self, buf: torch.Tensor, op) -> torch.Tensor:
        """``all_reduce`` of ``buf`` in place (through the host for gloo and
        a CUDA tensor); returns ``buf``."""
        if self.backend == "gloo" and buf.is_cuda:
            host = buf.cpu()
            dist.all_reduce(host, op=op, group=self.group)
            return buf.copy_(host)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf

    def all_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Replace each tensor with its mean over the ranks, in place: one
        flattened ``all_reduce(SUM)`` divided by the world size, in the
        tensors' own dtype (as ``lax.pmean``)."""
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) != 1:
            raise ValueError(f"all_mean_ needs one dtype, got {dtypes}")
        buf = torch.cat([t.reshape(-1) for t in tensors])
        self._all_reduce(buf, dist.ReduceOp.SUM).div_(self.size)
        k = 0
        for t in tensors:
            t.copy_(buf[k:k + t.numel()].view_as(t))
            k += t.numel()

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor)."""
        return self._all_reduce(t.clone(), dist.ReduceOp.SUM)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks (a new tensor)."""
        return self._all_reduce(t.clone(), dist.ReduceOp.MAX)


def _rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``"cuda"`` without an index means
    ``cuda:<rank>``; an indexed CUDA device is shared by every rank; the
    CPU is the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def _check_layout(n: int, device, backend: str) -> None:
    dev = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    if backend == "nccl" and (dev.type != "cuda" or (dev.index is not None
                                                     and n > 1)):
        raise ValueError("nccl needs one CUDA device a rank: pass device="
                         "'cuda' (rank r on cuda:r)")
    if dev.type == "cuda" and dev.index is None:
        visible = torch.cuda.device_count()
        if n > visible:
            raise ValueError(f"{n} ranks on cuda:0..{n - 1}, but "
                             f"{visible} CUDA devices are visible")


def make_mesh(n_devices: int | None = None, *, device,
              backend: str) -> Mesh:
    """This process's :class:`Mesh` in the default process group (joined by
    :func:`launch`).  ``n_devices``, when given, must be the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run the ranks "
                           "through parallel.launch")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a {n_devices}-device mesh in a world of {size}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    _check_layout(size, device, backend)
    return Mesh(rank, size, _rank_device(device, rank), backend,
                dist.group.WORLD)


def _rank_main(rank: int, payload: bytes, n: int, device, backend: str,
               init_file: str, out_dir: str) -> None:
    # a spawned process starts from torch's defaults: keep the renderer's
    # full-fp32 matmuls (render/serve.py:_require_fp32_matmul)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=n, rank=rank)
    fn, args = pickle.loads(payload)
    out = fn(make_mesh(n, device=device, backend=backend), *args)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def launch(fn: Callable, n: int, *, device, backend: str,
           rendezvous_dir: str, args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` ranks and return each rank's
    result, in rank order.

    The ranks are ``torch.multiprocessing`` processes (start method
    ``spawn``: ``fn`` and ``args`` must pickle, ``fn`` by import path),
    joined through a file under ``rendezvous_dir`` (never a fixed TCP
    port).  Each rank unpickles its own copy of ``args`` (a tensor handed to
    ``torch.multiprocessing`` as such would be one shared buffer, which
    every rank's in-place update would write).  A rank that raises ends the
    launch: the others are stopped and the parent raises with that rank's
    traceback.  On CUDA the kernels are built here first, so the ranks only
    load them.
    """
    _check_layout(n, device, backend)
    if torch.device(device).type == "cuda":
        build_kernels()
    os.makedirs(rendezvous_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="mesh-", dir=rendezvous_dir)
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(pickle.dumps((fn, args)), n, device, backend,
                              os.path.join(work, "rendezvous"), work),
            nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def build_kernels() -> None:
    """Build every kernel of ``csrc/``, one ``nvcc`` each, all at once."""
    from ..ops import _build

    with ThreadPoolExecutor() as pool:
        list(pool.map(_build.build, _build.kernel_names()))
