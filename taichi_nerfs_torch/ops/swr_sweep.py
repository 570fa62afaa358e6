"""Fused shear-warp chunk sweep: CUDA kernels and plain version.

Counterpart of the JAX package's ``ops/swr_pallas.py``.  The sweep
composites every chunk's ``dc`` slabs front to back into a per-chunk frame:
each slab is resampled onto the chunk's ``nq x nq`` lattice with separable
linear or Catmull-Rom interpolation, its density gives
``alpha = 1 - exp(-max(sigma, 0) * dt)``, and transmittance, tau, the
weighted features and the weighted depth are carried across slabs.

Layouts are channel-leading as in the JAX module: ``vol_cs`` is
``(n_chunks, dc, F, Rb, Rc)`` and the frames are ``(n_chunks, F+2, nq, nq)``
with channels ``[acc features (F-1) | depth | opacity | tau]``.

* :func:`chunk_sweep_reference` is the plain PyTorch version, a mirror of
  the straight-line oracle ``_ref_sweep`` in ``tests/test_swr_pallas.py``.
* :func:`chunk_sweep` launches the hand-written kernel
  ``csrc/swr_sweep_fwd.cu`` for CUDA tensors, and uses the plain version
  only for CPU tensors.  On CUDA it is a ``torch.autograd.Function`` whose
  backward is the hand-written ``csrc/swr_sweep_bwd.cu``
  (:func:`chunk_sweep_bwd`; plain version :func:`chunk_sweep_bwd_reference`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .warp import interp_kernel

_KINDS = {"linear": 0, "cubic": 1}
_KERNEL_F = (4, 8, 16)


def chunk_sweep_reference(
    vol_cs: torch.Tensor,  # (n_chunks, dc, F, Rb, Rc) f32
    rs_par: torch.Tensor,  # (n_chunks, dc, 4) f32
    z_rel: torch.Tensor,  # (n_chunks, dc) f32
    ch_par: torch.Tensor,  # (n_chunks, 6) f32
    nq: int,
    kind: str = "linear",
) -> torch.Tensor:
    """Plain PyTorch sweep: dense interpolation matrices, fp32 matmuls.

    Batched over chunks, one step per slab.  Differentiable in ``vol_cs``
    through autograd.
    """
    nc, dc, F, Rb, Rc = vol_cs.shape
    dev = vol_cs.device
    lat = torch.arange(nq, dtype=torch.float32, device=dev)

    def interp_T(start, step, n):
        # (nc, nq, n): W[c, i, m] = k(m - (start_c + i * step_c))
        m = torch.arange(n, dtype=torch.float32, device=dev)
        pos = start[:, None, None] + lat[None, :, None] * step[:, None, None]
        return interp_kernel(m[None, None, :] - pos, kind)

    b0r, db, c0r, dcc, va, h = (ch_par[:, k, None, None] for k in range(6))
    vb = b0r + db * lat[None, :, None]
    vc = c0r + dcc * lat[None, None, :]
    norm = torch.sqrt(va * va + vb * vb + vc * vc)  # (nc, nq, nq)
    dt = h * norm / torch.abs(va)
    acc = torch.zeros((nc, F - 1, nq, nq), dtype=torch.float32, device=dev)
    dep = torch.zeros((nc, nq, nq), dtype=torch.float32, device=dev)
    tau = torch.zeros((nc, nq, nq), dtype=torch.float32, device=dev)
    for s in range(dc):
        sb, stb, sc, stc = (rs_par[:, s, k] for k in range(4))
        wb = interp_T(sb, stb, Rb)  # (nc, nq, Rb)
        wc = interp_T(sc, stc, Rc)  # (nc, nq, Rc)
        x1 = torch.matmul(wb[:, None], vol_cs[:, s].float())  # (nc, F, nq, Rc)
        x2 = torch.matmul(x1, wc[:, None].transpose(-1, -2))  # (nc, F, nq, nq)
        # relu, not clamp: no gradient at x2 == 0, as the kernels gate
        # d sigma on x2 > 0
        sigma = torch.relu(x2[:, 0])
        sdt = sigma * dt
        a = 1.0 - torch.exp(-sdt)
        w = a * torch.exp(-tau)
        t_ray = z_rel[:, s, None, None] * norm / va
        acc = acc + w[:, None] * x2[:, 1:]
        dep = dep + w * t_ray
        tau = tau + sdt
    return torch.cat(
        [acc, dep[:, None], (1.0 - torch.exp(-tau))[:, None], tau[:, None]],
        dim=1,
    )


def _check_kernel_args(vol_cs, rs_par, z_rel, ch_par, nq, kind):
    if kind not in _KINDS:
        raise ValueError(f"unknown resample kind {kind!r}")
    if vol_cs.dim() != 5:
        raise ValueError(f"vol_cs must be 5-D, got {tuple(vol_cs.shape)}")
    nc, dc, F, Rb, Rc = vol_cs.shape
    want = {
        "rs_par": (rs_par, (nc, dc, 4)),
        "z_rel": (z_rel, (nc, dc)),
        "ch_par": (ch_par, (nc, 6)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    for name, t in (("vol_cs", vol_cs), *((k, v[0]) for k, v in want.items())):
        if t.device != vol_cs.device:
            raise ValueError(f"{name} is on {t.device}, vol_cs on "
                             f"{vol_cs.device}")
        if t.dtype != torch.float32:
            raise TypeError(
                f"{name} is {t.dtype}; the sweep kernels take float32 "
                "operands only (the bf16 variant: ROADMAP 'TPU kernels to "
                "port')"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if F not in _KERNEL_F:
        raise ValueError(f"the sweep kernel is built for F in {_KERNEL_F}, "
                         f"got F={F}")
    if nq <= 0 or min(nc, dc, Rb, Rc) <= 0:
        raise ValueError("empty sweep")


def _check_bwd_args(vol_cs, frames, g, nq):
    nc, _, F = vol_cs.shape[:3]
    for name, t in (("frames", frames), ("g", g)):
        if tuple(t.shape) != (nc, F + 2, nq, nq):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(nc, F + 2, nq, nq)}")
        if t.device != vol_cs.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {vol_cs.device}, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    from ._build import load

    fn = getattr(load(name), name)
    fn.restype = ctypes.c_int
    # pointers, then (n_chunks, dc, F, Rb, Rc, nq, kind), then the stream
    n_ptr = {"swr_sweep_fwd": 5, "swr_sweep_bwd": 7}[name]
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    return fn


def _launch(name: str, device, *args) -> None:
    fn = _kernel_fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _sweep_fwd_kernel(vol_cs, rs_par, z_rel, ch_par, nq, kind):
    nc, dc, F, Rb, Rc = vol_cs.shape
    out = torch.empty(
        (nc, F + 2, nq, nq), dtype=torch.float32, device=vol_cs.device
    )
    _launch(
        "swr_sweep_fwd", vol_cs.device,
        vol_cs.data_ptr(), rs_par.data_ptr(), z_rel.data_ptr(),
        ch_par.data_ptr(), out.data_ptr(),
        nc, dc, F, Rb, Rc, nq, _KINDS[kind],
    )
    chunk_sweep.launches += 1
    return out


def chunk_sweep_bwd_reference(vol_cs, rs_par, z_rel, ch_par, g, nq,
                              kind="linear"):
    """Plain PyTorch backward: autograd of :func:`chunk_sweep_reference`,
    ``d<g, frames>/d vol_cs``."""
    with torch.enable_grad():
        v = vol_cs.detach().requires_grad_(True)
        out = chunk_sweep_reference(v, rs_par, z_rel, ch_par, nq, kind)
        (dvol,) = torch.autograd.grad(out, v, g)
    return dvol


def chunk_sweep_bwd(vol_cs, rs_par, z_rel, ch_par, frames, g, nq,
                    kind="linear"):
    """``d<g, frames>/d vol_cs`` of the sweep whose forward gave ``frames``.

    On a CUDA tensor it runs ``csrc/swr_sweep_bwd.cu`` on the current
    stream (a memset of ``dvol`` and one launch that adds the tiles' sums
    with atomics, so the last bits may differ from run to run; counted in
    ``chunk_sweep_bwd.launches``) or raises; on a CPU tensor it runs
    :func:`chunk_sweep_bwd_reference` (``frames`` unused there).
    """
    if vol_cs.device.type == "cpu":
        return chunk_sweep_bwd_reference(vol_cs, rs_par, z_rel, ch_par, g,
                                         nq, kind)
    if vol_cs.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {vol_cs.device}")
    _check_kernel_args(vol_cs, rs_par, z_rel, ch_par, nq, kind)
    # the kernel indexes g[c, ch, i, j] directly: a cotangent that reaches
    # here as a strided view of the fold's frame slices is copied once
    g = g.contiguous()
    _check_bwd_args(vol_cs, frames, g, nq)
    nc, dc, F, Rb, Rc = vol_cs.shape
    dvol = torch.empty_like(vol_cs)
    _launch(
        "swr_sweep_bwd", vol_cs.device,
        vol_cs.data_ptr(), rs_par.data_ptr(), z_rel.data_ptr(),
        ch_par.data_ptr(), frames.data_ptr(), g.data_ptr(), dvol.data_ptr(),
        nc, dc, F, Rb, Rc, nq, _KINDS[kind],
    )
    chunk_sweep_bwd.launches += 1
    return dvol


class _ChunkSweep(torch.autograd.Function):
    """Forward and backward kernels as one differentiable op.  Only
    ``vol_cs`` gets a gradient: the camera parameters ``rs_par``, ``z_rel``
    and ``ch_par`` get ``None``, as the JAX VJP returns zeros for them."""

    @staticmethod
    def forward(ctx, vol_cs, rs_par, z_rel, ch_par, nq, kind):
        frames = _sweep_fwd_kernel(vol_cs, rs_par, z_rel, ch_par, nq, kind)
        ctx.save_for_backward(vol_cs, rs_par, z_rel, ch_par, frames)
        ctx.nq, ctx.kind = nq, kind
        return frames

    @staticmethod
    def backward(ctx, g):
        vol_cs, rs_par, z_rel, ch_par, frames = ctx.saved_tensors
        dvol = chunk_sweep_bwd(vol_cs, rs_par, z_rel, ch_par, frames, g,
                               ctx.nq, ctx.kind)
        return dvol, None, None, None, None, None


def chunk_sweep(
    vol_cs: torch.Tensor,
    rs_par: torch.Tensor,
    z_rel: torch.Tensor,
    ch_par: torch.Tensor,
    nq: int,
    kind: str = "linear",
) -> torch.Tensor:
    """Composite every chunk's slabs into per-chunk frames.

    Returns (n_chunks, F+2, nq, nq) fp32 frames with channels
    ``[acc features (F-1) | depth | opacity | tau]``.  On a CUDA tensor it
    launches ``csrc/swr_sweep_fwd.cu`` on the current stream (counted in
    ``chunk_sweep.launches``) or raises, and a gradient asked of ``vol_cs``
    runs :func:`chunk_sweep_bwd`'s kernel; on a CPU tensor it runs
    :func:`chunk_sweep_reference` under autograd.
    """
    if vol_cs.device.type == "cpu":
        return chunk_sweep_reference(vol_cs, rs_par, z_rel, ch_par, nq, kind)
    if vol_cs.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {vol_cs.device}")
    _check_kernel_args(vol_cs, rs_par, z_rel, ch_par, nq, kind)
    return _ChunkSweep.apply(vol_cs, rs_par, z_rel, ch_par, nq, kind)


chunk_sweep.launches = 0
chunk_sweep_bwd.launches = 0
