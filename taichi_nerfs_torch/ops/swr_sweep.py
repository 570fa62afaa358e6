"""Fused shear-warp chunk sweep (forward): CUDA kernel and plain version.

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
  only for CPU tensors.  The kernel is forward only: the backward kernel
  comes with the training slice (ROADMAP, "TPU kernels to port", item 2).
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
        sigma = torch.clamp(x2[:, 0], min=0.0)
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
                f"{name} is {t.dtype}; the sweep kernel takes float32 "
                "operands only (bf16 comes with the training slice)"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if F not in _KERNEL_F:
        raise ValueError(f"the sweep kernel is built for F in {_KERNEL_F}, "
                         f"got F={F}")
    if nq <= 0 or min(nc, dc, Rb, Rc) <= 0:
        raise ValueError("empty sweep")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from ._build import load

    fn = load("swr_sweep_fwd").swr_sweep_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    return fn


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
    launches ``csrc/swr_sweep_fwd.cu`` on the current stream (and counts
    the launch in ``chunk_sweep.launches``) or raises; on a CPU tensor it
    runs :func:`chunk_sweep_reference`.
    """
    if vol_cs.device.type == "cpu":
        return chunk_sweep_reference(vol_cs, rs_par, z_rel, ch_par, nq, kind)
    if vol_cs.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {vol_cs.device}")
    if torch.is_grad_enabled() and vol_cs.requires_grad:
        raise NotImplementedError(
            "the CUDA sweep is forward-only: its backward kernel comes with "
            "the training slice (ROADMAP, 'TPU kernels to port', item 2)"
        )
    _check_kernel_args(vol_cs, rs_par, z_rel, ch_par, nq, kind)
    nc, dc, F, Rb, Rc = vol_cs.shape
    fn = _kernel_fn()
    out = torch.empty(
        (nc, F + 2, nq, nq), dtype=torch.float32, device=vol_cs.device
    )
    with torch.cuda.device(vol_cs.device):
        stream = torch.cuda.current_stream(vol_cs.device).cuda_stream
        rc = fn(
            vol_cs.data_ptr(), rs_par.data_ptr(), z_rel.data_ptr(),
            ch_par.data_ptr(), out.data_ptr(),
            nc, dc, F, Rb, Rc, nq, _KINDS[kind], stream,
        )
    if rc != 0:
        raise RuntimeError(f"swr_sweep_fwd launch failed: cudaError {rc}")
    chunk_sweep.launches += 1
    return out


chunk_sweep.launches = 0
