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
  only for CPU tensors.  On CUDA it calls the registered operator
  ``taichi_nerfs_torch::swr_sweep_fwd``, whose backward is the operator
  ``taichi_nerfs_torch::swr_sweep_bwd`` on the hand-written
  ``csrc/swr_sweep_bwd.cu`` (:func:`chunk_sweep_bwd`; plain version
  :func:`chunk_sweep_bwd_reference`).  One route serves eager calls,
  training, the ``parallel/`` ranks and programs exported with
  ``torch.export`` (``utils/aot.py``).

Two dtypes, as the Pallas kernels take them: ``vol_cs`` is float32 or
bfloat16 (a bf16 baked grid), and ``dtype`` is the resample operand dtype
(float32 or bfloat16).  With bf16 operands the interpolation weights, the
slab and the pass-1 product are rounded to bf16 (and, in the backward,
``dx2`` and the transposed pass's intermediate ``t``); every product
accumulates in fp32.  The frames are fp32; ``d vol_cs`` has ``vol_cs``'s
dtype.  The other operands are fp32.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import LIB as _LIB
from ._build import LAUNCHES, declare, on_cuda
from .warp import interp_kernel

_KINDS = {"linear": 0, "cubic": 1}
_KERNEL_F = (4, 8, 16)
# the kernels' dtype codes, of the volume and of the resample operands
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to bf16 (round to nearest even), kept fp32."""
    return x.to(torch.bfloat16).float()


class _RoundFwd(torch.autograd.Function):
    """Round to bf16 in the forward; pass the cotangent unrounded (an fp32
    slab cast to bf16 operands: its gradient stays fp32)."""

    @staticmethod
    def forward(ctx, x):
        return _to_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBoth(torch.autograd.Function):
    """Round to bf16 in the forward and the cotangent in the backward: the
    pass-1 product, whose transpose (the Pallas backward's ``t``) is
    rounded too."""

    @staticmethod
    def forward(ctx, x):
        return _to_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return _to_bf16(g)


class _RoundGrad(torch.autograd.Function):
    """The identity in the forward; round the cotangent in the backward: the
    pass-2 output, whose cotangent (the Pallas backward's ``dx2``) is
    rounded."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _to_bf16(g)


def _check_dtype(dtype) -> None:
    if dtype not in _DTYPES:
        raise TypeError(f"resample operand dtype {dtype}: float32 or "
                        "bfloat16 only")


def chunk_sweep_reference(
    vol_cs: torch.Tensor,  # (n_chunks, dc, F, Rb, Rc) f32
    rs_par: torch.Tensor,  # (n_chunks, dc, 4) f32
    z_rel: torch.Tensor,  # (n_chunks, dc) f32
    ch_par: torch.Tensor,  # (n_chunks, 6) f32
    nq: int,
    kind: str = "linear",
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch sweep: dense interpolation matrices, fp32 matmuls.

    Batched over chunks, one step per slab.  Differentiable in ``vol_cs``
    through autograd.  With ``dtype=torch.bfloat16`` the operands the
    Pallas kernel casts are rounded to bf16 and multiplied in fp32 (a
    product of two bf16 values is exact in fp32): the weights, the slab
    (its gradient unrounded), the pass-1 product (its cotangent rounded
    too) and the pass-2 output's cotangent, so that autograd rounds what
    the Pallas backward rounds.
    """
    _check_dtype(dtype)
    bf16 = dtype == torch.bfloat16
    nc, dc, F, Rb, Rc = vol_cs.shape
    dev = vol_cs.device
    lat = torch.arange(nq, dtype=torch.float32, device=dev)

    def interp_T(start, step, n):
        # (nc, nq, n): W[c, i, m] = k(m - (start_c + i * step_c))
        m = torch.arange(n, dtype=torch.float32, device=dev)
        pos = start[:, None, None] + lat[None, :, None] * step[:, None, None]
        w = interp_kernel(m[None, None, :] - pos, kind)
        return _to_bf16(w) if bf16 else w

    b0r, db, c0r, dcc, va, h = (ch_par[:, k, None, None] for k in range(6))
    vb = b0r + db * lat[None, :, None]
    vc = c0r + dcc * lat[None, None, :]
    norm = torch.sqrt(va * va + vb * vb + vc * vc)  # (nc, nq, nq)
    dt = h * norm / torch.abs(va)
    acc = torch.zeros((nc, F - 1, nq, nq), dtype=torch.float32, device=dev)
    dep = torch.zeros((nc, nq, nq), dtype=torch.float32, device=dev)
    tau = torch.zeros((nc, nq, nq), dtype=torch.float32, device=dev)
    # one unbind: each slab's gradient lands in one stack, not a full-size
    # zero tensor per slab
    slabs = vol_cs.unbind(1)
    for s in range(dc):
        sb, stb, sc, stc = (rs_par[:, s, k] for k in range(4))
        wb = interp_T(sb, stb, Rb)  # (nc, nq, Rb)
        wc = interp_T(sc, stc, Rc)  # (nc, nq, Rc)
        # a bf16 slab is exact in fp32 (its gradient is cast back once)
        slab = slabs[s].float()
        if bf16 and vol_cs.dtype != torch.bfloat16:
            slab = _RoundFwd.apply(slab)
        x1 = torch.matmul(wb[:, None], slab)  # (nc, F, nq, Rc)
        if bf16:
            x1 = _RoundBoth.apply(x1)
        x2 = torch.matmul(x1, wc[:, None].transpose(-1, -2))  # (nc, F, nq, nq)
        if bf16:
            x2 = _RoundGrad.apply(x2)
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


def _check_kernel_args(vol_cs, rs_par, z_rel, ch_par, nq, kind,
                       dtype=torch.float32):
    if kind not in _KINDS:
        raise ValueError(f"unknown resample kind {kind!r}")
    _check_dtype(dtype)
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
        ok = (torch.float32, torch.bfloat16) if name == "vol_cs" else (
            torch.float32,)
        if t.dtype not in ok:
            raise TypeError(
                f"{name} is {t.dtype}; the sweep kernels take "
                f"{' or '.join(map(str, ok))}"
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


def chunk_sweep_bwd_reference(vol_cs, rs_par, z_rel, ch_par, g, nq,
                              kind="linear", dtype=torch.float32):
    """Plain PyTorch backward: autograd of :func:`chunk_sweep_reference`,
    ``d<g, frames>/d vol_cs``, in ``vol_cs``'s dtype."""
    with torch.enable_grad():
        v = vol_cs.detach().requires_grad_(True)
        out = chunk_sweep_reference(v, rs_par, z_rel, ch_par, nq, kind, dtype)
        (dvol,) = torch.autograd.grad(out, v, g)
    return dvol


# The kernels as registered operators (``_build.declare``), for CUDA tensors
# only: the CPU branches of the wrappers below run the plain versions
# outside the operators (autograd does not run inside an operator's
# implementation).  Neither mutates its inputs.  Each kernel's C arguments
# before the stream: pointers, then (n_chunks, dc, F, Rb, Rc, nq, kind, vol
# dtype, operand dtype).


def _sweep_fwd_fake(vol_cs, rs_par, z_rel, ch_par, nq, kind, dtype):
    _check_kernel_args(vol_cs, rs_par, z_rel, ch_par, nq, kind, dtype)
    nc, _, F = vol_cs.shape[:3]
    return vol_cs.new_empty((nc, F + 2, nq, nq), dtype=torch.float32)


def _sweep_fwd_op(launch, out, vol_cs, rs_par, z_rel, ch_par, nq, kind,
                  dtype):
    nc, dc, F, Rb, Rc = vol_cs.shape
    launch(
        vol_cs.device,
        vol_cs.data_ptr(), rs_par.data_ptr(), z_rel.data_ptr(),
        ch_par.data_ptr(), out.data_ptr(),
        nc, dc, F, Rb, Rc, nq, _KINDS[kind], _DTYPES[vol_cs.dtype],
        _DTYPES[dtype],
    )


def _sweep_bwd_fake(vol_cs, rs_par, z_rel, ch_par, frames, g, nq, kind,
                    dtype):
    _check_kernel_args(vol_cs, rs_par, z_rel, ch_par, nq, kind, dtype)
    _check_bwd_args(vol_cs, frames, g, nq)
    return torch.empty_like(vol_cs)


def _sweep_bwd_op(launch, dvol, vol_cs, rs_par, z_rel, ch_par, frames, g, nq,
                  kind, dtype):
    nc, dc, F, Rb, Rc = vol_cs.shape
    scratch = None
    if torch.bfloat16 in (vol_cs.dtype, dtype):
        scratch = torch.empty((nc, dc, F, nq, Rc), dtype=torch.float32,
                              device=vol_cs.device)
    launch(
        vol_cs.device,
        vol_cs.data_ptr(), rs_par.data_ptr(), z_rel.data_ptr(),
        ch_par.data_ptr(), frames.data_ptr(), g.data_ptr(), dvol.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        nc, dc, F, Rb, Rc, nq, _KINDS[kind], _DTYPES[vol_cs.dtype],
        _DTYPES[dtype],
    )
    if scratch is not None:  # the entry ran the rows kernel too
        LAUNCHES["swr_sweep_bwd_rows"] += 1


declare(
    "swr_sweep_fwd(Tensor vol_cs, Tensor rs_par, Tensor z_rel, "
    "Tensor ch_par, int nq, str kind, ScalarType dtype) -> Tensor",
    "swr_sweep_fwd", (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 9,
    _sweep_fwd_fake, _sweep_fwd_op)
declare(
    "swr_sweep_bwd(Tensor vol_cs, Tensor rs_par, Tensor z_rel, "
    "Tensor ch_par, Tensor frames, Tensor g, int nq, str kind, "
    "ScalarType dtype) -> Tensor",
    "swr_sweep_bwd", (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 9,
    _sweep_bwd_fake, _sweep_bwd_op)


def chunk_sweep_bwd(vol_cs, rs_par, z_rel, ch_par, frames, g, nq,
                    kind="linear", dtype=torch.float32):
    """``d<g, frames>/d vol_cs`` of the sweep whose forward gave ``frames``,
    in ``vol_cs``'s dtype.

    On a CUDA tensor it runs ``csrc/swr_sweep_bwd.cu`` on the current
    stream or raises, through the operator
    ``taichi_nerfs_torch::swr_sweep_bwd``: a memset and the sweep kernel,
    which adds the tiles' sums with atomics (so the last bits may differ
    from run to run).  With an fp32 ``vol_cs`` and fp32 operands the sums
    are ``dvol``'s.  With a bf16 ``vol_cs`` or bf16 operands they are the
    transposed pass's ``t``, added into an fp32 scratch ``(n_chunks, dc, F,
    nq, Rc)``, and a second kernel (``swr_sweep_bwd_rows_kernel``, counted
    in ``_build.LAUNCHES`` under ``swr_sweep_bwd_rows``) rounds each ``t``
    once (bf16 operands) and resamples them back along b into ``dvol``,
    each voxel stored once in ``vol_cs``'s dtype.  On a CPU tensor it runs
    :func:`chunk_sweep_bwd_reference` (``frames`` unused there).
    """
    if not on_cuda(vol_cs, "sweep"):
        return chunk_sweep_bwd_reference(vol_cs, rs_par, z_rel, ch_par, g,
                                         nq, kind, dtype)
    # the kernel indexes g[c, ch, i, j] directly: a cotangent that reaches
    # here as a strided view of the fold's frame slices is copied once
    return torch.ops.taichi_nerfs_torch.swr_sweep_bwd(
        vol_cs, rs_par, z_rel, ch_par, frames, g.contiguous(), nq, kind,
        dtype)


def _sweep_setup_context(ctx, inputs, output):
    vol_cs, rs_par, z_rel, ch_par, nq, kind, dtype = inputs
    ctx.save_for_backward(vol_cs, rs_par, z_rel, ch_par, output)
    ctx.nq, ctx.kind, ctx.dtype = nq, kind, dtype


def _sweep_backward(ctx, g):
    """Only ``vol_cs`` gets a gradient: the camera parameters ``rs_par``,
    ``z_rel`` and ``ch_par`` get ``None``, as the JAX VJP returns zeros for
    them."""
    vol_cs, rs_par, z_rel, ch_par, frames = ctx.saved_tensors
    dvol = chunk_sweep_bwd(vol_cs, rs_par, z_rel, ch_par, frames, g,
                           ctx.nq, ctx.kind, ctx.dtype)
    return dvol, None, None, None, None, None, None


torch.library.register_autograd("taichi_nerfs_torch::swr_sweep_fwd",
                                _sweep_backward,
                                setup_context=_sweep_setup_context, lib=_LIB)


def chunk_sweep(
    vol_cs: torch.Tensor,
    rs_par: torch.Tensor,
    z_rel: torch.Tensor,
    ch_par: torch.Tensor,
    nq: int,
    kind: str = "linear",
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Composite every chunk's slabs into per-chunk frames.

    Returns (n_chunks, F+2, nq, nq) fp32 frames with channels
    ``[acc features (F-1) | depth | opacity | tau]``.  ``vol_cs`` is fp32
    or bf16; ``dtype`` is the resample operand dtype (the JAX
    ``chunk_sweep``'s ``dtype``).  On a CUDA tensor it launches
    ``csrc/swr_sweep_fwd.cu`` on the current stream (counted in
    ``_build.LAUNCHES``) or raises, through the operator
    ``taichi_nerfs_torch::swr_sweep_fwd``, and a gradient asked of
    ``vol_cs`` runs :func:`chunk_sweep_bwd`'s kernel; on a CPU tensor it
    runs :func:`chunk_sweep_reference` under autograd.
    """
    if not on_cuda(vol_cs, "sweep"):
        return chunk_sweep_reference(vol_cs, rs_par, z_rel, ch_par, nq, kind,
                                     dtype)
    return torch.ops.taichi_nerfs_torch.swr_sweep_fwd(
        vol_cs, rs_par, z_rel, ch_par, nq, kind, dtype)
