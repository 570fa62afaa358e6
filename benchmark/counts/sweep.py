"""Bytes, operations and the least time of the two sweep kernels at one
call's shape, frozen from the measurements' arithmetic (``chip_smoke.py``).

A call's shape is the plain sweep's: ``(nc, dc, F, Rb, Rc)`` the volume
(chunks, slabs a chunk, channels, the two cross axes), ``nq`` the lattice
side, ``kind`` "linear" (2 taps) or "cubic" (4 taps).  Each input is read
once and each output written once, whatever the kernel reads again; the
operations are the separable resample's multiply-adds and the composite's.
"""

from __future__ import annotations

from .peaks import FLOPS_PER_S, HBM_BYTES_PER_S


def bound_ms(nbytes: float, flops: float):
    """``(ms, "bytes" or "operations")``: the larger of the bytes over the
    memory rate and the operations over the fp32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S["fp32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def resample_flops(nc, dc, F, Rc, nq, kind):
    """The separable resample of every slab and channel onto the lattice: a
    multiply-add (2 flops) per tap, 2 (linear) or 4 (cubic) taps per output
    of the pass along b (nq x Rc) and along c (nq x nq)."""
    nt = 2 if kind == "linear" else 4
    return 2 * nt * nc * dc * F * (nq * Rc + nq * nq)


def sweep_fwd_bound(nc, dc, F, Rb, Rc, nq, kind, vol_bytes=4):
    """The forward: vol (``vol_bytes`` a voxel), rs_par, z_rel and ch_par
    read once, the (nc, F + 2, nq, nq) frames written once; the resample
    plus the composite's 2 (F - 1) + 10 flops per lattice point and slab.
    Returns ``(ms, by, bytes, flops)``."""
    nbytes = (vol_bytes * nc * dc * F * Rb * Rc
              + 4 * (nc * dc * 5 + nc * 6 + nc * (F + 2) * nq * nq))
    flops = (resample_flops(nc, dc, F, Rc, nq, kind)
             + nc * dc * nq * nq * (2 * (F - 1) + 10))
    return (*bound_ms(nbytes, flops), nbytes, flops)


def sweep_bwd_bound(nc, dc, F, Rb, Rc, nq, kind, vol_bytes=4):
    """The backward: vol, the parameters, the frames' tau channel (the only
    one it reads) and the cotangent read once, dvol written once; the
    forward's resample again, its transpose (the same count) and the
    reverse composite's 4 (F - 1) + 20 flops per lattice point and slab.
    An implementation's scratch is its own cost and is not counted.
    Returns ``(ms, by, bytes, flops)``."""
    nbytes = (vol_bytes * 2 * nc * dc * F * Rb * Rc
              + 4 * (nc * dc * 5 + nc * 6 + nc * nq * nq
                     + nc * (F + 2) * nq * nq))
    flops = (2 * resample_flops(nc, dc, F, Rc, nq, kind)
             + nc * dc * nq * nq * (4 * (F - 1) + 20))
    return (*bound_ms(nbytes, flops), nbytes, flops)


def touched(start, step, nq: int, n: int, kind: str):
    """How many of a source axis' ``n`` indices the taps of ``nq`` outputs at
    ``start + i * step`` reach (array-wise over ``start`` and ``step``)."""
    import numpy as np

    w = 1.0 if kind == "linear" else 2.0  # a tap's weight is 0 from w on
    p0 = np.asarray(start, np.float64)
    p1 = p0 + (nq - 1) * np.asarray(step, np.float64)
    a = np.maximum(np.floor(np.minimum(p0, p1) - w) + 1, 0)
    b = np.minimum(np.ceil(np.maximum(p0, p1) + w) - 1, n - 1)
    return np.maximum(b - a + 1, 0)


def sweep_needed(rs_par, F: int, Rb: int, Rc: int, nq: int, kind: str,
                 backward: bool = False, vol_bytes: int = 4):
    """The least time of one sweep call at its inputs: like
    :func:`sweep_fwd_bound` / :func:`sweep_bwd_bound`, but each slab reads
    only the source rows and columns its lattice's taps reach (``rs_par``
    (nc, dc, 4): each slab's start and step along b and c), and the
    resample along b produces only the columns the pass along c reads.
    The backward writes the whole gradient volume.  Returns ``(ms, by,
    bytes, flops)``."""
    import numpy as np

    rs = np.asarray(rs_par, np.float64)
    nc, dc = rs.shape[:2]
    nb = touched(rs[..., 0], rs[..., 1], nq, Rb, kind)
    ncol = touched(rs[..., 2], rs[..., 3], nq, Rc, kind)
    nt = 2 if kind == "linear" else 4
    vol_read = vol_bytes * F * float(np.sum(nb * ncol))
    params = 4 * (nc * dc * 5 + nc * 6)
    frames = 4 * nc * (F + 2) * nq * nq
    resample = 2 * nt * F * float(np.sum(nq * ncol + nq * nq))
    if not backward:
        nbytes = vol_read + params + frames
        flops = resample + nc * dc * nq * nq * (2 * (F - 1) + 10)
    else:
        nbytes = (vol_read + vol_bytes * nc * dc * F * Rb * Rc + params
                  + 4 * nc * nq * nq + frames)
        flops = 2 * resample + nc * dc * nq * nq * (4 * (F - 1) + 20)
    return (*bound_ms(nbytes, flops), nbytes, flops)
