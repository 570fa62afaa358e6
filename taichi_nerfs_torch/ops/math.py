"""Integer and bit math of the occupancy grid: morton codes, the bit-level
frexp of the cascade pick, the marching step schedule and the bitfield.

Port of the JAX package's ``ops/math.py``.

uint32 arithmetic.  The JAX code computes in ``uint32`` and relies on its
wrap-around.  torch's ``uint32`` has few CUDA ops, so the port computes in
``int64`` holding the uint32 value (``x & 0xFFFFFFFF``) and masks after
every multiply (:func:`mul_u32`); the results are bit-equal to JAX's on any
device.

The bitfield.  Occupancy is packed 32 cells to a word, bit ``i`` of word
``w`` being cell ``32 * w + i`` (the JAX layout).  The port stores the words
as ``int32`` with the JAX words' exact bits, so converting between the
packages is a ``.view``.  Bit 31 sits in the sign: a test shifts the word
right (arithmetic, sign-filling) and then takes ``& 1``, which reads the
right bit either way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MAX_SAMPLES, SQRT3

SQRT3_MAX_SAMPLES = SQRT3 / MAX_SAMPLES
SQRT3_2 = 2.0 * SQRT3

U32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor -> int64 holding its uint32 value (a negative
    int32 wraps as the JAX ``int32 -> uint32`` cast does)."""
    return x.to(torch.int64) & U32


def mul_u32(a: torch.Tensor, p: int) -> torch.Tensor:
    """``(a * p) mod 2**32`` for int64 ``a`` in [0, 2**32) and a constant
    ``p`` in [0, 2**32), without int64 overflow: the product is split at
    16 bits of ``p``."""
    lo = a * (p & 0xFFFF)
    hi = ((a * (p >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` to every third bit (int64 out)."""
    v = as_u32(v)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(xyz: torch.Tensor) -> torch.Tensor:
    """(..., 3) integer coords in [0, 1024) -> (...,) int32 morton codes."""
    e = expand_bits(xyz)
    code = e[..., 0] | (e[..., 1] << 1) | (e[..., 2] << 2)
    return code.to(torch.int32)


def _compress_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(codes: torch.Tensor) -> torch.Tensor:
    """Morton codes -> (..., 3) int32 coords."""
    c = as_u32(codes)
    return torch.stack(
        [_compress_bits(c), _compress_bits(c >> 1), _compress_bits(c >> 2)],
        dim=-1,
    ).to(torch.int32)


def frexp_exponent(x: torch.Tensor) -> torch.Tensor:
    """Exponent ``e`` with ``x = f * 2**e``, ``f in (0.5, 1]``, from the
    IEEE-754 bits (0 for x == 0); int32."""
    x = x.to(torch.float32)
    bits = x.contiguous().view(torch.int32)
    exponent = ((bits & 0x7F800000) >> 23) - 127
    frac = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)  # [1, 2)
    exponent = torch.where(frac > 1.0, exponent + 1, exponent)
    return torch.where(x == 0.0, torch.zeros_like(exponent), exponent)


def mip_from_pos(xyz: torch.Tensor, cascades: int) -> torch.Tensor:
    """Cascade from position."""
    mx = torch.amax(torch.abs(xyz), dim=-1)
    return torch.clamp(frexp_exponent(mx) + 1, 0, cascades - 1)


def mip_from_dt(dt: torch.Tensor, grid_size: int, cascades: int):
    """Cascade from step size."""
    return torch.clamp(frexp_exponent(dt * grid_size), 0, cascades - 1)


def calc_dt(t: torch.Tensor, exp_step_factor: float, grid_size: int,
            scale: float) -> torch.Tensor:
    """Marching step size at ``t``."""
    return torch.clamp(t * exp_step_factor, SQRT3_MAX_SAMPLES,
                       SQRT3_2 * scale / grid_size)


def packbits_u32(density_grid: torch.Tensor, threshold) -> torch.Tensor:
    """(n_cells,) densities, n_cells % 32 == 0 -> (n_cells // 32,) int32
    words of the bits ``density > threshold``."""
    occ = (density_grid > threshold).reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=occ.device)
    words = torch.sum(occ << shifts, dim=-1)  # the uint32 value
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def bitfield_test(bitfield: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Occupancy bit ``idx`` of an int32 bitfield, as bool."""
    idx = as_u32(idx)
    word = bitfield[idx >> 5]
    return ((word >> (idx & 31)) & 1).to(torch.bool)


def bitfield_to_u8(bitfield: torch.Tensor) -> torch.Tensor:
    """The bitfield as the reference's uint8 layout (4 bytes per word,
    little-endian)."""
    w = as_u32(bitfield)
    bytes_ = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    return bytes_.reshape(-1).to(torch.uint8)


def morton3d_np(xyz) -> np.ndarray:
    """Numpy morton encode (host-side precomputation)."""
    v = np.asarray(xyz, np.uint32)

    def expand(v):
        v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
        v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
        v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
        v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
        return v

    e = expand(v)
    return (
        e[..., 0] | (e[..., 1] << np.uint32(1)) | (e[..., 2] << np.uint32(2))
    ).astype(np.int32)


def grid_coords_np(grid_size: int) -> np.ndarray:
    """(G^3, 3) int32 cell coordinates, x fastest."""
    g = np.arange(grid_size, dtype=np.int32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    return np.stack([x, y, z], axis=-1).reshape(-1, 3)


def grid_coords(grid_size: int, device=None) -> torch.Tensor:
    """:func:`grid_coords_np` as an int32 tensor."""
    return torch.as_tensor(grid_coords_np(grid_size), device=device)
