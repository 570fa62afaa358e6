// Shear-warp chunk sweep: the resample helpers that the forward
// (csrc/swr_sweep_fwd.cu) and the backward (csrc/swr_sweep_bwd.cu) share,
// so that the backward recomputes the forward's samples with the same
// taps, weights and rounding.  Each kernel file includes this header; its
// content is part of both libraries' build hash (ops/_build.py).
//
// A lattice coordinate p = start + i * step (an unfused multiply, then an
// add) is resampled from a source axis of length n by the taps
// m0 ... m0 + NT - 1, m0 = floor(p) - (NT / 2 - 1), with weights k(m - p):
// NT = 2 for the linear tent (kind 0), 4 for Catmull-Rom (kind 1).  The
// dense interpolation matrix of the plain version is 0 at every other m
// (see csrc/swr_sweep_fwd.cu), so a tap sum is the dense product with the
// fp32 additions in another order.
//
// Two dtype axes, as the Pallas kernels take them (ops/swr_pallas.py:
// _interp / _interp_T and the .astype(dtype) of the slab and of the pass-1
// product): the volume's type T (float or __nv_bfloat16; a bf16 voxel is
// exact in fp32) and the operand flag OPB.  With OPB every resample operand
// is rounded to bf16 (round to nearest even) where the TPU kernel rounds
// it: each tap weight as it is made, each fp32 voxel as it is read, and
// each pass-1 value before pass 2 reads it.  A product of two bf16 values
// is exact in fp32 and every sum stays fp32, as preferred_element_type=f32
// accumulates.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
// the widest window (source columns) a warp resamples through its row
// buffer in shared memory: a step up to ~2.4 voxels across a 64-column
// tile; a wider one takes the tap-by-tap path (a step of 3 needs 193
// columns)
constexpr int kRowCols = 160;
constexpr unsigned kFullMask = 0xffffffffu;

// x rounded to the operand dtype: bf16 (round to nearest even) with OPB,
// else x itself
template <bool OPB>
__device__ __forceinline__ float op_round(float x) {
  return OPB ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}

// a voxel as a resample operand: an fp32 voxel read through the L1 and, with
// OPB, rounded to bf16; a bf16 voxel converted exactly
template <bool OPB>
__device__ __forceinline__ float vox(const float* p) {
  return op_round<OPB>(__ldg(p));
}
template <bool OPB>
__device__ __forceinline__ float vox(const __nv_bfloat16* p) {
  return bf16_bits_to_float(
      __ldg(reinterpret_cast<const unsigned short*>(p)));
}

// kind 0: linear tent (support 1, 2 taps); kind 1: Catmull-Rom (support 2,
// 4 taps).  Same polynomial as ops/warp.py:interp_kernel.
template <int KIND>
__device__ __forceinline__ float kern(float x) {
  float ax = fabsf(x);
  if (KIND == 0) return fmaxf(0.0f, 1.0f - ax);
  float w1 = (1.5f * ax - 2.5f) * ax * ax + 1.0f;
  float w2 = ((-0.5f * ax + 2.5f) * ax - 4.0f) * ax + 2.0f;
  return ax <= 1.0f ? w1 : (ax < 2.0f ? w2 : 0.0f);
}

// Lattice position start + i * step as an unfused multiply, then an add
// (no fma contraction), so it rounds as the plain version's does.
__device__ __forceinline__ float lat_pos(float start, float step, int i) {
  return __fadd_rn(start, __fmul_rn((float)i, step));
}

// The first tap of lattice coordinate p, or -8 when p is far outside the
// source (or not finite) and every tap is padding.
template <int NT>
__device__ __forceinline__ int first_tap(float p, int n) {
  const bool near = p > -4.0f && p < (float)n + 4.0f;
  return near ? (int)floorf(p) - (NT / 2 - 1) : -8;
}

// Taps of one lattice coordinate p on a source axis of length n: the NT
// weights k(m0 + t - p) (rounded to bf16 with OPB) and indices.  Taps
// outside [0, n) get weight 0 (and a clamped, never-dereferenced-out-of-
// range index).  Returns whether any tap lies in [0, n).
//
// Cubic: the branch of k is known per tap.  For m0 = floor(p) - 1,
// |m0 + 1 - p| and |m0 + 2 - p| are in [0, 1] and |m0 - p|, |m0 + 3 - p| in
// [1, 2] (rounding keeps them there: both ends are exact in fp32), and at
// |x| = 1 both polynomials are exactly 0, so evaluating only the tap's own
// branch gives kern()'s weights bit for bit.
template <int KIND, int NT, bool OPB>
__device__ __forceinline__ bool taps(float p, int n, int* idx, float* w) {
  const bool near = p > -4.0f && p < (float)n + 4.0f;
  const int m0 = first_tap<NT>(p, n);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int m = m0 + t;
    const bool in = near && m >= 0 && m < n;
    float k;
    if (KIND == 0) {
      k = kern<KIND>((float)m - p);
    } else {
      const float ax = fabsf((float)m - p);
      k = (t == 1 || t == 2)
              ? (1.5f * ax - 2.5f) * ax * ax + 1.0f
              : (ax < 2.0f ? ((-0.5f * ax + 2.5f) * ax - 4.0f) * ax + 2.0f
                           : 0.0f);
    }
    w[t] = in ? op_round<OPB>(k) : 0.0f;
    idx[t] = in ? m : 0;
  }
  return near && m0 + NT - 1 >= 0 && m0 < n;
}

// taps() for a p that is the same on every lane of the warp: lane t % NT
// evaluates weight t and the lanes share them; the same values as taps().
template <int KIND, int NT, bool OPB>
__device__ __forceinline__ bool warp_taps(float p, int n, int* idx,
                                          float* w) {
  const bool near = p > -4.0f && p < (float)n + 4.0f;
  const int m0 = first_tap<NT>(p, n);
  const int mine = m0 + (int)(threadIdx.x % NT);
  const float wt = near && mine >= 0 && mine < n
                       ? op_round<OPB>(kern<KIND>((float)mine - p))
                       : 0.0f;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int m = m0 + t;
    w[t] = __shfl_sync(kFullMask, wt, t);
    idx[t] = near && m >= 0 && m < n ? m : 0;
  }
  return near && m0 + NT - 1 >= 0 && m0 < n;
}

// The window [lo, lo + cnt) of source indices that the taps of lattice
// indices a0 and a1 (a tile's first and last live ones), and of every index
// between, reach on an axis of length n, with one voxel of margin on each
// side: lattice positions are monotone in the lattice index (each rounding
// step is), so the extreme taps are those of a0 and a1, taken with min /
// max so the sign of the step is not assumed.  cnt is 0 when they reach no
// index.  False when a position is not finite.  The window decides which
// columns are resampled, never a weight.
template <int NT>
__device__ __forceinline__ bool axis_window(float start, float step, int a0,
                                            int a1, int n, int* lo,
                                            int* cnt) {
  const float pa = lat_pos(start, step, a0);
  const float pb = lat_pos(start, step, a1);
  if (!(isfinite(pa) && isfinite(pb))) return false;
  // a point beyond (-4, n + 4) has no taps: clamping there keeps the int
  // conversion in range and loses no tap
  const float lim_lo = -8.0f, lim_hi = (float)n + 8.0f;
  const float p_lo = fminf(fmaxf(fminf(pa, pb), lim_lo), lim_hi);
  const float p_hi = fminf(fmaxf(fmaxf(pa, pb), lim_lo), lim_hi);
  // the first and last taps of the tile
  const int l = (int)floorf(p_lo) - (NT / 2 - 1);
  const int h = (int)floorf(p_hi) + NT / 2;
  if (h < 0 || l >= n) {
    *lo = 0;
    *cnt = 0;
    return true;
  }
  *lo = max(l - 1, 0);
  *cnt = min(h + 1, n - 1) - *lo + 1;
  return true;
}

// Pass 1: the warp's lattice row (b taps ib, wb) resampled against source
// columns [c0, c0 + ncol) of every channel of the slab, into the warp's row
// buffer yrow ([channel][kRowCols]), each value rounded to the operand
// dtype.  The lanes walk the columns; each lane loads its column's taps of
// every channel before it sums any.  bf16 voxels with vec8 (rows of whole
// 16-byte groups, a 16-byte aligned slab): the lanes walk (channel,
// 8-column group) pairs instead, one 16-byte load a tap row, over the
// groups that hold the window (columns outside it are not stored).  Both
// sum a column's taps in the same order.
template <int F, int NT, bool OPB, typename T>
__device__ __forceinline__ void resample_row(const T* slab, size_t plane,
                                             int Rc, int c0, int ncol,
                                             const int* ib, const float* wb,
                                             float* yrow, bool vec8) {
  int row_off[NT];
#pragma unroll
  for (int u = 0; u < NT; ++u) row_off[u] = ib[u] * Rc;
  if constexpr (sizeof(T) == 2) {
    if (vec8) {
      const int a0 = c0 & ~7;
      const int ng = (c0 + ncol - a0 + 7) >> 3;
      for (int e = threadIdx.x; e < F * ng; e += kWarp) {
        const int f = e / ng;
        const int col0 = a0 + 8 * (e - f * ng);
        uint4 q[NT];
#pragma unroll
        for (int u = 0; u < NT; ++u)
          q[u] = __ldg(reinterpret_cast<const uint4*>(slab + f * plane +
                                                      row_off[u] + col0));
        float col[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) col[k] = 0.0f;
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          const unsigned w4[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            col[2 * k] += wb[u] * bf16_bits_to_float(w4[k] & 0xffffu);
            col[2 * k + 1] += wb[u] * bf16_bits_to_float(w4[k] >> 16);
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int n = col0 + k - c0;
          if (n >= 0 && n < ncol)
            yrow[f * kRowCols + n] = op_round<OPB>(col[k]);
        }
      }
      return;
    }
  }
  for (int n = threadIdx.x; n < ncol; n += kWarp) {
    const T* src = slab + c0 + n;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float col = 0.0f;
#pragma unroll
      for (int u = 0; u < NT; ++u)
        col += wb[u] * vox<OPB>(src + f * plane + row_off[u]);
      yrow[f * kRowCols + n] = op_round<OPB>(col);
    }
  }
}

// Pass 2: every channel of one lattice point from the warp's row buffer at
// its c taps (jc, wc); a tap with weight 0 reads a clamped column inside
// the window.
template <int F, int NT>
__device__ __forceinline__ void resample_col(const float* yrow, int c0,
                                             int ncol, const int* jc,
                                             const float* wc, float* x) {
  int cols[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) cols[t] = min(max(jc[t] - c0, 0), ncol - 1);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float sum = 0.0f;
#pragma unroll
    for (int tc = 0; tc < NT; ++tc) sum += yrow[f * kRowCols + cols[tc]] * wc[tc];
    x[f] = sum;
  }
}

// Every channel of this thread's lattice point, each tap read from device
// memory (the same association as pass 1 then pass 2, the pass-1 value
// rounded to the operand dtype as pass 1 rounds it).
template <int F, int NT, bool OPB, typename T>
__device__ __forceinline__ void resample_taps(const T* slab, size_t plane,
                                              int Rc, const int* ib,
                                              const float* wb, const int* jc,
                                              const float* wc, float* x) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const T* src = slab + f * plane;
    float sum = 0.0f;
#pragma unroll
    for (int tc = 0; tc < NT; ++tc) {
      float col = 0.0f;
#pragma unroll
      for (int u = 0; u < NT; ++u)
        col += wb[u] * vox<OPB>(src + (size_t)ib[u] * Rc + jc[tc]);
      sum += op_round<OPB>(col) * wc[tc];
    }
    x[f] = sum;
  }
}

}  // namespace
