// Shear-warp chunk sweep, forward — hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ops/swr_pallas.py:_fwd_kernel of the JAX
// package (launched by _fwd_call, the primal of its chunk_sweep).  The plain PyTorch
// version of the same function is
// taichi_nerfs_torch/ops/swr_sweep.py:chunk_sweep_reference.
//
// What it computes.  For each chunk c, each lattice point (i, j) of the
// chunk's nq x nq frame, and each of the chunk's dc slabs s in order:
//   1. resample every channel f of the slab onto the lattice point,
//        x[f] = sum_m sum_n Wb[i, m] Wc[j, n] vol[c, s, f, m, n],
//      with W[i, m] = k(m - (start + i * step)) built from the slab's
//      (start_b, step_b, start_c, step_c) and k the linear tent or the
//      Catmull-Rom (a = -0.5) kernel;
//   2. sigma = max(x[0], 0), alpha = 1 - exp(-sigma * dt), with the per-chunk
//      dt = h |v| / |v_a| and depth factor tb = |v| / v_a at the point;
//   3. carry T (transmittance), tau (sum of sigma dt), sum w * x[1..F-1] and
//      sum w * z_rel[s] * tb front to back, w = alpha * T.
// After the last slab it writes the F + 2 channels
// [acc (F - 1) | depth | opacity = 1 - T | tau] of out[c, :, i, j].
//
// Resampling by taps, not by dense matrices.  The TPU kernel multiplies by
// the dense (nq x Rb) and (Rc x nq) interpolation matrices on the MXU.  Those
// matrices are banded by construction: k(x) is 0 for |x| >= 1 (linear) or
// |x| >= 2 (cubic), so row i of Wb is nonzero only at m = floor(p),
// floor(p) + 1 (linear) or m = floor(p) - 1 ... floor(p) + 2 (cubic), where
// p = start + i * step, whatever the step is.  The weight at every other m
// is exactly 0 in the dense product too: m - p is computed in fp32 and
// rounding is monotone, so |m - p| cannot round below the kernel's support
// edge (1 or 2, both exact in fp32).  The dense product is therefore the tap
// sum over those 2 x 2 or 4 x 4 source points, and taps outside
// [0, Rb) x [0, Rc) contribute 0, which is the dense product's zero padding.
// The only difference is the order of the fp32 additions.
//
// Layout.  One thread per lattice point of one chunk; grid
// (ceil(nq / 32), ceil(nq / 8), n_chunks), block (32, 8).  The contiguous
// axis of the source slab and of the output (j, along Rc and nq) runs along
// threadIdx.x, so a warp reads neighbouring source columns and writes one
// contiguous row segment.  The carry (T, tau, F - 1 features, depth) lives
// in registers for the whole sweep; F and the kernel kind are template
// parameters so that the feature array stays in registers.
//
// What bounds it on this card.  Gathered tap loads from L1/L2: per lattice
// point per slab, 4 (linear) or 16 (cubic) taps x F channels of 4 bytes,
// i.e. 128 or 512 loads at F = 8, against about 10 flops each.  The source
// slab (F x Rb x Rc fp32, 2 MiB at F = 8, R = 256) stays in the 50 MB L2, so
// device memory is read about once per slab; the cost is the L1/L2 load
// rate.  The TPU's form, two matrix products per channel on the tensor cores
// (wgmma fed by TMA tiles of the slab and of the banded weights), does
// (nq Rb Rc + nq^2 Rc) multiply-adds instead of 16 nq^2 per channel; that
// tiling is later work.  Operands are fp32 only.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

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

// Taps of one lattice coordinate p on a source axis of length n: first
// source index m0 and the NT weights k(m0 + t - p).  Taps outside [0, n)
// get weight 0 (and a clamped, never-dereferenced-out-of-range index).
template <int KIND, int NT>
__device__ __forceinline__ void taps(float p, int n, int* idx, float* w) {
  // p far outside the source (or not finite): every tap is padding
  const bool near = p > -4.0f && p < (float)n + 4.0f;
  const int m0 = near ? (int)floorf(p) - (NT / 2 - 1) : -8;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int m = m0 + t;
    const bool in = near && m >= 0 && m < n;
    w[t] = in ? kern<KIND>((float)m - p) : 0.0f;
    idx[t] = in ? m : 0;
  }
}

template <int F, int KIND>
__global__ void __launch_bounds__(kBlockX * kBlockY)
swr_sweep_fwd_kernel(const float* __restrict__ vol,     // (nc, dc, F, Rb, Rc)
                     const float* __restrict__ rs_par,  // (nc, dc, 4)
                     const float* __restrict__ z_rel,   // (nc, dc)
                     const float* __restrict__ ch_par,  // (nc, 6)
                     float* __restrict__ out,           // (nc, F + 2, nq, nq)
                     int dc, int Rb, int Rc, int nq) {
  constexpr int NT = KIND == 0 ? 2 : 4;
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int c = blockIdx.z;
  if (i >= nq || j >= nq) return;

  // per-chunk ray geometry at this lattice point (swr_pallas.py:_geom)
  const float* chp = ch_par + 6 * c;
  const float va = chp[4], h = chp[5];
  // positions as an unfused multiply, then add (no fma contraction), so
  // they round as the plain version's `start + i * step` does
  const float vb = __fadd_rn(chp[0], __fmul_rn(chp[1], (float)i));
  const float vc = __fadd_rn(chp[2], __fmul_rn(chp[3], (float)j));
  const float norm = sqrtf(va * va + vb * vb + vc * vc);
  const float dt = h * norm / fabsf(va);
  const float tb = norm / va;

  float acc[F - 1];
#pragma unroll
  for (int f = 0; f < F - 1; ++f) acc[f] = 0.0f;
  float depth = 0.0f, T = 1.0f, tau = 0.0f;

  const size_t plane = (size_t)Rb * Rc;
  for (int s = 0; s < dc; ++s) {
    const float* rs = rs_par + 4 * ((size_t)c * dc + s);
    int ib[NT], jc[NT];
    float wb[NT], wc[NT];
    taps<KIND, NT>(__fadd_rn(rs[0], __fmul_rn((float)i, rs[1])), Rb, ib, wb);
    taps<KIND, NT>(__fadd_rn(rs[2], __fmul_rn((float)j, rs[3])), Rc, jc, wc);
    const float* slab = vol + ((size_t)c * dc + s) * F * plane;

    float x[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float* src = slab + f * plane;
      float sum = 0.0f;
#pragma unroll
      for (int tc = 0; tc < NT; ++tc) {
        float col = 0.0f;
#pragma unroll
        for (int u = 0; u < NT; ++u)
          col += wb[u] * __ldg(src + (size_t)ib[u] * Rc + jc[tc]);
        sum += col * wc[tc];
      }
      x[f] = sum;
    }

    const float sdt = fmaxf(x[0], 0.0f) * dt;
    const float one_m_a = expf(-sdt);
    const float w = (1.0f - one_m_a) * T;
#pragma unroll
    for (int f = 1; f < F; ++f) acc[f - 1] += w * x[f];
    depth += w * (z_rel[(size_t)c * dc + s] * tb);
    T *= one_m_a;
    tau += sdt;
  }

  const size_t npix = (size_t)nq * nq;
  float* o = out + (size_t)c * (F + 2) * npix + (size_t)i * nq + j;
#pragma unroll
  for (int f = 0; f < F - 1; ++f) o[f * npix] = acc[f];
  o[(F - 1) * npix] = depth;
  o[F * npix] = 1.0f - T;
  o[(F + 1) * npix] = tau;
}

template <int F, int KIND>
cudaError_t launch(const float* vol, const float* rs_par, const float* z_rel,
                   const float* ch_par, float* out, int n_chunks, int dc,
                   int Rb, int Rc, int nq, cudaStream_t stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((nq + kBlockX - 1) / kBlockX, (nq + kBlockY - 1) / kBlockY,
            n_chunks);
  swr_sweep_fwd_kernel<F, KIND><<<grid, block, 0, stream>>>(
      vol, rs_par, z_rel, ch_par, out, dc, Rb, Rc, nq);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t dispatch_f(int F, const float* vol, const float* rs_par,
                       const float* z_rel, const float* ch_par, float* out,
                       int n_chunks, int dc, int Rb, int Rc, int nq,
                       cudaStream_t stream) {
  switch (F) {
    case 4:
      return launch<4, KIND>(vol, rs_par, z_rel, ch_par, out, n_chunks, dc,
                             Rb, Rc, nq, stream);
    case 8:
      return launch<8, KIND>(vol, rs_par, z_rel, ch_par, out, n_chunks, dc,
                             Rb, Rc, nq, stream);
    case 16:
      return launch<16, KIND>(vol, rs_par, z_rel, ch_par, out, n_chunks, dc,
                              Rb, Rc, nq, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  kind: 0 linear, 1 cubic.
// Returns cudaGetLastError() after the launch (0 on success); an F other
// than 4, 8, 16 or an unknown kind returns cudaErrorInvalidValue.
extern "C" int swr_sweep_fwd(const float* vol, const float* rs_par,
                             const float* z_rel, const float* ch_par,
                             float* out, int n_chunks, int dc, int F, int Rb,
                             int Rc, int nq, int kind, void* stream) {
  if (n_chunks <= 0 || dc <= 0 || Rb <= 0 || Rc <= 0 || nq <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return (int)dispatch_f<0>(F, vol, rs_par, z_rel, ch_par, out, n_chunks,
                              dc, Rb, Rc, nq, st);
  if (kind == 1)
    return (int)dispatch_f<1>(F, vol, rs_par, z_rel, ch_par, out, n_chunks,
                              dc, Rb, Rc, nq, st);
  return (int)cudaErrorInvalidValue;
}
