// Shear-warp chunk sweep, backward — hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ops/swr_pallas.py:_bwd_kernel of the JAX
// package (launched by _bwd_call from _sweep_bwd, the VJP of its
// chunk_sweep).  The plain PyTorch version of the same function is autograd
// through taichi_nerfs_torch/ops/swr_sweep.py:chunk_sweep_reference
// (chunk_sweep_bwd_reference there); the forward is csrc/swr_sweep_fwd.cu.
//
// What it computes: dvol = d<g, frames>/d vol for the frames of the forward
// sweep, given the upstream cotangent g (n_chunks, F + 2, nq, nq) on all
// channels [acc (F - 1) | depth | opacity | tau].  Two launches, no atomics,
// so the result does not change from run to run:
//
// (a) swr_sweep_bwd_lattice: one thread per lattice point (c, i, j), one
//     reverse sweep over the chunk's slabs with no stored activations, as
//     the TPU kernel does.  Per slab s = dc - 1 ... 0 it resamples the slab
//     onto the point by taps exactly as the forward kernel does (same tap
//     positions, same rounding), then
//       sigma = max(x[0], 0), sdt = sigma dt, a = 1 - exp(-sdt),
//       tau_k = tau - sdt  (tau starts at the forward's tau_N, frames[F+1]:
//                           the transmittance is rebuilt in log space from
//                           the CLAMPED sigmas, as the forward summed them),
//       T_k = exp(-tau_k), w = a T_k,
//       phi = t_ray g_depth + g_opacity + sum_f x[f] g[f - 1],
//       d a = T_k (phi - U)           (U: the normalised downstream suffix),
//       d sigma = d a (1 - a) dt + g_tau dt,
//       dx2[0] = x[0] > 0 ? d sigma : 0,  dx2[f] = w g[f - 1] (f >= 1),
//       U = (1 - a) U + a phi,  tau = tau_k,
//     and writes dx2 (n_chunks, dc, F, nq, nq) to scratch.
// (b) swr_sweep_bwd_scatter: the transposed resample as a gather, one
//     thread per source voxel (c, s, m, n) for all F channels:
//       dvol[c, s, f, m, n] = sum_i sum_j Wb[i, m] Wc[j, n] dx2[c, s, f, i, j]
//     with W[i, m] = k(m - (start + i step)), the forward's weights.  The
//     lattice points whose taps reach voxel m are those with
//     |m - p_i| < support (1 linear, 2 cubic), a contiguous range of i.  It
//     is computed from (start, step) with min/max, so the sign of the step
//     is not assumed, widened by one point on each side against rounding,
//     and each weight inside it is the forward's weight recomputed exactly
//     (0 where the forward had no tap), so the range only bounds the loop.
//     A non-finite range (step 0, or non-finite parameters) scans the whole
//     lattice.
//
// What bounds it on this card.  (a) is the forward's tap gather (4 or 16
// loads per channel per slab from L1/L2) plus one coalesced fp32 store per
// channel per slab: dx2 is nc * dc * F * nq^2 * 4 bytes, 606 MB at the R=256
// training shape (nc=16, dc=16, F=8, nq=272), written once and read once by
// (b).  (b) reads about (support * 2 / step)^2 dx2 values per channel per
// covered voxel, through L1/L2 (neighbouring threads read overlapping
// windows), and writes dvol once, coalesced.  Voxels that no lattice point
// reaches exit after computing an empty range.  The TPU kernel instead runs
// two dense transposed matmuls per channel on the MXU; the tensor-core form
// of the banded products is later work.  Operands are fp32 only.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// Same polynomial as csrc/swr_sweep_fwd.cu and ops/warp.py:interp_kernel.
template <int KIND>
__device__ __forceinline__ float kern(float x) {
  float ax = fabsf(x);
  if (KIND == 0) return fmaxf(0.0f, 1.0f - ax);
  float w1 = (1.5f * ax - 2.5f) * ax * ax + 1.0f;
  float w2 = ((-0.5f * ax + 2.5f) * ax - 4.0f) * ax + 2.0f;
  return ax <= 1.0f ? w1 : (ax < 2.0f ? w2 : 0.0f);
}

// Lattice position start + i * step, rounded as the forward kernel and the
// plain version round it (unfused multiply, then add).
__device__ __forceinline__ float lat_pos(float start, float step, int i) {
  return __fadd_rn(start, __fmul_rn((float)i, step));
}

// Identical to the forward kernel's taps(): first source index and the NT
// weights of one lattice coordinate p on a source axis of length n.
template <int KIND, int NT>
__device__ __forceinline__ void taps(float p, int n, int* idx, float* w) {
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
swr_sweep_bwd_lattice(const float* __restrict__ vol,     // (nc, dc, F, Rb, Rc)
                      const float* __restrict__ rs_par,  // (nc, dc, 4)
                      const float* __restrict__ z_rel,   // (nc, dc)
                      const float* __restrict__ ch_par,  // (nc, 6)
                      const float* __restrict__ frames,  // (nc, F + 2, nq, nq)
                      const float* __restrict__ g,       // (nc, F + 2, nq, nq)
                      float* __restrict__ dx2,           // (nc, dc, F, nq, nq)
                      int dc, int Rb, int Rc, int nq) {
  constexpr int NT = KIND == 0 ? 2 : 4;
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int c = blockIdx.z;
  if (i >= nq || j >= nq) return;

  const float* chp = ch_par + 6 * c;
  const float va = chp[4], h = chp[5];
  const float vb = __fadd_rn(chp[0], __fmul_rn(chp[1], (float)i));
  const float vc = __fadd_rn(chp[2], __fmul_rn(chp[3], (float)j));
  const float norm = sqrtf(va * va + vb * vb + vc * vc);
  const float dt = h * norm / fabsf(va);
  const float tb = norm / va;

  const size_t npix = (size_t)nq * nq;
  const size_t pix = (size_t)i * nq + j;
  const float* gp = g + (size_t)c * (F + 2) * npix + pix;
  float gf[F - 1];
#pragma unroll
  for (int f = 0; f < F - 1; ++f) gf[f] = gp[f * npix];
  const float g_dep = gp[(F - 1) * npix];
  const float g_op = gp[F * npix];
  const float g_tau = gp[(F + 1) * npix];
  float tau = frames[(size_t)c * (F + 2) * npix + (F + 1) * npix + pix];
  float U = 0.0f;

  const size_t plane = (size_t)Rb * Rc;
  for (int s = dc - 1; s >= 0; --s) {
    const size_t cs = (size_t)c * dc + s;
    const float* rs = rs_par + 4 * cs;
    int ib[NT], jc[NT];
    float wb[NT], wc[NT];
    taps<KIND, NT>(lat_pos(rs[0], rs[1], i), Rb, ib, wb);
    taps<KIND, NT>(lat_pos(rs[2], rs[3], j), Rc, jc, wc);
    const float* slab = vol + cs * F * plane;

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
    const float a = 1.0f - one_m_a;
    const float tau_k = tau - sdt;
    const float t_k = expf(-tau_k);
    const float w = a * t_k;
    float phi = z_rel[cs] * tb * g_dep + g_op;
#pragma unroll
    for (int f = 1; f < F; ++f) phi += x[f] * gf[f - 1];
    const float da = t_k * (phi - U);
    const float dsigma = da * one_m_a * dt + g_tau * dt;

    float* d = dx2 + cs * F * npix + pix;
    d[0] = x[0] > 0.0f ? dsigma : 0.0f;
#pragma unroll
    for (int f = 1; f < F; ++f) d[f * npix] = w * gf[f - 1];

    tau = tau_k;
    U = one_m_a * U + a * phi;
  }
}

// The lattice points i in [0, nq) whose position start + i * step lies
// within `support` of source index m: [lo, hi], empty when hi < lo.
__device__ __forceinline__ void lattice_range(float start, float step, int m,
                                              float support, int nq, int* lo,
                                              int* hi) {
  const float a = ((float)m - support - start) / step;
  const float b = ((float)m + support - start) / step;
  float l = fminf(a, b), u = fmaxf(a, b);
  if (!(isfinite(l) && isfinite(u))) {
    *lo = 0;
    *hi = nq - 1;
    return;
  }
  l = fmaxf(l, -2.0f);
  u = fminf(u, (float)nq + 1.0f);
  *lo = max(0, (int)floorf(l) - 1);
  *hi = min(nq - 1, (int)ceilf(u) + 1);
}

template <int F, int KIND>
__global__ void __launch_bounds__(kBlockX * kBlockY)
swr_sweep_bwd_scatter(const float* __restrict__ rs_par,  // (nc, dc, 4)
                      const float* __restrict__ dx2,     // (nc, dc, F, nq, nq)
                      float* __restrict__ dvol,          // (nc, dc, F, Rb, Rc)
                      int Rb, int Rc, int nq) {
  constexpr float kSupport = KIND == 0 ? 1.0f : 2.0f;
  const int n = blockIdx.x * kBlockX + threadIdx.x;
  const int m = blockIdx.y * kBlockY + threadIdx.y;
  const size_t cs = blockIdx.z;  // c * dc + s
  if (m >= Rb || n >= Rc) return;

  const float* rs = rs_par + 4 * cs;
  const float start_b = rs[0], step_b = rs[1];
  const float start_c = rs[2], step_c = rs[3];
  int i_lo, i_hi, j_lo, j_hi;
  lattice_range(start_b, step_b, m, kSupport, nq, &i_lo, &i_hi);
  lattice_range(start_c, step_c, n, kSupport, nq, &j_lo, &j_hi);

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  const size_t npix = (size_t)nq * nq;
  const float* src = dx2 + cs * F * npix;
  for (int i = i_lo; i <= i_hi; ++i) {
    const float p = lat_pos(start_b, step_b, i);
    // the forward's tap test (near, and m among floor(p)'s taps) reduces
    // to the weight itself: k(m - p) is 0 outside the support
    const float wb = (p > -4.0f && p < (float)Rb + 4.0f)
                         ? kern<KIND>((float)m - p)
                         : 0.0f;
    if (wb == 0.0f) continue;
    const float* row = src + (size_t)i * nq;
    for (int j = j_lo; j <= j_hi; ++j) {
      const float q = lat_pos(start_c, step_c, j);
      const float wc = (q > -4.0f && q < (float)Rc + 4.0f)
                           ? kern<KIND>((float)n - q)
                           : 0.0f;
      if (wc == 0.0f) continue;
      const float w = wb * wc;
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += w * __ldg(row + f * npix + j);
    }
  }
  const size_t plane = (size_t)Rb * Rc;
  float* o = dvol + cs * F * plane + (size_t)m * Rc + n;
#pragma unroll
  for (int f = 0; f < F; ++f) o[f * plane] = acc[f];
}

template <int F, int KIND>
cudaError_t launch(const float* vol, const float* rs_par, const float* z_rel,
                   const float* ch_par, const float* frames, const float* g,
                   float* dx2, float* dvol, int n_chunks, int dc, int Rb,
                   int Rc, int nq, cudaStream_t stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid_a((nq + kBlockX - 1) / kBlockX, (nq + kBlockY - 1) / kBlockY,
              n_chunks);
  swr_sweep_bwd_lattice<F, KIND><<<grid_a, block, 0, stream>>>(
      vol, rs_par, z_rel, ch_par, frames, g, dx2, dc, Rb, Rc, nq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_b((Rc + kBlockX - 1) / kBlockX, (Rb + kBlockY - 1) / kBlockY,
              n_chunks * dc);
  swr_sweep_bwd_scatter<F, KIND><<<grid_b, block, 0, stream>>>(
      rs_par, dx2, dvol, Rb, Rc, nq);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t dispatch_f(int F, const float* vol, const float* rs_par,
                       const float* z_rel, const float* ch_par,
                       const float* frames, const float* g, float* dx2,
                       float* dvol, int n_chunks, int dc, int Rb, int Rc,
                       int nq, cudaStream_t stream) {
  switch (F) {
    case 4:
      return launch<4, KIND>(vol, rs_par, z_rel, ch_par, frames, g, dx2,
                             dvol, n_chunks, dc, Rb, Rc, nq, stream);
    case 8:
      return launch<8, KIND>(vol, rs_par, z_rel, ch_par, frames, g, dx2,
                             dvol, n_chunks, dc, Rb, Rc, nq, stream);
    case 16:
      return launch<16, KIND>(vol, rs_par, z_rel, ch_par, frames, g, dx2,
                              dvol, n_chunks, dc, Rb, Rc, nq, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  kind: 0 linear, 1 cubic.
// dx2 is caller-allocated scratch of n_chunks * dc * F * nq * nq floats.
// Returns cudaGetLastError() after the launches (0 on success); an F other
// than 4, 8, 16, an unknown kind or more than 65535 chunk slabs returns
// cudaErrorInvalidValue.
extern "C" int swr_sweep_bwd(const float* vol, const float* rs_par,
                             const float* z_rel, const float* ch_par,
                             const float* frames, const float* g, float* dx2,
                             float* dvol, int n_chunks, int dc, int F, int Rb,
                             int Rc, int nq, int kind, void* stream) {
  if (n_chunks <= 0 || dc <= 0 || Rb <= 0 || Rc <= 0 || nq <= 0 ||
      (long long)n_chunks * dc > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return (int)dispatch_f<0>(F, vol, rs_par, z_rel, ch_par, frames, g, dx2,
                              dvol, n_chunks, dc, Rb, Rc, nq, st);
  if (kind == 1)
    return (int)dispatch_f<1>(F, vol, rs_par, z_rel, ch_par, frames, g, dx2,
                              dvol, n_chunks, dc, Rb, Rc, nq, st);
  return (int)cudaErrorInvalidValue;
}
