// Shear-warp final warp (the two-pass band warp) — hand-written CUDA for
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's final warp is XLA: two batched
// products of dense band matrices, which the TPU's matrix unit runs well.
// The plain PyTorch version of the same function, which the port runs on
// the CPU and under autograd, is
// taichi_nerfs_torch/ops/warp.py:band_warp_reference; this kernel serves
// every frame on the card that needs no gradient (ops/warp.py:band_warp).
//
// What it computes.  The global frame img (C, nq, nq), channel c at lattice
// row i and column j, goes to the pixels out (C, H, W) in two passes with
// linear tents, as the plain version's matrices define them:
//   pass A, per lattice column j and output line n (a pixel column u for
//     "matmul", a pixel row v for "matmul_x"):
//       inter[j, c, n] = sum_i img[c, i, j] * max(1 - |i - posA(j, n)|, 0),
//     where posA solves where the camera line n crosses lattice column j
//     (from the pose, K and the global frame's plane and lattice);
//   pass B, per pixel (v, u):
//       out[c, v, u] = sum_j inter[j, c, n] * max(1 - |j - lj[v, u]|, 0),
//     and a pixel whose ray misses the plane (behind[v, u]) is 0.
// With bf16 operands (OPB) the tents, img and inter are rounded to bf16
// before each product; every sum is fp32.
//
// Taps, not matrices.  The plain version builds the (J, I, N) and
// (N, J, N') tent matrices densely: at the uncapped 800x800 frame (nq =
// 816) each is ~2.1 GB, written and read by several elementwise passes and
// two fp32 GEMMs, though only 2 of every column's 816 entries are nonzero.
// A tent max(1 - |m - p|, 0) is nonzero only at m = floor(p) and
// floor(p) + 1: m - p is computed in fp32 and rounding is monotone, so
// |m - p| cannot round below 1 elsewhere.  The dense product is therefore
// the sum over those two taps, and taps outside [0, nq) contribute 0, as
// the dense matrix's missing rows do.
//
// What bounds it on this card: bytes.  The function reads img (C nq^2 fp32)
// and lj and behind once and writes out (C H W fp32) once: ~50 MB uncapped,
// ~15 us at 3.35 TB/s; its operations (a position solve per pixel and j tap,
// 6 multiply-adds per pixel and channel) are far below the fp32 peak.
//
// Design: one fused launch, one thread per pixel, no intermediate in device
// memory.  A thread computes its two j taps from lj, solves posA(j, n) for
// each of them in registers, and sums the two i taps of each: four gathers
// of img per channel.  Neighbouring pixels map to neighbouring lattice
// points (the lattice is about as fine as the pixels), so a 32 x 8 block's
// gathers fall on a small patch of each channel that the L1 serves, and the
// whole frame (26 MB at nq = 816) fits in the 50 MB L2.  The writes are
// coalesced rows of each channel.  (Two passes through a (J, C, N) buffer
// would store and read the intermediate, ~52 MB more, for coalesced rows
// that the cache gives the gathers anyway.)
//
// Exact arithmetic.  Each position and tent is the plain version's fp32
// operations in its order, each one rounded (the __f*_rn intrinsics, which
// nvcc never contracts into an fma), so the tents equal the plain version's
// bit for bit.  Only the order of each pass's two-term sum may differ from
// cuBLAS's: fp32 results agree to a few ulps; with bf16 operands every
// product is exact in fp32, so the sums are single roundings and the
// results agree bit for bit.  The per-frame scalars come from one small
// device tensor geo (pose 3x4 and K 3x3 row-major, then z_g, g_b0, g_db,
// g_c0, g_dc), so the launch needs no host read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <bool OPB>
__device__ __forceinline__ float op_round(float x) {
  return OPB ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// where(|x| < 1e-12, 1e-12, x), the plain version's division guard
__device__ __forceinline__ float guard(float x) {
  return fabsf(x) < 1e-12f ? 1e-12f : x;
}

// The frame's scalars and the products of them that the plain version
// computes once per frame (0-d tensors there).
struct Geo {
  float ra0, ra1, ra2, rb0, rb1, rb2;
  float ra_f, ra_s;        // ra[fidx], ra[sidx]
  float oa_rel;            // o_a - z_g
  float oa_rc_f, oa_rc_2;  // oa_rel * rc[fidx], oa_rel * rc[2]
  float oa_rc_s;           // oa_rel * rc[sidx]
  float oc_gc0;            // o_c - g_c0
  float ob_gb0;            // o_b - g_b0
  float g_db, g_dc;
};

__device__ __forceinline__ Geo load_geo(const float* __restrict__ geo,
                                        int axis, bool mode_x) {
  const int b_axis = axis == 0 ? 1 : 0;
  const int c_axis = axis == 2 ? 1 : 2;
  const int f = mode_x ? 1 : 0, s = mode_x ? 0 : 1;
  const float* ra = geo + 4 * axis;  // pose row `axis`: r[axis], o_a
  const float* rb = geo + 4 * b_axis;
  const float* rc = geo + 4 * c_axis;
  const float o_a = ra[3], o_b = rb[3], o_c = rc[3];
  const float z_g = geo[21], g_b0 = geo[22], g_c0 = geo[24];
  Geo g;
  g.ra0 = ra[0]; g.ra1 = ra[1]; g.ra2 = ra[2];
  g.rb0 = rb[0]; g.rb1 = rb[1]; g.rb2 = rb[2];
  g.ra_f = ra[f]; g.ra_s = ra[s];
  g.oa_rel = __fsub_rn(o_a, z_g);
  g.oa_rc_f = __fmul_rn(g.oa_rel, rc[f]);
  g.oa_rc_2 = __fmul_rn(g.oa_rel, rc[2]);
  g.oa_rc_s = __fmul_rn(g.oa_rel, rc[s]);
  g.oc_gc0 = __fsub_rn(o_c, g_c0);
  g.ob_gb0 = __fsub_rn(o_b, g_b0);
  g.g_db = geo[23];
  g.g_dc = geo[25];
  return g;
}

// posA(j, n): the source-i position of lattice column j on output line n,
// whose free camera-plane coordinate is `free` (the plain version's
// gam -> num, den -> sol -> x_p, y_p -> da_j, db_j -> posA, in its order)
__device__ __forceinline__ float pos_a(const Geo& g, int j, float free,
                                       bool mode_x) {
  const float gam = __fsub_rn(g.oc_gc0, __fmul_rn((float)j, g.g_dc));
  const float num = __fadd_rn(
      __fmul_rn(__fsub_rn(g.oa_rc_f, __fmul_rn(gam, g.ra_f)), free),
      __fsub_rn(g.oa_rc_2, __fmul_rn(gam, g.ra2)));
  const float den = __fadd_rn(__fsub_rn(__fmul_rn(gam, g.ra_s), g.oa_rc_s),
                              0.0f);
  const float sol = __fdiv_rn(num, guard(den));
  const float fz = __fadd_rn(free, 0.0f);
  const float x_p = mode_x ? sol : fz;
  const float y_p = mode_x ? fz : sol;
  const float da = __fadd_rn(
      __fadd_rn(__fmul_rn(g.ra0, x_p), __fmul_rn(g.ra1, y_p)), g.ra2);
  const float db = __fadd_rn(
      __fadd_rn(__fmul_rn(g.rb0, x_p), __fmul_rn(g.rb1, y_p)), g.rb2);
  const float p = __fdiv_rn(
      __fsub_rn(__fmul_rn(g.ob_gb0, da), __fmul_rn(g.oa_rel, db)),
      __fmul_rn(g.g_db, guard(da)));
  return isfinite(p) ? p : -1e9f;
}

// The two taps of the tent at position p on [0, n): the first index and
// both weights (rounded to bf16 with OPB); a tap outside [0, n) gets
// weight 0 and is never read.  A non-finite p has been replaced by -1e9.
template <bool OPB>
struct Taps {
  int m0;
  float w0, w1;
  bool in0, in1;

  __device__ __forceinline__ Taps(float p, int n) {
    in0 = in1 = false;
    m0 = 0;
    w0 = w1 = 0.0f;
    if (!(p > -1.0f && p < (float)n)) return;  // no tap inside
    m0 = (int)floorf(p);
    in0 = m0 >= 0;
    in1 = m0 + 1 < n;
    // clamp(1 - |m - p|, 0), m - p as the plain version rounds it
    w0 = op_round<OPB>(fmaxf(
        __fsub_rn(1.0f, fabsf(__fsub_rn((float)m0, p))), 0.0f));
    w1 = op_round<OPB>(fmaxf(
        __fsub_rn(1.0f, fabsf(__fsub_rn((float)(m0 + 1), p))), 0.0f));
  }
};

// w0 * a0 + w1 * a1 over the taps inside, in the index order (a product,
// then an fma); 0 with no tap inside
__device__ __forceinline__ float tap_sum(bool in0, bool in1, float a0,
                                         float w0, float a1, float w1) {
  if (in0 && in1) return __fmaf_rn(a1, w1, __fmul_rn(a0, w0));
  if (in0) return __fmul_rn(a0, w0);
  if (in1) return __fmul_rn(a1, w1);
  return 0.0f;
}

template <bool OPB>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    swr_band_warp_kernel(const float* __restrict__ img,
                         const float* __restrict__ lj,
                         const unsigned char* __restrict__ behind,
                         const float* __restrict__ geo,
                         float* __restrict__ out, int C, int nq, int H, int W,
                         int axis, bool mode_x) {
  const int u = blockIdx.x * kBlockX + threadIdx.x;
  const int v = blockIdx.y * kBlockY + threadIdx.y;
  if (u >= W || v >= H) return;
  const long long HW = (long long)H * W;
  const long long pix = (long long)v * W + u;
  const long long plane = (long long)nq * nq;
  if (behind[pix]) {
    for (int c = 0; c < C; ++c) out[c * HW + pix] = 0.0f;
    return;
  }
  const Geo g = load_geo(geo, axis, mode_x);
  // the output line n and its free coordinate: ((n - K[0, 2]) + 0.5) /
  // K[0, 0] for a pixel column, the same with K's row 1 for a pixel row
  const int n = mode_x ? v : u;
  const float k_c = mode_x ? geo[12 + 5] : geo[12 + 2];
  const float k_f = mode_x ? geo[12 + 4] : geo[12 + 0];
  const float free = __fdiv_rn(__fadd_rn(__fsub_rn((float)n, k_c), 0.5f),
                               k_f);
  float pb = __ldg(lj + pix);
  if (!isfinite(pb)) pb = -1e9f;
  const Taps<OPB> tj(pb, nq);
  // pass A's i taps at the two j taps (j outside the lattice: no i taps)
  const Taps<OPB> ti0(tj.in0 ? pos_a(g, tj.m0, free, mode_x) : -1e9f, nq);
  const Taps<OPB> ti1(tj.in1 ? pos_a(g, tj.m0 + 1, free, mode_x) : -1e9f,
                      nq);
  // element offsets of the four gathers img[c, i, j] in channel 0 (a tap
  // outside is never read: its offset is a placeholder)
  const long long o00 = (long long)ti0.m0 * nq + tj.m0;
  const long long o10 = o00 + nq;
  const long long o01 = (long long)ti1.m0 * nq + tj.m0 + 1;
  const long long o11 = o01 + nq;
#pragma unroll 2
  for (int c = 0; c < C; ++c) {
    const float* ch = img + c * plane;
    const float a00 = ti0.in0 ? op_round<OPB>(__ldg(ch + o00)) : 0.0f;
    const float a10 = ti0.in1 ? op_round<OPB>(__ldg(ch + o10)) : 0.0f;
    const float a01 = ti1.in0 ? op_round<OPB>(__ldg(ch + o01)) : 0.0f;
    const float a11 = ti1.in1 ? op_round<OPB>(__ldg(ch + o11)) : 0.0f;
    // pass A at each j tap (inter, rounded to the operands), then pass B
    const float x0 = op_round<OPB>(
        tap_sum(ti0.in0, ti0.in1, a00, ti0.w0, a10, ti0.w1));
    const float x1 = op_round<OPB>(
        tap_sum(ti1.in0, ti1.in1, a01, ti1.w0, a11, ti1.w1));
    out[c * HW + pix] = tap_sum(tj.in0, tj.in1, x0, tj.w0, x1, tj.w1);
  }
}

}  // namespace

// img (C, nq, nq) fp32, lj (H, W) fp32, behind (H, W) bool, geo (26,) fp32,
// out (C, H, W) fp32, all contiguous on one device; warp 0 "matmul", 1
// "matmul_x"; op_dtype 0 fp32, 1 bf16.  Returns the launch's cudaError.
extern "C" int swr_warp(const float* img, const float* lj,
                        const unsigned char* behind, const float* geo,
                        float* out, int C, int nq, int H, int W, int axis,
                        int warp, int op_dtype, void* stream) {
  if (C <= 0 || nq <= 0 || H <= 0 || W <= 0 || axis < 0 || axis > 2 ||
      (warp != 0 && warp != 1) || (op_dtype != 0 && op_dtype != 1) ||
      (H + kBlockY - 1) / kBlockY > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  if (op_dtype == 1)
    swr_band_warp_kernel<true><<<grid, block, 0, st>>>(
        img, lj, behind, geo, out, C, nq, H, W, axis, warp == 1);
  else
    swr_band_warp_kernel<false><<<grid, block, 0, st>>>(
        img, lj, behind, geo, out, C, nq, H, W, axis, warp == 1);
  return (int)cudaGetLastError();
}
