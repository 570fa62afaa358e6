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
//        x[f] = sum_n Wc[j, n] (sum_m Wb[i, m] vol[c, s, f, m, n]),
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
// What bounded the first version (one thread per lattice point, every tap
// gathered with __ldg): the L1 load pipe.  Per point and slab it issued 4
// (linear) or 16 (cubic) scattered loads per channel, 128 at F = 8 cubic,
// and neighbouring points share most of them: at the uncapped serving
// lattice (nq = 816, R = 256) the step is ~0.3-0.9 voxels, so several
// lattice points read each source voxel.
//
// The design here (cubic) resamples separably and arranges that reuse.
//   * Tiles.  A block of 32 x 4 threads owns a tile of 4 lattice rows (i)
//     by 64 columns (j) of one chunk: warp w is row i0 + w, lane l holds
//     columns j0 + l and j0 + 32 + l.  Each thread loops over the chunk's
//     slabs with both points' carries in registers.  The capped serving
//     frame sweeps one chunk per launch at nq = 336: 6 x 84 = 504 blocks,
//     3.8 per SM of 132; nq = 816 is 1,326 blocks.
//   * Slab windows.  For each slab a warp computes, from (start, step), the
//     source columns that its tile's taps reach: lattice positions are
//     monotone in the lattice index (each rounding step is), so the extreme
//     taps are those of the tile's first and last live column, taken with
//     min / max so the sign of the step is not assumed, widened by one voxel
//     on each side and clamped to [0, Rc).  The window decides which
//     columns are resampled, never a weight.
//   * Pass 1, along b, into shared memory.  The warp resamples its lattice
//     row against every window column of every channel,
//     y[f, n] = sum_u Wb[i, m_u] vol[f, m_u, n] (4 taps), into a row buffer
//     of its own.  A lane loads its column's taps of all F channels before
//     it sums any; the loads are coalesced row segments, and the 4 warps of
//     a block read overlapping source rows, so the L1 serves the reuse.  At
//     64 columns a tile's window is wide enough (~30 columns at a step of
//     0.35) that the lanes are busy.  The b taps are the same for the whole
//     warp: four lanes compute one weight each and share them.
//   * Pass 2, along c, from shared memory: x[f] = sum_t y[f, n_t] Wc[j, n_t].
//     A row buffer is written and read by one warp only, so the kernel has
//     no block barrier (__syncwarp only).
//   * Exact arithmetic.  Pass 1 then pass 2 is the plain version's
//     association (Wb @ vol, then @ Wc^T) and the first version's exact
//     fp32 operations in the same order: the same tap positions (an
//     unfused multiply, then an add), the same `near` test, m0 and weights
//     (each c tap evaluates only its own branch of the polynomial, which
//     gives the same values; see taps()), weight 0 outside [0, n); so its
//     frames are bit-equal to the first version's.
//   * Empty tiles.  The serving lattice reaches far beyond the grid (its
//     start lies up to ~370 voxels before it).  A warp whose row's taps
//     reach no source row, or whose tile's columns reach no source column,
//     skips the slab: all its weights are 0, its sums +0, and a +0 sample
//     leaves T, tau and the sums as they are (for finite geometry, which
//     the warp checks once).
//   * Any step.  A slab whose window is wider than kRowCols columns (a
//     step above ~2.4 voxels; the capped serving frame's far chunks step
//     up to ~2.3) or whose positions are not finite is resampled tap by
//     tap from device memory, as the first version did.
//   * Linear resampling always takes that path, one point a thread on
//     8 x 32 tiles: its 2 x 2 taps are 4 loads per channel, which the two
//     passes do not undercut.
//
// Staging the windows with cp.async (a double-buffered copy of each slab's
// window into shared memory, one block barrier per 4 channels, both passes
// from shared memory) was built and measured first, and was slower than the
// first version: the copies, not the arithmetic, took its time (PERF.md
// has the numbers).  scripts/torch_sweep_fwd_ab.py times versions of this
// file side by side.
//
// What bounds it now.  Instruction issue and the shared-memory / L1 pipe:
// per lattice point, slab and channel 4 shared loads and 4 FMA in pass 2,
// and (window columns / 64) x (4 L1 loads + 4 FMA + 1 store) in pass 1,
// plus the c taps (4 kernel evaluations a point and slab).  The tensor-core
// form (the banded products as wgmma fed by TMA tiles) and bf16 operands
// are later work.  Operands are fp32 only.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
// A tile: kTileI lattice rows (one warp each) by kCols * 32 columns (lane l
// holds columns j0 + l, j0 + 32 + l, ...).  Cubic: 4 x 64, so that a
// warp's window row spans enough columns to keep its lanes busy in pass 1.
// Linear, tap by tap: 8 x 32, one point a thread.
template <int KIND>
struct Tile {
  static constexpr int kCols = KIND == 1 ? 2 : 1;
  static constexpr int kTileI = KIND == 1 ? 4 : 8;
  static constexpr int kTileJ = kCols * kWarp;
  static constexpr int kThreads = kWarp * kTileI;
};
// the widest window (source columns) a warp resamples in pass 1: a step up
// to ~2.4 voxels across a 64-column tile; a wider one takes the tap-by-tap
// path (a step of 3 needs 193 columns)
constexpr int kRowCols = 160;
constexpr unsigned kFullMask = 0xffffffffu;

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

// Taps of one lattice coordinate p on a source axis of length n: first
// source index m0 and the NT weights k(m0 + t - p).  Taps outside [0, n)
// get weight 0 (and a clamped, never-dereferenced-out-of-range index).
// Returns whether any tap lies in [0, n).
//
// Cubic: the branch of k is known per tap.  For m0 = floor(p) - 1,
// |m0 + 1 - p| and |m0 + 2 - p| are in [0, 1] and |m0 - p|, |m0 + 3 - p| in
// [1, 2] (rounding keeps them there: both ends are exact in fp32), and at
// |x| = 1 both polynomials are exactly 0, so evaluating only the tap's own
// branch gives kern()'s weights bit for bit.
template <int KIND, int NT>
__device__ __forceinline__ bool taps(float p, int n, int* idx, float* w) {
  // p far outside the source (or not finite): every tap is padding
  const bool near = p > -4.0f && p < (float)n + 4.0f;
  const int m0 = near ? (int)floorf(p) - (NT / 2 - 1) : -8;
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
    w[t] = in ? k : 0.0f;
    idx[t] = in ? m : 0;
  }
  return near && m0 + NT - 1 >= 0 && m0 < n;
}

// taps() for a p that is the same on every lane of the warp: lane t % NT
// evaluates weight t and the lanes share them; the same values as taps().
template <int KIND, int NT>
__device__ __forceinline__ bool warp_taps(float p, int n, int* idx,
                                          float* w) {
  const bool near = p > -4.0f && p < (float)n + 4.0f;
  const int m0 = near ? (int)floorf(p) - (NT / 2 - 1) : -8;
  const int mine = m0 + (int)(threadIdx.x % NT);
  const float wt = near && mine >= 0 && mine < n
                       ? kern<KIND>((float)mine - p)
                       : 0.0f;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int m = m0 + t;
    w[t] = __shfl_sync(kFullMask, wt, t);
    idx[t] = near && m >= 0 && m < n ? m : 0;
  }
  return near && m0 + NT - 1 >= 0 && m0 < n;
}

// The source indices [lo, lo + cnt) that the taps of lattice indices a0 and
// a1 (a tile's first and last live ones), and of every index between,
// reach on an axis of length n, with one voxel of margin on each side; cnt
// is 0 when they reach none.  False when a position is not finite.
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
// buffer yrow ([channel][kRowCols]).  The lanes walk the columns; each lane
// loads its column's taps of every channel before it sums any.
template <int F, int NT>
__device__ __forceinline__ void resample_row(const float* slab, size_t plane,
                                             int Rc, int c0, int ncol,
                                             const int* ib, const float* wb,
                                             float* yrow) {
  int row_off[NT];
#pragma unroll
  for (int u = 0; u < NT; ++u) row_off[u] = ib[u] * Rc;
  for (int n = threadIdx.x; n < ncol; n += kWarp) {
    const float* src = slab + c0 + n;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float col = 0.0f;
#pragma unroll
      for (int u = 0; u < NT; ++u)
        col += wb[u] * __ldg(src + f * plane + row_off[u]);
      yrow[f * kRowCols + n] = col;
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
// memory (the first version's arithmetic).
template <int F, int NT>
__device__ __forceinline__ void resample_taps(const float* slab, size_t plane,
                                              int Rc, const int* ib,
                                              const float* wb, const int* jc,
                                              const float* wc, float* x) {
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
}

template <int F, int KIND>
__global__ void __launch_bounds__(Tile<KIND>::kThreads)
swr_sweep_fwd_kernel(const float* __restrict__ vol,     // (nc, dc, F, Rb, Rc)
                     const float* __restrict__ rs_par,  // (nc, dc, 4)
                     const float* __restrict__ z_rel,   // (nc, dc)
                     const float* __restrict__ ch_par,  // (nc, 6)
                     float* __restrict__ out,           // (nc, F + 2, nq, nq)
                     int dc, int Rb, int Rc, int nq) {
  constexpr int NT = KIND == 0 ? 2 : 4;
  constexpr int kCols = Tile<KIND>::kCols, kTileJ = Tile<KIND>::kTileJ;
  extern __shared__ float smem[];  // one row buffer per warp (cubic)
  const int j0 = blockIdx.x * kTileJ;
  const int j1 = min(j0 + kTileJ, nq) - 1;
  const int i = blockIdx.y * Tile<KIND>::kTileI + threadIdx.y;
  const int c = blockIdx.z;
  // a warp below the lattice has nothing to do, nor (linear) a lane right
  // of it; for cubic those lanes take part in pass 1 and store nothing
  if (i >= nq || (KIND == 0 && j0 + (int)threadIdx.x >= nq)) return;
  float* yrow = smem + threadIdx.y * F * kRowCols;

  // per-chunk ray geometry at this thread's lattice points
  // (swr_pallas.py:_geom), and their carries
  const float* chp = ch_par + 6 * c;
  const float va = chp[4], h = chp[5];
  const float vb = __fadd_rn(chp[0], __fmul_rn(chp[1], (float)i));
  float dt[kCols], tb[kCols];
  float acc[kCols][F - 1], depth[kCols], T[kCols], tau[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int j = j0 + q * kWarp + threadIdx.x;
    const float vc = __fadd_rn(chp[2], __fmul_rn(chp[3], (float)j));
    const float norm = sqrtf(va * va + vb * vb + vc * vc);
    dt[q] = h * norm / fabsf(va);
    tb[q] = norm / va;
#pragma unroll
    for (int f = 0; f < F - 1; ++f) acc[q][f] = 0.0f;
    depth[q] = 0.0f;
    T[q] = 1.0f;
    tau[q] = 0.0f;
  }
  // cubic: whether every point of the warp has finite dt and tb (the
  // condition under which an empty slab can be skipped), the same on all
  // its lanes (linear lanes right of the lattice have returned)
  bool finite_geom = KIND == 1;
  if (KIND == 1) {
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      finite_geom = finite_geom && isfinite(dt[q]) && isfinite(tb[q]);
    finite_geom = __all_sync(kFullMask, finite_geom);
  }

  const size_t plane = (size_t)Rb * Rc;
  for (int s = 0; s < dc; ++s) {
    const size_t cs = (size_t)c * dc + s;
    const float* rs = rs_par + 4 * cs;
    const float* slab = vol + cs * F * plane;
    int ib[NT];
    float wb[NT];
    const float pb = lat_pos(rs[0], rs[1], i);
    const bool row_in = KIND == 1 ? warp_taps<KIND, NT>(pb, Rb, ib, wb)
                                  : taps<KIND, NT>(pb, Rb, ib, wb);
    int c0 = 0, ncol = 0;
    const bool rows = KIND == 1 &&
                      axis_window<NT>(rs[2], rs[3], j0, j1, Rc, &c0, &ncol) &&
                      ncol <= kRowCols;
    const float z = z_rel[cs];
    // cubic: no tap of the row (or of the tile's columns) reaches the
    // source, so every sum is +0 exactly, and a +0 sample leaves the carry
    // as it is when the geometry is finite: skip the slab
    if (KIND == 1 && finite_geom && isfinite(z) &&
        (!row_in || (rows && ncol == 0)))
      continue;
    if (rows) {
      resample_row<F, NT>(slab, plane, Rc, c0, ncol, ib, wb, yrow);
      __syncwarp();
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int j = j0 + q * kWarp + threadIdx.x;
      int jc[NT];
      float wc[NT], x[F];
      taps<KIND, NT>(lat_pos(rs[2], rs[3], j), Rc, jc, wc);
      if (rows)
        resample_col<F, NT>(yrow, c0, ncol, jc, wc, x);
      else
        resample_taps<F, NT>(slab, plane, Rc, ib, wb, jc, wc, x);

      const float sdt = fmaxf(x[0], 0.0f) * dt[q];
      const float one_m_a = expf(-sdt);
      const float w = (1.0f - one_m_a) * T[q];
#pragma unroll
      for (int f = 1; f < F; ++f) acc[q][f - 1] += w * x[f];
      depth[q] += w * (z * tb[q]);
      T[q] *= one_m_a;
      tau[q] += sdt;
    }
    if (rows) __syncwarp();  // the next slab's pass 1 overwrites yrow
  }

  const size_t npix = (size_t)nq * nq;
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int j = j0 + q * kWarp + threadIdx.x;
    if (j >= nq) continue;
    float* o = out + (size_t)c * (F + 2) * npix + (size_t)i * nq + j;
#pragma unroll
    for (int f = 0; f < F - 1; ++f) o[f * npix] = acc[q][f];
    o[(F - 1) * npix] = depth[q];
    o[F * npix] = 1.0f - T[q];
    o[(F + 1) * npix] = tau[q];
  }
}

template <int F, int KIND>
cudaError_t launch(const float* vol, const float* rs_par, const float* z_rel,
                   const float* ch_par, float* out, int n_chunks, int dc,
                   int Rb, int Rc, int nq, cudaStream_t stream) {
  using Tl = Tile<KIND>;
  // the row buffers (cubic only): 20 KB at F = 8, 40 KB at F = 16, within
  // the 48 KB a kernel gets without opting in to more
  constexpr size_t smem =
      KIND == 1 ? sizeof(float) * Tl::kTileI * F * kRowCols : 0;
  static_assert(smem <= 48 * 1024, "row buffers above 48 KB need "
                "cudaFuncAttributeMaxDynamicSharedMemorySize");
  dim3 block(kWarp, Tl::kTileI);
  dim3 grid((nq + Tl::kTileJ - 1) / Tl::kTileJ,
            (nq + Tl::kTileI - 1) / Tl::kTileI, n_chunks);
  swr_sweep_fwd_kernel<F, KIND><<<grid, block, smem, stream>>>(
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
// than 4, 8, 16, an unknown kind or more than 65535 chunks returns
// cudaErrorInvalidValue.
extern "C" int swr_sweep_fwd(const float* vol, const float* rs_par,
                             const float* z_rel, const float* ch_par,
                             float* out, int n_chunks, int dc, int F, int Rb,
                             int Rc, int nq, int kind, void* stream) {
  if (n_chunks <= 0 || n_chunks > 65535 || dc <= 0 || Rb <= 0 || Rc <= 0 ||
      nq <= 0)
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
