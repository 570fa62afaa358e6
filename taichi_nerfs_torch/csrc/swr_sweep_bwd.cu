// Shear-warp chunk sweep, backward — hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ops/swr_pallas.py:_bwd_kernel of the JAX
// package (launched by _bwd_call from _sweep_bwd, the VJP of its
// chunk_sweep).  The plain PyTorch version of the same function is autograd
// through taichi_nerfs_torch/ops/swr_sweep.py:chunk_sweep_reference
// (chunk_sweep_bwd_reference there); the forward is csrc/swr_sweep_fwd.cu,
// and both take their resample helpers from csrc/swr_sweep_common.cuh.
//
// What it computes: dvol = d<g, frames>/d vol for the frames of the forward
// sweep, given the upstream cotangent g (n_chunks, F + 2, nq, nq) on all
// channels [acc (F - 1) | depth | opacity | tau].  One reverse sweep per
// lattice point (c, i, j) over the chunk's slabs, with no stored
// activations, as the TPU kernel does.  Per slab s = dc - 1 ... 0 it
// resamples the slab onto the point as the forward does (same taps, same
// rounding), then
//   sigma = max(x[0], 0), sdt = sigma dt, a = 1 - exp(-sdt),
//   tau_k = tau - sdt  (tau starts at the forward's tau_N, frames[F+1]: the
//                       transmittance is rebuilt in log space from the
//                       CLAMPED sigmas, as the forward summed them),
//   T_k = exp(-tau_k), w = a T_k,
//   phi = t_ray g_depth + g_opacity + sum_f x[f] g[f - 1],
//   d a = T_k (phi - U)           (U: the normalised downstream suffix),
//   d sigma = d a (1 - a) dt + g_tau dt,
//   dx2[0] = x[0] > 0 ? d sigma : 0,  dx2[f] = w g[f - 1] (f >= 1),
//   U = (1 - a) U + a phi,  tau = tau_k,
// and resamples dx2 back onto the slab, the transpose of the forward's
// resample:
//   dvol[c, s, f, m, n] = sum_i sum_j Wb[i, m] Wc[j, n] dx2[c, s, f, i, j].
//
// The design (fp32 volume and operands; the bf16 variants below): one
// kernel after a memset of dvol, no scratch; dx2 never leaves the chip.
//   * Tiles.  A block of 4 warps owns 4 lattice rows (one a warp) by 64
//     columns (two a lane) of one chunk and loops over its slabs in reverse
//     with each point's carries in registers (tau, U, dt, tb) and its F + 2
//     cotangents in shared memory.
//   * The forward resample, as csrc/swr_sweep_fwd.cu does it: pass 1 along
//     b reads the slab window of the warp's row through the L1 into a row
//     buffer of its own in shared memory; pass 2 along c sums each point's
//     taps from it.  Linear resamples the same way (2 taps).
//   * Pass 2 transposed, along c, per warp: the row's dx2 goes to shared
//     memory beside each column's first tap and weights, then each lane
//     owns source columns n of the window and gathers
//       y[f, n] = sum_j Wc[j, n] dx2[f, j]
//     over the few lattice columns j whose taps reach n (a range computed
//     from the position, widened, each j tested against its stored first
//     tap, so the weights are the forward's), in a fixed order.  y
//     overwrites the warp's row buffer.
//   * Pass 1 transposed, along b, per block, after a block barrier: each
//     source row r that a warp's taps reach gets, per channel and window
//     column, sum_w Wb[i_w, r] y_w[f, n] over the block's warps in order,
//     added into dvol with 16-byte atomics (the window widened to whole
//     float4s; one float at a time when Rc is no multiple of 4).
//   * The reduction across tiles is those atomics: a source voxel gets
//     terms from every tile whose taps reach it (the cubic support adds ~3
//     rows and columns at each tile edge, ~1.7 adds a voxel at the training
//     shape).  So dvol is not bit-identical from run to run: the tiles'
//     sums are added in the order the blocks reach them (differences at
//     the last bits, 1e-7 relative).  A deterministic order was built and
//     measured: four launches, one per tile colour (row parity x column
//     parity), so that no two tiles of one launch reach a voxel; its
//     fastest build took 47 % longer than this kernel (PERF.md, section
//     6), above the 20 % that determinism was allowed to cost.
//   * Any step.  A slab whose column window is wider than kRowCols or not
//     finite is resampled tap by tap from device memory and its dx2
//     scattered to its 4 or 16 taps with atomics, point by point.
//   * Empty tiles.  With finite geometry and z, a warp whose row, or a tile
//     whose columns, reach no source voxel skips the slab: x = 0 gives
//     dx2 = 0, tau_k = tau and U unchanged.
//   * Exact arithmetic.  The same tap positions (an unfused multiply, then
//     an add), `near` test and weights as the forward; only the order of
//     the fp32 additions differs from the plain version's dense transposed
//     matmuls.
//
// What bounds it (NVIDIA H100, PERF.md section 6): at the R=256 training
// shape about half the time is the forward resample and the reverse
// composite (instruction issue and the L1 / shared-memory pipe, as in the
// forward), a quarter the transposed resample in shared memory, and a
// quarter dvol's memset and atomics (537 MB, each line read back from
// device memory by the atomics).  The bound counts dvol written once.
//
// bf16.  The forward's two template axes (csrc/swr_sweep_fwd.cu): the
// volume's type T and the operand flag OPB.  With OPB the recomputed
// forward rounds as the forward does, and the backward rounds what the
// Pallas _bwd_kernel casts to its dtype: each dx2 value before pass 2
// transposed reads it, and each value of the transposed pass 2 (the
// Pallas kernel's t = dx2 @ Wc^T, summed over the whole lattice row)
// before pass 1 transposed reads it.  dvol comes back in the volume's
// type, each voxel's fp32 sum rounded once (bf16 atomics would round at
// every add).  Both ask for a sum to be complete before it is rounded,
// and a tile holds 64 lattice columns of a row (a source column near a
// tile's edge gets terms from two tiles) and 4 lattice rows.  So with a
// bf16 volume or OPB (TB below) the work is split in two kernels: the
// sweep kernel adds its unrounded t (the tap-by-tap path each point's
// terms) into an fp32 buffer t (n_chunks, dc, F, nq, Rc) with atomics, and
// swr_sweep_bwd_rows_kernel rounds each t once (OPB) and runs pass 1
// transposed, each voxel of dvol a sum over the lattice rows whose taps
// reach it, stored once in the volume's type (no memset, no atomics).

#include "swr_sweep_common.cuh"

namespace {

// A tile: kTileI lattice rows (one warp each) by 64 columns (two a lane).
// Measured on the H100 against 2, 8 and 16 rows: 4-row blocks, 5 of them
// an SM (96 registers), were the fastest at the training shapes.
constexpr int kTileI = 4;
constexpr int kCols = 2;
constexpr int kTileJ = kCols * kWarp;
constexpr int kThreads = kWarp * kTileI;
// blocks an SM: 5 (F = 4, 8); at F = 16 shared memory allows 2
template <int F>
struct MinBlocks {
  static constexpr int value = F == 16 ? 2 : 5;
};
// the first tap of a point or row that adds nothing
constexpr int kNone = -(1 << 20);

// shared memory of one block, in 4-byte words
template <int F, int NT>
struct Smem {
  static constexpr int kY = kTileI * F * kRowCols;  // row buffers, then y
  static constexpr int kDx = kTileI * F * kTileJ;   // dx2 of each warp's row
  static constexpr int kCw = kTileI * NT * kTileJ;  // c weights per column
  static constexpr int kCm = kTileI * kTileJ;       // c first tap per column
  static constexpr int kRw = kTileI * NT;           // b weights per warp
  static constexpr int kRm = kTileI;                // b first tap per warp
  static constexpr int kG = kTileI * (F + 2) * kTileJ;  // cotangents g
  static constexpr size_t kBytes =
      sizeof(float) * (kY + kDx + kCw + kCm + kRw + kRm + kG);
};

// The first and last lattice columns of [j0, j1] whose taps can reach
// source column n: positions in [n - NT/2, n + NT/2), from the position
// rule widened by two columns (the test against each column's first tap
// decides); the whole tile when the step is small or not finite.
template <int NT>
__device__ __forceinline__ void reaching_cols(float start, float step,
                                              float inv_step, int n, int j0,
                                              int j1, int* lo, int* hi) {
  constexpr float kS = (float)(NT / 2);
  const float a = ((float)n - kS - start) * inv_step;
  const float b = ((float)n + kS - start) * inv_step;
  float l = fminf(a, b), h = fmaxf(a, b);
  if (!(isfinite(l) && isfinite(h)) || fabsf(step) < 0.0625f) {
    *lo = j0;
    *hi = j1;
    return;
  }
  l = fminf(fmaxf(l, (float)j0 - 4.0f), (float)j1 + 4.0f);
  h = fminf(fmaxf(h, (float)j0 - 4.0f), (float)j1 + 4.0f);
  *lo = max(j0, (int)floorf(l) - 2);
  *hi = min(j1, (int)ceilf(h) + 2);
}

template <int F, int KIND, typename VT, bool OPB>
__global__ void __launch_bounds__(kThreads, MinBlocks<F>::value)
swr_sweep_bwd_kernel(const VT* __restrict__ vol,        // (nc, dc, F, Rb, Rc)
                     const float* __restrict__ rs_par,  // (nc, dc, 4)
                     const float* __restrict__ z_rel,   // (nc, dc)
                     const float* __restrict__ ch_par,  // (nc, 6)
                     const float* __restrict__ frames,  // (nc, F + 2, nq, nq)
                     const float* __restrict__ g,       // (nc, F + 2, nq, nq)
                     // dvol (nc, dc, F, Rb, Rc), or with TB the sums t
                     // (nc, dc, F, nq, Rc); zeroed
                     float* __restrict__ out,
                     int dc, int Rb, int Rc, int nq, bool vec8) {
  constexpr int NT = KIND == 0 ? 2 : 4;
  // t goes to the buffer and pass 1 transposed to the second kernel
  constexpr bool TB = OPB || sizeof(VT) == 2;
  using S = Smem<F, NT>;
  extern __shared__ __align__(16) float smem[];
  float* ybuf = smem;
  float* dxs = ybuf + S::kY;
  float* cw = dxs + S::kDx;
  int* cm = reinterpret_cast<int*>(cw + S::kCw);
  float* rw = reinterpret_cast<float*>(cm + S::kCm);
  int* rm = reinterpret_cast<int*>(rw + S::kRw);
  float* gs = reinterpret_cast<float*>(rm + S::kRm);

  const int w = threadIdx.y, lane = threadIdx.x;
  const int j0 = blockIdx.x * kTileJ;
  const int j1 = min(j0 + kTileJ, nq) - 1;
  const int i = blockIdx.y * kTileI + w;
  const int c = blockIdx.z;
  const bool live_row = i < nq;
  // dvol's rows hold whole float4s: the window is widened to them and the
  // sums are added 16 bytes at a time
  const bool vec = Rc % 4 == 0;
  float* yrow = ybuf + w * F * kRowCols;
  float* wdx = dxs + w * F * kTileJ;
  float* wcw = cw + w * NT * kTileJ;
  int* wcm = cm + w * kTileJ;
  // the cotangents g[f] (f < F - 1) of the warp's points: wgs[f * 64 + jj]
  float* wgs = gs + w * (F + 2) * kTileJ;

  // per-chunk ray geometry at this thread's lattice points
  // (swr_pallas.py:_geom), the cotangents and the carries
  const float* chp = ch_par + 6 * c;
  const float va = chp[4], h = chp[5];
  const float vb = __fadd_rn(chp[0], __fmul_rn(chp[1], (float)i));
  const size_t npix = (size_t)nq * nq;
  float dt[kCols], tb[kCols], tau[kCols], U[kCols];
  float g_dep[kCols], g_op[kCols], g_tau[kCols];
  bool live[kCols];
  bool finite_geom = true;
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int j = j0 + q * kWarp + lane;
    live[q] = live_row && j < nq;
    const float vc = __fadd_rn(chp[2], __fmul_rn(chp[3], (float)j));
    const float norm = sqrtf(va * va + vb * vb + vc * vc);
    dt[q] = h * norm / fabsf(va);
    tb[q] = norm / va;
    finite_geom = finite_geom && isfinite(dt[q]) && isfinite(tb[q]);
    const size_t pix = live[q] ? (size_t)i * nq + j : 0;
    const float* gp = g + (size_t)c * (F + 2) * npix + pix;
#pragma unroll
    for (int f = 0; f < F - 1; ++f)
      wgs[f * kTileJ + q * kWarp + lane] = live[q] ? gp[f * npix] : 0.0f;
    g_dep[q] = live[q] ? gp[(F - 1) * npix] : 0.0f;
    g_op[q] = live[q] ? gp[F * npix] : 0.0f;
    g_tau[q] = live[q] ? gp[(F + 1) * npix] : 0.0f;
    tau[q] = live[q]
                 ? frames[(size_t)c * (F + 2) * npix + (F + 1) * npix + pix]
                 : 0.0f;
    U[q] = 0.0f;
  }
  finite_geom = __all_sync(kFullMask, finite_geom);

  const size_t plane = (size_t)Rb * Rc;
  // with TB: the warp's lattice row of t, channel f at f * tplane
  const size_t tplane = (size_t)nq * Rc;
  for (int s = dc - 1; s >= 0; --s) {
    const size_t cs = (size_t)c * dc + s;
    const float* rs = rs_par + 4 * cs;
    const VT* slab = vol + cs * F * plane;
    float* dslab = out + cs * F * plane;
    float* trow = out + cs * F * tplane + (size_t)(live_row ? i : 0) * Rc;
    int ib[NT];
    float wb[NT];
    const float pb = lat_pos(rs[0], rs[1], i);
    const bool row_in = warp_taps<KIND, NT, OPB>(pb, Rb, ib, wb) && live_row;
    // block-uniform: the tile's column window (widened to whole float4s of
    // dvol's rows when Rc allows), and whether it fits
    int c0 = 0, ncol = 0;
    const bool finite_win =
        axis_window<NT>(rs[2], rs[3], j0, j1, Rc, &c0, &ncol);
    if (vec && ncol > 0) {
      const int end = min((c0 + ncol + 3) & ~3, Rc);
      c0 &= ~3;
      ncol = end - c0;
    }
    const bool rows = finite_win && ncol <= kRowCols;
    const float z = z_rel[cs];
    // no tap of the row (or of the tile's columns) reaches the source: x = 0
    // gives dx2 = 0 and leaves tau and U as they are (finite geometry)
    const bool skip = !live_row || (finite_geom && isfinite(z) &&
                                    (!row_in || (rows && ncol == 0)));
    if (lane == 0) rm[w] = kNone;
    if (!skip) {
      if (rows) {
        resample_row<F, NT, OPB>(slab, plane, Rc, c0, ncol, ib, wb, yrow,
                                 vec8);
        __syncwarp();
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int jj = q * kWarp + lane;
        const float pc = lat_pos(rs[2], rs[3], j0 + jj);
        int jc[NT];
        float wc[NT], x[F];
        taps<KIND, NT, OPB>(pc, Rc, jc, wc);
        if (rows && ncol == 0) {  // (non-finite geometry or z)
#pragma unroll
          for (int f = 0; f < F; ++f) x[f] = 0.0f;
        } else if (rows)
          resample_col<F, NT>(yrow, c0, ncol, jc, wc, x);
        else
          resample_taps<F, NT, OPB>(slab, plane, Rc, ib, wb, jc, wc, x);

        const float sdt = fmaxf(x[0], 0.0f) * dt[q];
        const float one_m_a = expf(-sdt);
        const float a = 1.0f - one_m_a;
        const float tau_k = tau[q] - sdt;
        const float t_k = expf(-tau_k);
        const float wgt = a * t_k;
        float phi = z * tb[q] * g_dep[q] + g_op[q];
#pragma unroll
        for (int f = 1; f < F; ++f) phi += x[f] * wgs[(f - 1) * kTileJ + jj];
        const float da = t_k * (phi - U[q]);
        const float dsigma = da * one_m_a * dt[q] + g_tau[q] * dt[q];
        // dx2, rounded to the operand dtype
        float d[F];
        d[0] = op_round<OPB>(x[0] > 0.0f ? dsigma : 0.0f);
#pragma unroll
        for (int f = 1; f < F; ++f)
          d[f] = op_round<OPB>(wgt * wgs[(f - 1) * kTileJ + jj]);
        tau[q] = tau_k;
        U[q] = one_m_a * U[q] + a * phi;

        if (rows) {
#pragma unroll
          for (int f = 0; f < F; ++f) wdx[f * kTileJ + jj] = live[q] ? d[f] : 0.0f;
#pragma unroll
          for (int tc = 0; tc < NT; ++tc) wcw[tc * kTileJ + jj] = wc[tc];
          wcm[jj] = live[q] ? first_tap<NT>(pc, Rc) : kNone;
        } else if (TB && live[q] && row_in) {
          // tap path: add this point's terms of t at its c taps
#pragma unroll
          for (int tc = 0; tc < NT; ++tc) {
            if (wc[tc] == 0.0f) continue;
#pragma unroll
            for (int f = 0; f < F; ++f)
              atomicAdd(trow + f * tplane + jc[tc], wc[tc] * d[f]);
          }
        } else if (!TB && live[q]) {
          // tap path: scatter this point's dx2 to its taps
#pragma unroll
          for (int ub = 0; ub < NT; ++ub) {
#pragma unroll
            for (int tc = 0; tc < NT; ++tc) {
              const float wt = wb[ub] * wc[tc];
              if (wt == 0.0f) continue;
              float* o = dslab + (size_t)ib[ub] * Rc + jc[tc];
#pragma unroll
              for (int f = 0; f < F; ++f) atomicAdd(o + f * plane, wt * d[f]);
            }
          }
        }
      }
      if (rows) {
        __syncwarp();  // yrow read, dx2 and the c taps written
        // pass 2 transposed: y[f, n] = sum_j Wc[j, n] dx2[f, j] into yrow,
        // or with TB added into t (a row that reaches no source row adds
        // nothing: its b weights are 0)
        const float inv_step = 1.0f / rs[3];
        for (int nn = lane; nn < ncol; nn += kWarp) {
          const int n = c0 + nn;
          int jlo, jhi;
          reaching_cols<NT>(rs[2], rs[3], inv_step, n, j0, j1, &jlo, &jhi);
          float acc[F];
#pragma unroll
          for (int f = 0; f < F; ++f) acc[f] = 0.0f;
          for (int j = jlo; j <= jhi; ++j) {
            const int jj = j - j0;
            const int k = n - wcm[jj];
            if (k < 0 || k >= NT) continue;
            const float wt = wcw[k * kTileJ + jj];
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] += wt * wdx[f * kTileJ + jj];
          }
          if constexpr (TB) {
            if (row_in) {
#pragma unroll
              for (int f = 0; f < F; ++f)
                if (acc[f] != 0.0f) atomicAdd(trow + f * tplane + n, acc[f]);
            }
          } else {
#pragma unroll
            for (int f = 0; f < F; ++f) yrow[f * kRowCols + nn] = acc[f];
          }
        }
        if (!TB && lane == 0 && row_in) {
          rm[w] = first_tap<NT>(pb, Rb);
#pragma unroll
          for (int ub = 0; ub < NT; ++ub) rw[w * NT + ub] = wb[ub];
        }
      }
    }
    __syncthreads();  // every warp's y and b taps in shared memory

    // pass 1 transposed: the source rows the block's warps reach (with TB
    // in swr_sweep_bwd_rows_kernel, once t is complete)
    if (!TB && rows && ncol > 0) {
      int rlo = Rb, rhi = -1;
#pragma unroll
      for (int v = 0; v < kTileI; ++v) {
        if (rm[v] == kNone) continue;
        rlo = min(rlo, max(rm[v], 0));
        rhi = max(rhi, min(rm[v] + NT - 1, Rb - 1));
      }
      for (int r = rlo + w; r <= rhi; r += kTileI) {
        float wr[kTileI];
        unsigned hit = 0;
#pragma unroll
        for (int v = 0; v < kTileI; ++v) {
          const int k = r - rm[v];
          const bool in = k >= 0 && k < NT;
          wr[v] = in ? rw[v * NT + min(max(k, 0), NT - 1)] : 0.0f;
          hit |= in ? 1u << v : 0u;
        }
        if (!hit) continue;
        float* orow = dslab + (size_t)r * Rc + c0;
        if (vec) {
          // lane k takes (channel, 4 columns) pairs k, k + 32, ...: one
          // 16-byte add each, the window's columns consecutive per channel
          const int n4 = ncol / 4;
          for (int e = lane; e < F * n4; e += kWarp) {
            const int f = e / n4, q = 4 * (e - f * n4);
            float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
            for (int v = 0; v < kTileI; ++v) {
              if (!(hit & (1u << v))) continue;
              const float4 y = *reinterpret_cast<const float4*>(
                  ybuf + (v * F + f) * kRowCols + q);
              acc.x += wr[v] * y.x;
              acc.y += wr[v] * y.y;
              acc.z += wr[v] * y.z;
              acc.w += wr[v] * y.w;
            }
            atomicAdd(reinterpret_cast<float4*>(orow + f * plane + q), acc);
          }
        } else {
          for (int nn = lane; nn < ncol; nn += kWarp) {
#pragma unroll
            for (int f = 0; f < F; ++f) {
              float acc = 0.0f;
#pragma unroll
              for (int v = 0; v < kTileI; ++v)
                if (hit & (1u << v))
                  acc += wr[v] * ybuf[(v * F + f) * kRowCols + nn];
              atomicAdd(orow + f * plane + nn, acc);
            }
          }
        }
      }
    }
    __syncthreads();  // the next slab overwrites the shared buffers
  }
}

// Pass 1 transposed of the backward with a bf16 volume or bf16 operands,
// after every tile has added its t: dvol[z, r, n] = sum_i Wb[i, r]
// t[z, i, n] for each plane z = (chunk, slab, channel), over the lattice
// rows i whose b taps reach source row r (the weights the forward's taps()
// gives), in increasing i, stored once in dvol's type VT; with OPB the
// weights and each t are rounded to bf16.  A block owns
// kRowsT source rows by 256 columns (a thread a column) of one plane: its
// threads make the first tap and weights of each lattice row that reaches
// them once into shared memory, then each thread reads each such row's t
// at its column once and adds it, times each weight, to the rows it
// reaches, in accumulators of its own in shared memory.  A weight of 0
// adds nothing.
constexpr int kRowsThreads = 256;
constexpr int kRowsT = 32;

template <int KIND, typename VT, bool OPB>
__global__ void __launch_bounds__(kRowsThreads)
swr_sweep_bwd_rows_kernel(const float* __restrict__ t,       // (nz, nq, Rc)
                          const float* __restrict__ rs_par,  // (nc, dc, 4)
                          VT* __restrict__ dvol,             // (nz, Rb, Rc)
                          int nz, int F, int Rb, int Rc, int nq) {
  constexpr int NT = KIND == 0 ? 2 : 4;
  __shared__ float acc[kRowsT * kRowsThreads];  // [row][column]
  __shared__ float ws[kRowsThreads * NT];       // weights of lattice rows
  __shared__ int fs[kRowsThreads];              // and their first taps
  const int tid = threadIdx.x;
  const int n = blockIdx.x * kRowsThreads + tid;
  const bool live = n < Rc;
  for (int z = blockIdx.z; z < nz; z += gridDim.z) {
    const float* rs = rs_par + 4 * (z / F);
    const float* tz = t + (size_t)z * nq * Rc + (live ? n : 0);
    const float inv_step = 1.0f / rs[1];
    for (int r0 = blockIdx.y * kRowsT; r0 < Rb; r0 += gridDim.y * kRowsT) {
      const int nr = min(kRowsT, Rb - r0);
      // the lattice rows whose taps can reach rows r0 ... r0 + nr - 1
      int lo0, hi0, lo1, hi1;
      reaching_cols<NT>(rs[0], rs[1], inv_step, r0, 0, nq - 1, &lo0, &hi0);
      reaching_cols<NT>(rs[0], rs[1], inv_step, r0 + nr - 1, 0, nq - 1,
                        &lo1, &hi1);
      const int ilo = min(lo0, lo1), ihi = max(hi0, hi1);
      for (int k = 0; k < nr; ++k) acc[k * kRowsThreads + tid] = 0.0f;
      for (int i0 = ilo; i0 <= ihi; i0 += kRowsThreads) {
        const int cnt = min(kRowsThreads, ihi - i0 + 1);
        __syncthreads();  // the last chunk's weights read
        if (tid < cnt) {
          const float pb = lat_pos(rs[0], rs[1], i0 + tid);
          int ib[NT];
          float wb[NT];
          taps<KIND, NT, OPB>(pb, Rb, ib, wb);
          fs[tid] = first_tap<NT>(pb, Rb);
#pragma unroll
          for (int u = 0; u < NT; ++u) ws[tid * NT + u] = wb[u];
        }
        __syncthreads();
        if (!live) continue;
#pragma unroll 4
        for (int q = 0; q < cnt; ++q) {
          // every row in range is read, so the loads need not wait on a branch
          const float tv = op_round<OPB>(tz[(size_t)(i0 + q) * Rc]);
          const int m0 = fs[q] - r0;
#pragma unroll
          for (int u = 0; u < NT; ++u) {
            const float w = ws[q * NT + u];
            if (m0 + u >= 0 && m0 + u < nr && w != 0.0f)
              acc[(m0 + u) * kRowsThreads + tid] += w * tv;
          }
        }
      }
      if (live) {
        VT* o = dvol + ((size_t)z * Rb + r0) * Rc + n;
        for (int k = 0; k < nr; ++k) {
          const float v = acc[k * kRowsThreads + tid];
          if constexpr (sizeof(VT) == 2)
            o[(size_t)k * Rc] = __float2bfloat16_rn(v);
          else
            o[(size_t)k * Rc] = v;
        }
      }
    }
  }
}

template <int F, int KIND, typename VT, bool OPB>
cudaError_t launch(const void* vol, const float* rs_par, const float* z_rel,
                   const float* ch_par, const float* frames, const float* g,
                   void* dvol, float* scratch, int n_chunks, int dc, int Rb,
                   int Rc, int nq, cudaStream_t stream) {
  constexpr size_t smem = Smem<F, KIND == 0 ? 2 : 4>::kBytes;
  static_assert(smem <= 227 * 1024, "shared memory above the SM's 227 KB");
  auto kernel = swr_sweep_bwd_kernel<F, KIND, VT, OPB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // the tiles add into dvol itself (fp32 volume and operands), or t into
  // the fp32 scratch
  constexpr bool TB = OPB || sizeof(VT) == 2;
  float* acc = TB ? scratch : static_cast<float*>(dvol);
  const size_t n_acc = (size_t)n_chunks * dc * F * (TB ? nq : Rb) * Rc;
  err = cudaMemsetAsync(acc, 0, sizeof(float) * n_acc, stream);
  if (err != cudaSuccess) return err;
  const bool vec8 = sizeof(VT) == 2 && Rc % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(vol) % 16 == 0;
  dim3 block(kWarp, kTileI);
  dim3 grid((nq + kTileJ - 1) / kTileJ, (nq + kTileI - 1) / kTileI, n_chunks);
  kernel<<<grid, block, smem, stream>>>(static_cast<const VT*>(vol), rs_par,
                                        z_rel, ch_par, frames, g, acc, dc, Rb,
                                        Rc, nq, vec8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (TB) {
    const int nz = n_chunks * dc * F;
    const int row_blocks = (Rb + kRowsT - 1) / kRowsT;
    dim3 rgrid((Rc + kRowsThreads - 1) / kRowsThreads,
               row_blocks < 65535 ? row_blocks : 65535,
               nz < 65535 ? nz : 65535);
    swr_sweep_bwd_rows_kernel<KIND, VT, OPB>
        <<<rgrid, kRowsThreads, 0, stream>>>(
            acc, rs_par, static_cast<VT*>(dvol), nz, F, Rb, Rc, nq);
    return cudaGetLastError();
  }
  return err;
}

// dtype codes: 0 float32, 1 bfloat16
template <int F, int KIND>
cudaError_t dispatch_types(int vol_dtype, int op_dtype, const void* vol,
                           const float* rs_par, const float* z_rel,
                           const float* ch_par, const float* frames,
                           const float* g, void* dvol, float* scratch,
                           int n_chunks, int dc, int Rb, int Rc, int nq,
                           cudaStream_t stream) {
#define SWR_BWD_LAUNCH(T, OPB)                                               \
  return launch<F, KIND, T, OPB>(vol, rs_par, z_rel, ch_par, frames, g, dvol, \
                                 scratch, n_chunks, dc, Rb, Rc, nq, stream)
  if (vol_dtype == 0 && op_dtype == 0) SWR_BWD_LAUNCH(float, false);
  if (scratch == nullptr) return cudaErrorInvalidValue;
  if (vol_dtype == 0 && op_dtype == 1) SWR_BWD_LAUNCH(float, true);
  if (vol_dtype == 1 && op_dtype == 0) SWR_BWD_LAUNCH(__nv_bfloat16, false);
  if (vol_dtype == 1 && op_dtype == 1) SWR_BWD_LAUNCH(__nv_bfloat16, true);
#undef SWR_BWD_LAUNCH
  return cudaErrorInvalidValue;
}

template <int KIND>
cudaError_t dispatch_f(int F, int vol_dtype, int op_dtype, const void* vol,
                       const float* rs_par, const float* z_rel,
                       const float* ch_par, const float* frames,
                       const float* g, void* dvol, float* scratch,
                       int n_chunks, int dc, int Rb, int Rc, int nq,
                       cudaStream_t stream) {
  switch (F) {
    case 4:
      return dispatch_types<4, KIND>(vol_dtype, op_dtype, vol, rs_par, z_rel,
                                     ch_par, frames, g, dvol, scratch,
                                     n_chunks, dc, Rb, Rc, nq, stream);
    case 8:
      return dispatch_types<8, KIND>(vol_dtype, op_dtype, vol, rs_par, z_rel,
                                     ch_par, frames, g, dvol, scratch,
                                     n_chunks, dc, Rb, Rc, nq, stream);
    case 16:
      return dispatch_types<16, KIND>(vol_dtype, op_dtype, vol, rs_par,
                                      z_rel, ch_par, frames, g, dvol, scratch,
                                      n_chunks, dc, Rb, Rc, nq, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  kind: 0 linear, 1 cubic;
// vol_dtype (vol's and dvol's element type) and op_dtype (the resample
// operands'): 0 float32, 1 bfloat16.  dvol is written whole.  scratch is an
// fp32 buffer (n_chunks, dc, F, nq, Rc) for t: unused (may be null) with
// an fp32 volume and fp32 operands.
// Returns cudaGetLastError() after the launches (0 on success); an F other
// than 4, 8, 16, an unknown kind or dtype code, a missing scratch, more
// than 65535 chunks or a lattice of more than 65535 tile rows returns
// cudaErrorInvalidValue.
extern "C" int swr_sweep_bwd(const void* vol, const float* rs_par,
                             const float* z_rel, const float* ch_par,
                             const float* frames, const float* g, void* dvol,
                             float* scratch, int n_chunks, int dc, int F,
                             int Rb, int Rc, int nq, int kind, int vol_dtype,
                             int op_dtype, void* stream) {
  if (n_chunks <= 0 || n_chunks > 65535 || dc <= 0 || Rb <= 0 || Rc <= 0 ||
      nq <= 0 || (nq + kTileI - 1) / kTileI > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return (int)dispatch_f<0>(F, vol_dtype, op_dtype, vol, rs_par, z_rel,
                              ch_par, frames, g, dvol, scratch, n_chunks, dc,
                              Rb, Rc, nq, st);
  if (kind == 1)
    return (int)dispatch_f<1>(F, vol_dtype, op_dtype, vol, rs_par, z_rel,
                              ch_par, frames, g, dvol, scratch, n_chunks, dc,
                              Rb, Rc, nq, st);
  return (int)cudaErrorInvalidValue;
}
