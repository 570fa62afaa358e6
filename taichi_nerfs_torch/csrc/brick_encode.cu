// Brick-grid encoder (the NGP path's position encoding) — hand-written CUDA
// for Hopper (sm_90a): one gather kernel (forward) and one scatter kernel
// (the table gradient).
//
// Replaces no TPU kernel.  The JAX package's brick encoder (its
// ops/brick_encoder.py) is XLA gathers and scatter-adds, with no Pallas
// kernel.  The plain PyTorch version of the same function, which the port
// runs on the CPU, is taichi_nerfs_torch/ops/brick_encoder.py:
// brick_encode_reference; these kernels serve every CUDA call of
// ops/brick_encoder.py:brick_encode (the training step's field and
// backward, the occupancy refresh, the test renderer).
//
// What it computes.  For each position x in [0, 1]^3 (M, 3) and level l:
// pos = x * scale_l + 0.5, the cell g = floor(pos), the in-cell fraction
// pos - g and its 8 trilinear weights w[c] = (wz * wy) * wx, corner
// c = cx + 2 cy + 4 cz; the level's F features are sum_c w[c] * e[c], where
// e[c] is the corner's F-vector:
//   a dense level (res^3 <= the rows a hashed level has) keeps a shared-
//     corner grid (res + 1)^3 x F, z slowest: e[c] = corners[g + (cx, cy,
//     cz)];
//   a hashed level keeps brick rows of 8F (a cell's whole 2x2x2xF block,
//     corner-major): e[c] = bricks[fast_hash(g) % rows][c F : (c + 1) F].
// The backward adds w[c] * dout into the same entries of an fp32 table
// gradient.  With a bf16 table each value read is rounded to bf16 and
// widened again (the plain version casts the table, then gathers); the
// gradient stays fp32.
//
// What bounds it on this card: bytes, and their scatter.  The operations
// are 8 multiply-adds per feature and level; the data is random 128-byte
// rows (8F fp32 at F = 4) of a 100 MB table and, in the backward, 16-byte
// vector reductions into them: ~0.56 GB a training step each way at the
// NGP cell's ~274 K samples x 8 levels, far below the 67 TFLOP/s that
// would bound the operations.  So the design moves nothing it need not:
//
// Read in place, nothing rebuilt.  The plain version materialises the
// whole (n_rows, 8F) gather target every call (8 shifted slices of each
// dense corner grid, a cat with the hashed rows, and a bf16 copy of the
// table), ~100 MB written and read again, then gathers (M L, 8, F) rows and
// products through device memory; its backward scatters into a (rows, 8F)
// temporary per dense level and folds it back with 8 slice-adds.  Here a
// dense level reads its 8 corner entries where they lie in the corner grid
// and adds its gradient straight back into them; a hashed level reads its
// row as 16-byte loads; the bf16 rounding happens in registers; nothing
// but the (M, L F) features (forward) and the table gradient (backward) is
// written.
//
// Layout of the work.  A block holds 32 samples and all L levels: warp l
// (threadIdx.y) is level l and lane i its sample, so a warp's level
// constants and branch (dense or hashed) are uniform.  The features and
// their cotangent, (M, L F) row-major, pass through shared memory so that
// the global stores (forward) and loads (backward) are coalesced rows.
//
// Neighbouring samples share cells.  The marcher's samples of a ray are
// consecutive, so at the coarse levels neighbouring lanes usually fall in
// one cell (the coarsest level puts ~274 K samples a step on 17^3 corners),
// and their backward reductions would all hit the same 8 entries.  A warp
// that finds runs of one row among neighbouring lanes first sums each run
// with shuffles (a segmented suffix sum) and lets the run's first lane
// alone add it; a warp without runs (the fine levels, mostly) adds lane by
// lane.  This adapts per warp to what it observes, with no setting.
//
// Exact arithmetic.  The cell and weights are the plain version's fp32
// operations in its order, each rounded (the __f*_rn intrinsics, which
// nvcc never contracts into an fma), so they equal the plain version's bit
// for bit; each product w[c] * e[c] is rounded as the plain version's
// elementwise product is.  Only the order of the 8-corner sum differs
// (forward), and the order of the gradient's sums, which the atomics leave
// to the run (as the plain version's index_add_ on the card does).  The
// hashed row is computed in uint32, which wraps as the plain version's
// int64 emulation does.  The input is clamped to [0, 1] by the caller, so
// a dense level's cell lies in [0, res); a non-finite position is clamped
// into the grid instead of read out of it (its weights are NaN).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSamples = 32;    // samples a block, one a lane
// levels a block, one warp each: 512 threads, so a thread may keep 128
// registers (an F = 8 row is 64 floats)
constexpr int kMaxLevels = 16;
constexpr unsigned kFull = 0xffffffffu;
// a lane without a sample: no row a level can have
constexpr unsigned kNoRow = 0xffffffffu;

// The layout's levels, passed by value: scale_l, cells a side, hashed rows
// (0 marks a dense level) and the level's first corner entry (dense) or
// brick row (hashed).
struct Levels {
  float scale[kMaxLevels];
  int res[kMaxLevels];
  int rows[kMaxLevels];
  long long start[kMaxLevels];
};

// One sample at one level: its cell (uint32, as the plain version's
// as_u32) and its 8 corner weights.
struct Cell {
  unsigned g[3];
  float w[8];
};

__device__ __forceinline__ Cell cell_of(const float* __restrict__ x,
                                        float scale) {
  Cell c;
  float lo[3], hi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(__ldg(x + d), scale), 0.5f);
    const float f = floorf(pos);
    c.g[d] = (unsigned)__float2int_rz(f);
    hi[d] = __fsub_rn(pos, f);
    lo[d] = __fsub_rn(1.0f, hi[d]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    c.w[k] = __fmul_rn(__fmul_rn((k & 4) ? hi[2] : lo[2],
                                 (k & 2) ? hi[1] : lo[1]),
                       (k & 1) ? hi[0] : lo[0]);
  return c;
}

// The spatial hash of ops/hash_encoder.py:fast_hash, mod 2^32.
__device__ __forceinline__ unsigned fast_hash(const unsigned* g) {
  return g[0] ^ (g[1] * 2654435761u) ^ (g[2] * 805459861u);
}

// A dense level's first corner entry of the cell (the cell clamped into the
// grid) and its linear index, in the corner grid (res + 1)^3, z slowest.
__device__ __forceinline__ long long dense_base(const Cell& c, int res,
                                                long long start,
                                                unsigned* lin) {
  const unsigned top = (unsigned)res - 1u;
  const unsigned gx = min(c.g[0], top), gy = min(c.g[1], top),
                 gz = min(c.g[2], top);
  *lin = gx + (unsigned)res * (gy + (unsigned)res * gz);
  const long long cres = res + 1;
  return start + ((long long)gz * cres + gy) * cres + gx;
}

// corner c's entry, relative to the cell's first
__device__ __forceinline__ long long corner_step(int k, int res) {
  const long long cres = res + 1;
  return ((k >> 2) * cres + ((k >> 1) & 1)) * cres + (k & 1);
}

// N consecutive floats (N a multiple of 4, or 1 or 2), 16 bytes a load.
template <int N>
__device__ __forceinline__ void load(const float* __restrict__ p, float* v) {
  if constexpr (N == 1) {
    v[0] = __ldg(p);
  } else if constexpr (N == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  }
}

// Add N consecutive floats into p, 16 bytes a vector reduction.
template <int N>
__device__ __forceinline__ void red_add(float* p, const float* v) {
  if constexpr (N == 1) {
    atomicAdd(p, v[0]);
  } else if constexpr (N == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      atomicAdd(reinterpret_cast<float4*>(p + i),
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  }
}

template <bool BF16>
__device__ __forceinline__ float table_value(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// acc += w * e over the F features, each product rounded
template <int F, bool BF16>
__device__ __forceinline__ void accumulate(float* acc, float w,
                                           const float* e) {
#pragma unroll
  for (int f = 0; f < F; ++f)
    acc[f] = __fadd_rn(acc[f], __fmul_rn(table_value<BF16>(e[f]), w));
}

template <int F, bool BF16>
__global__ void __launch_bounds__(kSamples * kMaxLevels)
    brick_encode_fwd_kernel(const float* __restrict__ xyz,
                            const float* __restrict__ corners,
                            const float* __restrict__ bricks,
                            float* __restrict__ out, long long M, int L,
                            const Levels lv) {
  extern __shared__ float tile[];
  const int lane = threadIdx.x, l = threadIdx.y;
  const int LF = L * F, S = LF | 1;  // an odd row stride: no bank conflict
  const long long m0 = (long long)blockIdx.x * kSamples;
  const long long m = m0 + lane;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  if (m < M) {
    const Cell c = cell_of(xyz + 3 * m, lv.scale[l]);
    const int res = lv.res[l];
    if (lv.rows[l] == 0) {
      unsigned lin;
      const long long base = dense_base(c, res, lv.start[l], &lin);
      float e[8][F];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        load<F>(corners + (base + corner_step(k, res)) * F, e[k]);
#pragma unroll
      for (int k = 0; k < 8; ++k) accumulate<F, BF16>(acc, c.w[k], e[k]);
    } else {
      const unsigned row = fast_hash(c.g) % (unsigned)lv.rows[l];
      float e[8 * F];
      load<8 * F>(bricks + (lv.start[l] + row) * (8 * F), e);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        accumulate<F, BF16>(acc, c.w[k], e + k * F);
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) tile[lane * S + l * F + f] = acc[f];
  __syncthreads();
  const int n = (int)min((long long)kSamples, M - m0) * LF;
  float* o = out + m0 * LF;
  for (int i = l * kSamples + lane; i < n; i += kSamples * L)
    o[i] = tile[(i / LF) * S + i % LF];
}

template <int F>
__global__ void __launch_bounds__(kSamples * kMaxLevels)
    brick_encode_bwd_kernel(const float* __restrict__ dout,
                            const float* __restrict__ xyz,
                            float* __restrict__ dcorners,
                            float* __restrict__ dbricks, long long M, int L,
                            const Levels lv) {
  extern __shared__ float tile[];
  const int lane = threadIdx.x, l = threadIdx.y;
  const int LF = L * F, S = LF | 1;
  const long long m0 = (long long)blockIdx.x * kSamples;
  const long long m = m0 + lane;
  const bool valid = m < M;
  {
    const int n = (int)min((long long)kSamples, M - m0) * LF;
    const float* d = dout + m0 * LF;
    for (int i = l * kSamples + lane; i < n; i += kSamples * L)
      tile[(i / LF) * S + i % LF] = d[i];
  }
  __syncthreads();
  // v[k F + f] = w[k] * dout[m, l F + f]: the sample's addition to corner k
  float v[8 * F];
  unsigned key = kNoRow;
  long long base = 0;
  const int res = lv.res[l];
  const bool dense = lv.rows[l] == 0;
  if (valid) {
    const Cell c = cell_of(xyz + 3 * m, lv.scale[l]);
    if (dense) {
      base = dense_base(c, res, lv.start[l], &key);
    } else {
      key = fast_hash(c.g) % (unsigned)lv.rows[l];
      base = (lv.start[l] + key) * (8 * F);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int f = 0; f < F; ++f)
        v[k * F + f] = __fmul_rn(c.w[k], tile[lane * S + l * F + f]);
  } else {
#pragma unroll
    for (int i = 0; i < 8 * F; ++i) v[i] = 0.0f;
  }
  // runs of one row among neighbouring lanes: each summed into its first
  const unsigned prev = __shfl_up_sync(kFull, key, 1);
  const bool head = lane == 0 || prev != key;
  const unsigned heads = __ballot_sync(kFull, head);
  if (heads != kFull) {
    // this lane's run ends at the next head after it (or the warp's end)
    const unsigned after = heads & ~((2u << lane) - 1u);
    const int end = after ? __ffs(after) - 1 : kSamples;
    const int longest = __reduce_max_sync(kFull, head ? end - lane : 1);
    for (int off = 1; off < longest; off <<= 1) {
#pragma unroll
      for (int i = 0; i < 8 * F; ++i) {
        const float t = __shfl_down_sync(kFull, v[i], off);
        if (lane + off < end) v[i] = __fadd_rn(v[i], t);
      }
    }
  }
  if (!(valid && head)) return;
  if (dense) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      red_add<F>(dcorners + (base + corner_step(k, res)) * F, v + k * F);
  } else {
    red_add<8 * F>(dbricks + base, v);
  }
}

// The host's level table: scales (L,), info (3 L,): per level cells a
// side, hashed rows (0: dense) and first corner entry or brick row.
bool levels_of(const float* scales, const long long* info, int L,
               Levels* lv) {
  if (L < 1 || L > kMaxLevels) return false;
  for (int i = 0; i < L; ++i) {
    lv->scale[i] = scales[i];
    lv->res[i] = (int)info[3 * i];
    lv->rows[i] = (int)info[3 * i + 1];
    lv->start[i] = info[3 * i + 2];
    if (info[3 * i] < 1 || info[3 * i] > (1 << 20) || info[3 * i + 1] < 0 ||
        info[3 * i + 1] > (1ll << 31) - 1 || info[3 * i + 2] < 0)
      return false;
  }
  return true;
}

template <int F>
cudaError_t launch_fwd(const float* xyz, const float* corners,
                       const float* bricks, float* out, long long M, int L,
                       bool bf16, const Levels& lv, cudaStream_t st) {
  const dim3 block(kSamples, L);
  const unsigned grid = (unsigned)((M + kSamples - 1) / kSamples);
  const size_t smem = sizeof(float) * kSamples * ((L * F) | 1);
  if (bf16)
    brick_encode_fwd_kernel<F, true><<<grid, block, smem, st>>>(
        xyz, corners, bricks, out, M, L, lv);
  else
    brick_encode_fwd_kernel<F, false><<<grid, block, smem, st>>>(
        xyz, corners, bricks, out, M, L, lv);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_bwd(const float* dout, const float* xyz, float* dcorners,
                       float* dbricks, long long M, int L, const Levels& lv,
                       cudaStream_t st) {
  const dim3 block(kSamples, L);
  const unsigned grid = (unsigned)((M + kSamples - 1) / kSamples);
  const size_t smem = sizeof(float) * kSamples * ((L * F) | 1);
  brick_encode_bwd_kernel<F><<<grid, block, smem, st>>>(
      dout, xyz, dcorners, dbricks, M, L, lv);
  return cudaGetLastError();
}

bool bad_shape(long long M, int F) {
  return M <= 0 || (M + kSamples - 1) / kSamples > 0x7fffffffll ||
         !(F == 1 || F == 2 || F == 4 || F == 8);
}

}  // namespace

// xyz (M, 3) fp32 in [0, 1]; corners (n_corners, F) and bricks (n_bricks,
// 8F) fp32; out (M, L F) fp32; all contiguous on one device, the tables
// 16-byte aligned.  F in {1, 2, 4, 8}, 1 <= L <= 16; bf16 1 rounds each
// table value read to bf16.  Returns the launch's cudaError.
extern "C" int brick_encode_fwd(const float* xyz, const float* corners,
                                const float* bricks, float* out, long long M,
                                int L, int F, int bf16, const float* scales,
                                const long long* info, void* stream) {
  Levels lv;
  if (bad_shape(M, F) || (bf16 != 0 && bf16 != 1) ||
      !levels_of(scales, info, L, &lv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return (int)launch_fwd<1>(xyz, corners, bricks, out, M, L, bf16,
                                      lv, st);
    case 2: return (int)launch_fwd<2>(xyz, corners, bricks, out, M, L, bf16,
                                      lv, st);
    case 4: return (int)launch_fwd<4>(xyz, corners, bricks, out, M, L, bf16,
                                      lv, st);
    default: return (int)launch_fwd<8>(xyz, corners, bricks, out, M, L, bf16,
                                       lv, st);
  }
}

// dout (M, L F) fp32; xyz as above; dcorners (n_corners, F) and dbricks
// (n_bricks, 8F) fp32, zeroed by the caller, added into.
extern "C" int brick_encode_bwd(const float* dout, const float* xyz,
                                float* dcorners, float* dbricks, long long M,
                                int L, int F, const float* scales,
                                const long long* info, void* stream) {
  Levels lv;
  if (bad_shape(M, F) || !levels_of(scales, info, L, &lv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return (int)launch_bwd<1>(dout, xyz, dcorners, dbricks, M, L, lv,
                                      st);
    case 2: return (int)launch_bwd<2>(dout, xyz, dcorners, dbricks, M, L, lv,
                                      st);
    case 4: return (int)launch_bwd<4>(dout, xyz, dcorners, dbricks, M, L, lv,
                                      st);
    default: return (int)launch_bwd<8>(dout, xyz, dcorners, dbricks, M, L,
                                       lv, st);
  }
}
