// Multiresolution hash-grid encoder (the NGP path's position encoding with
// --encoder_type hash, the paper's own grid) — hand-written CUDA for Hopper
// (sm_90a): one gather kernel (forward) and one scatter kernel (the table
// gradient, transposed into the table's layout by a second launch).
//
// Replaces no TPU kernel.  The JAX package's hash encoder (its
// ops/hash_encoder.py) is XLA index arithmetic, gathers and scatter-adds,
// with no Pallas kernel.  The plain PyTorch version of the same function,
// which the port runs on the CPU, is taichi_nerfs_torch/ops/hash_encoder.py:
// hash_encode_reference; these kernels serve every CUDA call of
// ops/hash_encoder.py:hash_encode (the training step's field and backward,
// the occupancy refresh, the test renderer).
//
// What it computes.  For each position x (M, 3) and level l: pos = x *
// scale_l + 0.5, the cell g = floor(pos) (uint32: a negative cell wraps),
// the in-cell fraction f = pos - g and, for each corner c = cx + 2 cy + 4 cz,
// the weight w[c] = (w_x * w_y) * w_z with w_d = bit_d ? f_d : 1 - f_d and
// the entry offset_l + h(g + bits) % size_l, where h is the XOR-prime hash
// (hashed levels) or the linear index x + y res + z res^2 (dense levels),
// both mod 2^32.  The table is feature-major, (F, n_entries), fp32 or bf16;
// feature f of the level is sum_c w[c] * table[f, entry(c)], written to the
// (M, L F) output, level-major.  The backward adds w[c] * dout into the same
// entries of an fp32 gradient.
//
// What bounds it on this card: the scatter of bytes.  The operations are 8
// multiply-adds per feature and level; the data is random F-value reads of
// a 45.7 MB table (the NGP cell's 16 x 2, T = 2^19) and, in the backward,
// their reductions: ~259 K samples a training step, 16 levels, 8 corners,
// every corner its own entry.  The plain version builds int64 (M, L, 8)
// indices and fp32 weights with ~40 elementwise passes (265 MB of indices
// alone a step), gathers (F, M, L, 8) values and reduces them, and its
// backward is an index_add_ over every corner.  Here a thread computes its
// position's cell, indices and weights in registers, reads its 8 F values
// where they lie and writes its F features: nothing else is written
// (forward); the backward recomputes them from the saved positions.
//
// Layout of the work.  A thread is one (position, level), the level on
// blockIdx.y: a warp holds 32 neighbouring samples at one level, so the
// level's constants and its branch (dense or hashed) are uniform, and the
// blocks of one level run together, which keeps that level's part of the
// table in the L2.
//
// Neighbouring samples share cells.  The marcher's samples of a ray are
// consecutive, so at the coarse levels neighbouring lanes usually fall in
// one cell (level 0 has 4,096 entries for ~2 M corner adds a step) and
// their reductions would all hit the same 8 entries.  A warp that finds
// runs of one cell among neighbouring lanes first sums each run with
// shuffles (a segmented suffix sum) and lets the run's first lane alone add
// it; a warp without runs (the fine levels, mostly) adds lane by lane.
//
// The gradient.  An entry's F features lie n_entries apart in the table, so
// F scalar reductions into the (F, n) gradient would touch F sectors.  The
// scatter kernel instead adds each corner's F values as one vector
// reduction into an entry-major (n, F) fp32 scratch, and a second kernel
// transposes it into the (F, n) gradient in the table's dtype (rounding
// once to bf16 for a bf16 table).  Measured on the H100 at the NGP cell's
// step (16 x 2, ~259 K positions), this took the backward from 0.585 ms
// (scalar reductions straight into the gradient) to 0.374 ms, the
// transpose's ~91 MB included.
//
// Exact arithmetic.  The cell, the indices and the weights are the plain
// version's fp32 and uint32 operations in its order, each rounded (the
// __f*_rn intrinsics, which nvcc never contracts into an fma), so they equal
// the plain version's bit for bit; each product w[c] * e is rounded as the
// plain version's elementwise product is, and a bf16 table value is widened
// to fp32 exactly.  Only the order of the 8-corner sum differs (forward),
// and the order of the gradient's sums, which the atomics leave to the run
// (as the plain version's index_add_ on the card does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // positions a block, one a thread
constexpr int kMaxLevels = 16;
constexpr unsigned kFull = 0xffffffffu;

// The layout's levels, passed by value: scale_l, cells a side, table size,
// first entry, whether hashed; and the hash's three primes.
struct Levels {
  float scale[kMaxLevels];
  unsigned res[kMaxLevels];
  unsigned size[kMaxLevels];
  unsigned offset[kMaxLevels];
  int hashed[kMaxLevels];
  unsigned prime[3];
};

// One position at one level: its cell (uint32), its 8 corners' entries and
// weights, corner c = cx + 2 cy + 4 cz.
struct Corners {
  unsigned g[3];
  unsigned entry[8];
  float w[8];
};

__device__ __forceinline__ Corners corners_of(const float* __restrict__ x,
                                              int l, const Levels& lv) {
  Corners c;
  float hi[3], lo[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(__ldg(x + d), lv.scale[l]), 0.5f);
    const float pg = floorf(pos);
    c.g[d] = (unsigned)__float2int_rz(pg);
    hi[d] = __fsub_rn(pos, pg);
    lo[d] = __fsub_rn(1.0f, hi[d]);
  }
  const unsigned res = lv.res[l], size = lv.size[l], off = lv.offset[l];
  const bool hashed = lv.hashed[l] != 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned cx = c.g[0] + (k & 1), cy = c.g[1] + ((k >> 1) & 1),
                   cz = c.g[2] + ((k >> 2) & 1);
    const unsigned h =
        hashed ? (cx * lv.prime[0]) ^ (cy * lv.prime[1]) ^ (cz * lv.prime[2])
               : cx + cy * res + (cz * res) * res;
    c.entry[k] = h % size + off;
    c.w[k] = __fmul_rn(__fmul_rn((k & 1) ? hi[0] : lo[0],
                                 (k & 2) ? hi[1] : lo[1]),
                       (k & 4) ? hi[2] : lo[2]);
  }
  return c;
}

// A table value as fp32: a bf16 value (its bits) widened exactly.
__device__ __forceinline__ float table_value(const float* p) {
  return __ldg(p);
}
__device__ __forceinline__ float table_value(const unsigned short* p) {
  return __uint_as_float((unsigned)__ldg(p) << 16);
}

// N consecutive floats (N in 1, 2, 4, 8), as 4-, 8- or 16-byte accesses.
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

template <int N>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (N == 1) {
    p[0] = v[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// Add N consecutive floats into p, as one vector reduction (two for N = 8).
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

template <int F, typename T>
__global__ void __launch_bounds__(kThreads)
    hash_encode_fwd_kernel(const float* __restrict__ xyz,
                           const T* __restrict__ table,
                           float* __restrict__ out, long long M, long long n,
                           int L, const Levels lv) {
  const long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const int l = blockIdx.y;
  const Corners c = corners_of(xyz + 3 * m, l, lv);
  float e[F][8];
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      e[f][k] = table_value(table + f * n + c.entry[k]);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    acc[f] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc[f] = __fadd_rn(acc[f], __fmul_rn(c.w[k], e[f][k]));
  }
  store<F>(out + m * (L * F) + l * F, acc);
}

// Adds into the (n, F) fp32 scratch acc, one vector reduction a corner.
template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_encode_bwd_kernel(const float* __restrict__ dout,
                           const float* __restrict__ xyz,
                           float* __restrict__ acc, long long M, int L,
                           const Levels lv) {
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int l = blockIdx.y;
  const bool valid = m < M;
  // v[k][f] = w[k] * dout[m, l F + f]: the position's addition to corner k
  float v[8][F];
  Corners c;
  if (valid) {
    c = corners_of(xyz + 3 * m, l, lv);
    const float* d = dout + m * (L * F) + l * F;
    float g[F];
#pragma unroll
    for (int f = 0; f < F; ++f) g[f] = __ldg(d + f);
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int f = 0; f < F; ++f) v[k][f] = __fmul_rn(c.w[k], g[f]);
  } else {
    c.g[0] = c.g[1] = c.g[2] = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int f = 0; f < F; ++f) v[k][f] = 0.0f;
  }
  // runs of one cell among neighbouring lanes: each summed into its first
  const unsigned px = __shfl_up_sync(kFull, c.g[0], 1);
  const unsigned py = __shfl_up_sync(kFull, c.g[1], 1);
  const unsigned pz = __shfl_up_sync(kFull, c.g[2], 1);
  const int pvalid = __shfl_up_sync(kFull, (int)valid, 1);
  const bool head = lane == 0 || pvalid != (int)valid || px != c.g[0] ||
                    py != c.g[1] || pz != c.g[2];
  const unsigned heads = __ballot_sync(kFull, head);
  if (heads != kFull) {
    // this lane's run ends at the next head after it (or the warp's end)
    const unsigned after = heads & ~((2u << lane) - 1u);
    const int end = after ? __ffs(after) - 1 : 32;
    const int longest = __reduce_max_sync(kFull, head ? end - lane : 1);
    for (int off = 1; off < longest; off <<= 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float t = __shfl_down_sync(kFull, v[k][f], off);
          if (lane + off < end) v[k][f] = __fadd_rn(v[k][f], t);
        }
    }
  }
  if (!(valid && head)) return;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    red_add<F>(acc + (long long)c.entry[k] * F, v[k]);
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// grad[f, e] = acc[e, f] (F features an entry) in the gradient's dtype.
template <int F, typename T>
__global__ void __launch_bounds__(kThreads)
    hash_grad_transpose_kernel(const float* __restrict__ acc,
                               T* __restrict__ grad, long long n) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float v[F];
  load<F>(acc + e * F, v);
#pragma unroll
  for (int f = 0; f < F; ++f) put(grad + f * n + e, v[f]);
}

// The host's level table: scales (L,), info (4 L,): per level cells a side,
// table size, first entry and 1 if hashed; primes (3,).
bool levels_of(const float* scales, const long long* info,
               const long long* primes, int L, long long n, Levels* lv) {
  if (L < 1 || L > kMaxLevels || n < 1 || n > 0xffffffffll) return false;
  for (int i = 0; i < L; ++i) {
    const long long res = info[4 * i], size = info[4 * i + 1],
                    off = info[4 * i + 2], hashed = info[4 * i + 3];
    if (res < 1 || res > 0xffffffffll || size < 1 || off < 0 ||
        off + size > n || (hashed != 0 && hashed != 1))
      return false;
    lv->scale[i] = scales[i];
    lv->res[i] = (unsigned)res;
    lv->size[i] = (unsigned)size;
    lv->offset[i] = (unsigned)off;
    lv->hashed[i] = (int)hashed;
  }
  for (int d = 0; d < 3; ++d) {
    if (primes[d] < 0 || primes[d] > 0xffffffffll) return false;
    lv->prime[d] = (unsigned)primes[d];
  }
  return true;
}

bool bad_shape(long long M, int F) {
  return M <= 0 || (M + kThreads - 1) / kThreads > 0x7fffffffll ||
         !(F == 1 || F == 2 || F == 4 || F == 8);
}

dim3 grid_of(long long count, int L) {
  return dim3((unsigned)((count + kThreads - 1) / kThreads), (unsigned)L);
}

template <int F>
cudaError_t launch_fwd(const float* xyz, const void* table, float* out,
                       long long M, long long n, int L, bool bf16,
                       const Levels& lv, cudaStream_t st) {
  if (bf16)
    hash_encode_fwd_kernel<F><<<grid_of(M, L), kThreads, 0, st>>>(
        xyz, static_cast<const unsigned short*>(table), out, M, n, L, lv);
  else
    hash_encode_fwd_kernel<F><<<grid_of(M, L), kThreads, 0, st>>>(
        xyz, static_cast<const float*>(table), out, M, n, L, lv);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_bwd(const float* dout, const float* xyz, float* acc,
                       void* grad, long long M, long long n, int L, bool bf16,
                       const Levels& lv, cudaStream_t st) {
  hash_encode_bwd_kernel<F><<<grid_of(M, L), kThreads, 0, st>>>(
      dout, xyz, acc, M, L, lv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (bf16)
    hash_grad_transpose_kernel<F><<<grid_of(n, 1), kThreads, 0, st>>>(
        acc, static_cast<__nv_bfloat16*>(grad), n);
  else
    hash_grad_transpose_kernel<F><<<grid_of(n, 1), kThreads, 0, st>>>(
        acc, static_cast<float*>(grad), n);
  return cudaGetLastError();
}

}  // namespace

// xyz (M, 3) fp32; table (F, n) fp32, or bf16 with bf16 = 1; out (M, L F)
// fp32, 8-byte aligned (16 for F >= 4); all contiguous on one device.  F in
// {1, 2, 4, 8}, 1 <= L <= 16.  Returns the launch's cudaError.
extern "C" int hash_encode_fwd(const float* xyz, const void* table, float* out,
                               long long M, long long n, int L, int F,
                               int bf16, const float* scales,
                               const long long* info, const long long* primes,
                               void* stream) {
  Levels lv;
  if (bad_shape(M, F) || (bf16 != 0 && bf16 != 1) ||
      !levels_of(scales, info, primes, L, n, &lv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return (int)launch_fwd<1>(xyz, table, out, M, n, L, bf16, lv, st);
    case 2: return (int)launch_fwd<2>(xyz, table, out, M, n, L, bf16, lv, st);
    case 4: return (int)launch_fwd<4>(xyz, table, out, M, n, L, bf16, lv, st);
    default: return (int)launch_fwd<8>(xyz, table, out, M, n, L, bf16, lv, st);
  }
}

// dout (M, L F) fp32; xyz as above; acc an (n, F) fp32 scratch zeroed by
// the caller, 16-byte aligned; grad (F, n), bf16 with bf16 = 1, else fp32.
// Two launches: the scatter into acc, then its transpose into grad.
extern "C" int hash_encode_bwd(const float* dout, const float* xyz,
                               float* acc, void* grad, long long M,
                               long long n, int L, int F, int bf16,
                               const float* scales, const long long* info,
                               const long long* primes, void* stream) {
  Levels lv;
  if (bad_shape(M, F) || (bf16 != 0 && bf16 != 1) ||
      !levels_of(scales, info, primes, L, n, &lv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return (int)launch_bwd<1>(dout, xyz, acc, grad, M, n, L, bf16,
                                      lv, st);
    case 2: return (int)launch_bwd<2>(dout, xyz, acc, grad, M, n, L, bf16,
                                      lv, st);
    case 4: return (int)launch_bwd<4>(dout, xyz, acc, grad, M, n, L, bf16,
                                      lv, st);
    default: return (int)launch_bwd<8>(dout, xyz, acc, grad, M, n, L, bf16,
                                       lv, st);
  }
}
