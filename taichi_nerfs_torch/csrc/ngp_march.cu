// NGP cell-interval march (the training step's sampler) — hand-written CUDA
// for Hopper (sm_90a): one launch marches every ray and compacts its
// samples.
//
// Replaces no TPU kernel.  The JAX package's marcher (its ops/marching.py)
// is XLA ops, with no Pallas kernel.  The plain PyTorch version of the same
// function, which the port runs on the CPU and which the card tests hold
// this kernel to, is taichi_nerfs_torch/ops/marching.py:
// _march_rays_intervals; this kernel serves every CUDA call of
// ops/marching.py:march_rays on the interval path (one cascade, constant
// dt, no probe window): the training step of every NGP-family model.
//
// What it computes.  A ray o + t d, alive when t_start >= 0, is marched
// from t0 = t_start to t1 = max(t_end, t0) through the G^3 occupancy grid
// over [-scale, scale]^3 (one cascade, an int32 bitfield of morton-indexed
// cells).  The crossings of the ray with the cell planes -scale + i h
// (h = 2 scale / G, 0 < i < G, all three axes) that lie strictly inside
// (t0, t1), and t1 itself, cut [t0, t1] into intervals.  Each interval
// [lo, hi] is probed once, at the cell of its midpoint; an occupied one
// contributes its points of the ray's lattice t0 + k dt, k = ceil((lo -
// t0) / dt) .. ceil((min(hi, t1) - t0) / dt) - 1, at most E of them.  The
// first S of those samples, in order, are the ray's ts (deltas dt), zero
// past its count; t_final is t_end, the sample after the S-th where the
// cap was reached, or t_start for a dead ray.
//
// What bounds it on this card: neither bytes nor operations.  The inputs
// are 32 bytes a ray and a 256 KB bitfield (G = 128) that stays in the L2;
// the outputs are the (N, S) ts and deltas, 16.8 MB at the NGP cell's
// 8,192 rays and S = 256 (~5 us at 3.35 TB/s).  The work is a walk of at
// most 3 (G - 1) + 1 intervals a ray, each a few dozen dependent
// operations and one bitfield word read: the walk's latency bounds it.
// The plain version instead materialises the (N, 3 (G - 1) + 1) crossings,
// sorts them, expands every interval to its E lattice points, (N, 3438) at
// G = 128, and compacts them with an int64 cumsum and a scatter: ~95
// launches and ~1 GB of temporaries a training step.
//
// Design: a warp a ray, 4 rays a block, so that the NGP cell's 8,192 rays
// are 8,192 warps over the card (a first version, a thread a ray, took
// 0.176 ms on the H100 at that step: 256 warps cannot hide the walk's
// latency).
// Nothing but the outputs is written to device memory:
//   the walk merges the three axes' crossings, which are monotone in the
//     plane index (the planes rise with i, a fixed origin and a fixed
//     reciprocal keep the order), instead of sorting them.  Each axis
//     keeps the index of its next crossing, found once from a guess of
//     the ray's cell at t0 and made exact by testing the neighbours.  A
//     round takes the next 32 crossings of each axis, one a lane, and
//     ranks each among the others by a binary search over the other two
//     axes' lanes (shuffles; ties go to x, then y, then z): the 32 of
//     lowest rank are the walk's next 32 intervals, placed through shared
//     memory in rank order, one a lane.  Crossings that tie give a
//     zero-length interval, which emits nothing, as in the sorted array; a
//     crossing at t0 or t1 exactly is left out, as the plain version's
//     strict test leaves it out;
//   each lane probes its interval's midpoint cell, one bitfield word read
//     through the read-only path (32 reads in flight a warp), and counts
//     its lattice points; an exclusive scan over the lanes (shuffles)
//     gives each lane where its samples go, and the ray's count runs on;
//   the ray stops at S (the count past S changes no output: counts is
//     min(total, S), and a capped ray resumes after its S-th sample);
//   then the warp writes the row's deltas and the zeros past its count,
//     consecutive lanes on consecutive columns.
//
// Exact arithmetic.  Every value is the plain version's fp32 operations in
// its order, each rounded as the separate PyTorch op rounds it (the
// __f*_rn intrinsics, which nvcc never contracts into an fma: t0 + k dt and
// 0.5 (x / scale + 1) G must not fuse), so ts, deltas, counts and t_final
// are bit-equal to the plain version on the card: the planes are
// (-scale) + i h in fp32; 1 / d is an IEEE division, and an axis with
// |d| <= 1e-12 (fp32) has no crossing; a division by the Python scalars
// scale and dt is, as PyTorch computes it on CUDA, a product with the fp32
// reciprocal of the fp32 scalar (computed here on the host, as PyTorch
// does).  Positions are finite: the walk does not reproduce what the plain
// version does with a non-finite origin (an index out of the bitfield).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rays a block, a warp each
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = __builtin_huge_valf();

// The lattice and the grid, in the fp32 values the plain version's ops
// use.
struct Lattice {
  float dt;         // the lattice step
  float inv_dt;     // 1 / dt: a division by dt
  float h;          // the cell side 2 scale / G
  float neg_scale;  // -scale, the first plane's offset
  float inv_scale;  // 1 / scale: a division by scale
  float g;          // G
  float g_top;      // G - 1, the clamp of a cell coordinate
  float e_max;      // E, the most lattice points of one interval
  int grid;         // G
};

// t at which the ray crosses plane i of an axis: (-scale + i h - o) / d.
__device__ __forceinline__ float crossing(int i, float o, float inv,
                                          const Lattice& L) {
  const float plane = __fadd_rn(__fmul_rn((float)i, L.h), L.neg_scale);
  return __fmul_rn(__fsub_rn(plane, o), inv);
}

// One axis of the walk: the plane index of its next crossing and the
// step through the plane indices (+1 or -1; 0 for an axis with none).
struct Axis {
  float o, inv;
  int i, step;
};

// The axis's first crossing after t0, the same on every lane.  The
// crossings are monotone in the plane index, so the guess (the ray's cell
// at t0, any rounding) is made exact by stepping while a neighbour's
// crossing is on the wrong side.
__device__ Axis first_crossing(float o, float d, float t0, const Lattice& L) {
  Axis a{o, 0.0f, 0, 0};
  if (!(fabsf(d) > 1e-12f)) return a;  // 1 / d is infinite: no crossing
  a.inv = __fdiv_rn(1.0f, d);
  const int G = L.grid;
  float u = (o + t0 * d - L.neg_scale) / L.h;
  u = fminf(fmaxf(u, -1.0f), (float)G + 1.0f);
  int i;
  if (d > 0.0f) {  // crossings rise with i: the first one past t0
    a.step = 1;
    i = min(max((int)floorf(u) + 1, 1), G);
    while (i > 1 && crossing(i - 1, o, a.inv, L) > t0) --i;
    while (i < G && !(crossing(i, o, a.inv, L) > t0)) ++i;
  } else {  // crossings fall with i: the last one past t0
    a.step = -1;
    i = min(max((int)ceilf(u) - 1, 0), G - 1);
    while (i < G - 1 && crossing(i + 1, o, a.inv, L) > t0) ++i;
    while (i > 0 && !(crossing(i, o, a.inv, L) > t0)) --i;
  }
  a.i = i;
  return a;
}

// The axis's crossing `lane` steps after its next one, or infinity where
// the axis has no such crossing before t1.  Over the lanes: rising, then
// infinite.
__device__ __forceinline__ float candidate(const Axis& a, int lane, float t1,
                                           const Lattice& L) {
  const int i = a.i + lane * a.step;
  if (a.step == 0 || i < 1 || i >= L.grid) return kInf;
  const float c = crossing(i, a.o, a.inv, L);
  return c < t1 ? c : kInf;
}

// How many lanes hold a value below v (at most v with `or_equal`), for
// values that do not fall over the lanes.
__device__ __forceinline__ int lanes_below(float values, float v,
                                           bool or_equal) {
  int n = 0;
#pragma unroll
  for (int step = 16; step >= 1; step >>= 1) {
    const float p = __shfl_sync(kFull, values, n + step - 1);
    if (or_equal ? p <= v : p < v) n += step;
  }
  const float p = __shfl_sync(kFull, values, n);
  if (or_equal ? p <= v : p < v) ++n;
  return n;
}

// A position's cell coordinate: clamp(0.5 (x / scale + 1) G, 0, G - 1),
// truncated.
__device__ __forceinline__ unsigned cell_of(float x, const Lattice& L) {
  float q = __fadd_rn(__fmul_rn(x, L.inv_scale), 1.0f);
  q = __fmul_rn(__fmul_rn(0.5f, q), L.g);
  return (unsigned)(int)fminf(fmaxf(q, 0.0f), L.g_top);
}

// The low 10 bits of v spread to every third bit (ops/math.py:
// expand_bits).
__device__ __forceinline__ unsigned expand_bits(unsigned v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

__global__ void __launch_bounds__(32 * kWarps) ngp_march_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ t_start, const float* __restrict__ t_end,
    const unsigned* __restrict__ bits, float* __restrict__ ts,
    float* __restrict__ deltas, int* __restrict__ counts,
    float* __restrict__ t_final, long long n, int S, Lattice L) {
  __shared__ float slots[kWarps][32];
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n) return;  // the whole warp: no shuffle waits for it
  float* slot = slots[threadIdx.x >> 5];
  float o[3], d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = __ldg(rays_o + 3 * r + a);
    d[a] = __ldg(rays_d + 3 * r + a);
  }
  const float start = __ldg(t_start + r), end = __ldg(t_end + r);
  const bool alive = start >= 0.0f;
  const float t0 = alive ? start : 0.0f;
  // torch.maximum would give NaN for a NaN t_end: no interval either way
  const float t1 = fmaxf(alive ? end : 0.0f, t0);
  float* row = ts + r * S;
  int count = 0;  // the ray's samples so far, at most S
  if (t0 < t1) {
    Axis ax = first_crossing(o[0], d[0], t0, L);
    Axis ay = first_crossing(o[1], d[1], t0, L);
    Axis az = first_crossing(o[2], d[2], t0, L);
    float lo = t0;  // where the round's first interval starts
    for (;;) {
      // the next 32 crossings of each axis, ranked among all 96
      const float cx = candidate(ax, lane, t1, L);
      const float cy = candidate(ay, lane, t1, L);
      const float cz = candidate(az, lane, t1, L);
      const int rx = lane + lanes_below(cy, cx, false) +
                     lanes_below(cz, cx, false);
      const int ry = lane + lanes_below(cx, cy, true) +
                     lanes_below(cz, cy, false);
      const int rz = lane + lanes_below(cx, cz, true) +
                     lanes_below(cy, cz, true);
      const bool tx = cx < kInf && rx < 32, ty = cy < kInf && ry < 32,
                 tz = cz < kInf && rz < 32;
      slot[lane] = kInf;
      __syncwarp();
      if (tx) slot[rx] = cx;
      if (ty) slot[ry] = cy;
      if (tz) slot[rz] = cz;
      __syncwarp();
      // lane j's interval [lo, hi]: hi the walk's next crossing but j, or
      // the exit t1 after the last crossing
      float hi = slot[lane];
      const float before = __shfl_up_sync(kFull, hi, 1);
      const float start_j = lane == 0 ? lo : before;
      const int crossings = __popc(__ballot_sync(kFull, hi < kInf));
      const bool closing = crossings < 32;
      bool valid = lane < crossings;
      if (closing && lane == crossings && t1 < kInf) {
        hi = t1;
        valid = true;
      }
      ax.i += __popc(__ballot_sync(kFull, tx)) * ax.step;
      ay.i += __popc(__ballot_sync(kFull, ty)) * ay.step;
      az.i += __popc(__ballot_sync(kFull, tz)) * az.step;
      lo = __shfl_sync(kFull, hi, 31);
      // probe the interval's midpoint cell; an occupied one's lattice
      // points
      int points = 0;
      float k_lo = 0.0f;
      if (valid) {
        const float mid = __fmul_rn(__fadd_rn(start_j, hi), 0.5f);
        const unsigned code =
            expand_bits(cell_of(__fadd_rn(o[0], __fmul_rn(mid, d[0])), L)) |
            (expand_bits(cell_of(__fadd_rn(o[1], __fmul_rn(mid, d[1])), L))
             << 1) |
            (expand_bits(cell_of(__fadd_rn(o[2], __fmul_rn(mid, d[2])), L))
             << 2);
        if ((__ldg(bits + (code >> 5)) >> (code & 31u)) & 1u) {
          k_lo = ceilf(__fmul_rn(__fsub_rn(start_j, t0), L.inv_dt));
          const float k_hi =
              ceilf(__fmul_rn(__fsub_rn(fminf(hi, t1), t0), L.inv_dt));
          points = (int)fminf(fmaxf(__fsub_rn(k_hi, k_lo), 0.0f), L.e_max);
        }
      }
      // where the lane's samples go: an exclusive scan over the lanes
      int upto = points;
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const int v = __shfl_up_sync(kFull, upto, k);
        if (lane >= k) upto += v;
      }
      const int first = count + upto - points;
      for (int e = 0; e < points && first + e < S; ++e) {
        const float t =
            __fadd_rn(t0, __fmul_rn(__fadd_rn(k_lo, (float)e), L.dt));
        row[first + e] = t;
        // the cap: the ray resumes after its S-th sample
        if (first + e == S - 1) t_final[r] = __fadd_rn(t, L.dt);
      }
      count = min(count + __shfl_sync(kFull, upto, 31), S);
      if (count == S || closing) break;
    }
  }
  if (lane == 0) {
    counts[r] = count;
    if (count < S) t_final[r] = alive ? end : start;
  }
  // the row's deltas, and the zeros past its count
  float* drow = deltas + r * S;
  for (int j = lane; j < S; j += 32) {
    drow[j] = j < count ? L.dt : 0.0f;
    if (j >= count) row[j] = 0.0f;
  }
}

}  // namespace

// rays_o, rays_d (n, 3), t_start, t_end (n,) fp32; bitfield (>= G^3 / 32,)
// int32; ts, deltas (n, S) fp32, counts (n,) int32, t_final (n,) fp32, all
// written; all contiguous on one device.  G a power of two in [2, 1024],
// S >= 1, E >= 1; scale, the cell side h = 2 scale / G and the lattice
// step dt as the plain version's Python floats.  Returns the launch's
// cudaError.
extern "C" int ngp_march(const float* rays_o, const float* rays_d,
                         const float* t_start, const float* t_end,
                         const int* bitfield, float* ts, float* deltas,
                         int* counts, float* t_final, long long n, int grid,
                         int S, int E, double scale, double h, double dt,
                         void* stream) {
  if (n <= 0 || (n + kWarps - 1) / kWarps > 0x7fffffffll || S < 1 || E < 1 ||
      grid < 2 || grid > 1024 || (grid & (grid - 1)) != 0 || !(scale > 0.0) ||
      !(h > 0.0) || !(dt > 0.0))
    return (int)cudaErrorInvalidValue;
  // the Python scalars as PyTorch's CUDA ops take them: rounded to fp32,
  // a division by one a product with its fp32 reciprocal
  Lattice L;
  L.dt = (float)dt;
  L.inv_dt = 1.0f / L.dt;
  L.h = (float)h;
  L.neg_scale = (float)(-scale);
  L.inv_scale = 1.0f / (float)scale;
  L.g = (float)grid;
  L.g_top = (float)(grid - 1);
  L.e_max = (float)E;
  L.grid = grid;
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  ngp_march_kernel<<<blocks, 32 * kWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      rays_o, rays_d, t_start, t_end,
      reinterpret_cast<const unsigned*>(bitfield), ts, deltas, counts,
      t_final, n, S, L);
  return (int)cudaGetLastError();
}
