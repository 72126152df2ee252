// Fused wave scoring for the placement solve, written for Hopper (sm_90a).
//
// Replaces the TPU kernel nomad_tpu/solver/pallas_kernel.py `fused_wave`
// (pallas_call :317, body `_wave_tile_kernel` :385): one pass over every
// (group, node) pair that unpacks the bit-packed feasibility / penalty /
// blocked planes, computes resource and device fit, the bin-pack score,
// anti-affinity, targeted and even spread, the append-then-average
// normalization in the reference's exact summation order, seeded binning
// and jitter, and the NEG_INF mask, together with the per-group
// explainability counters.  Three kernels:
//
//   wave_score_kernel  mode score: writes the [Gp, Np] score plane.
//   wave_topk_kernel   mode topk: one block per (256-node tile, group)
//                      ranks the tile's entries and writes its sorted
//                      top entries, and with tables those of each spread
//                      value class; the plane never reaches memory.
//   wave_merge_kernel  merges the tile lists of each group (and of each
//                      class table) into the final lists.
//
// Bound on the H100: memory.  A score wave at Gp = 128, Np = 10,240 must
// move ~30 MB (three f32 [Gp, Np] planes read, the spread planes, packed
// masks, the f32 plane written): 8.9 us at 3.35 TB/s.  It runs at about
// four times that; its warm time (inputs in L2) is ~3/4 of its cold one,
// so it is held by the instruction stream, not by bytes.  Two
// full-precision powf and about six IEEE divisions a pair are kept for
// bit-identity; a timing-only fast-math build closed only part of the
// gap, so they are not all of it (PERF.md).  A topk wave at Gp = 4 moves
// ~1.3 MB (0.4 us); it is bound by latency: the length of the chain of
// dependent steps in a block, and the two launches.
//
// Numerics: build with -fmad=false and without fast math, so that no
// multiply-add is contracted (XLA does not contract either) and division
// stays IEEE; pow is powf(10.f, x).  `score_pair` is the one copy of the
// scoring chain and both kernels call it, in the reference's order.
// Counters are integer sums: exact and order-independent.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NEG_INF_F (-1e30f)
#define SCORE_BIN_F 0.05f
#define MAX_R 8
#define MAX_CNT (3 + MAX_R)
#define FULL_MASK 0xffffffffu

// score mode geometry: threads a block, nodes a thread, most groups a block
#define SCORE_THREADS 256
#define SCORE_NODES 4
#define SCORE_STRIPE (SCORE_THREADS * SCORE_NODES)
#define SCORE_MAX_GB 8
// topk mode geometry: one node a thread, one tile a block
#define TOPK_TILE 256
#define MERGE_THREADS 1024
// class id of a node whose spread value is outside the tables
#define NO_CLASS 0xffu

struct WaveArgs {
  const int32_t* feas;      // [Gp, W32] packed words
  const int32_t* pen;       // [Gp, W32]
  const int32_t* blocked;   // [Gp, W32] or null
  const float* aff;         // [Gp, Np]
  const float* jitter;      // [Gp, Np]
  const float* coll;        // [Gp, Np]
  const float* used;        // [Np, R]
  const float* avail;       // [Np, R]
  const float* reserved;    // [Np, R]
  const float* ask_res;     // [Gp, R]
  const float* ask_desired; // [Gp]
  const float* dev_used;    // [Np, D] (D = 0: no device planes)
  const float* dev_cap;     // [Np, D]
  const float* dev_ask;     // [Gp, D]
  const int16_t* sp_vnode;  // [S, Gp, Np] (S = 0: no spread)
  const float* sp_des;      // [S, Gp, Np]
  const float* sp_used;     // [Gp, S, V]
  const float* sp_w;        // [Gp, S]
  const int8_t* sp_t;       // [Gp, S]
  const int8_t* sp_has;     // [Gp, S]
  const float* minc;        // [Gp, S]
  const float* maxc;        // [Gp, S]
  const int8_t* anyp;       // [Gp, S]
  int Gp, Np, W32, R, D, S, V, seed;
  int vec;                  // planes 16-byte aligned and Np % 4 == 0
  int node_vec;             // [Np, R] planes 16-byte aligned (R = 4)
  int32_t* cnt;             // [Gp, 3 + R]: n_feas, n_exh, n_placeable, dim
};

// ------------------------------------------------------------ scoring
// A spread constraint's parameters for one group (the same for all its
// nodes), loaded once per group and constraint, and the even-spread value
// where a node's count equals the minimum count (minc == maxc ? -1 :
// (maxc - minc) / max(minc, 1e-9)), which depends on the group alone.
struct SpreadParams {
  bool has, targeted, anyp;
  float w, minc, even;
  const float* used;              // sp_used row [V]
};

__device__ __forceinline__ SpreadParams spread_params(const WaveArgs& a,
                                                      int g, int s) {
  const int gs = g * a.S + s;
  SpreadParams p;
  p.has = a.sp_has[gs] != 0;
  p.targeted = a.sp_t[gs] != 0;
  p.anyp = a.anyp[gs] != 0;
  p.w = a.sp_w[gs];
  p.minc = a.minc[gs];
  const float maxc = a.maxc[gs];
  p.even = p.minc == maxc ? -1.0f
                          : (maxc - p.minc) / fmaxf(p.minc, 1e-9f);
  p.used = a.sp_used + (size_t)gs * a.V;
  return p;
}

// Contribution of one spread constraint to one pair (value rank v, desired
// count `desired`): the reference's select chain (targeted when sp_t,
// else even; 0 without the constraint).  The branches are on the group's
// parameters only, so a warp never splits on them; the per-node choices
// are selects.
__device__ __forceinline__ float spread_contrib(const SpreadParams& p,
                                                int V, int v,
                                                float desired) {
  if (!p.has) return 0.0f;
  const bool has_v = v >= 0;
  // select-sum over the value vocabulary: 0 plus the one matching entry
  const float cur = (v >= 0 && v < V) ? 0.0f + p.used[v] : 0.0f;
  if (p.targeted) {
    const float boost =
        ((desired - (cur + 1.0f)) / fmaxf(desired, 1e-9f)) * p.w;
    return (!has_v || desired <= 0.f) ? -1.0f : boost;
  }
  if (!p.anyp) return 0.0f;
  const float delta = (p.minc - cur) / fmaxf(p.minc, 1e-9f);
  return !has_v ? -1.0f : (cur != p.minc ? delta : p.even);
}

__device__ __forceinline__ bool dev_fit_at(const WaveArgs& a, int g, int n) {
  bool fit = true;
  for (int d = 0; d < a.D; ++d) {
    fit = fit && ((a.dev_used[(size_t)n * a.D + d] + a.dev_ask[g * a.D + d])
                  <= a.dev_cap[(size_t)n * a.D + d]);
  }
  return fit;
}

// Score of one (group, node) pair from its loaded inputs; adds the pair's
// counter contributions to c.  u / av are the node's used / avail rows,
// rc / rm its reserved cpu / memory, ask the group's resource ask.
template <int R>
__device__ __forceinline__ float score_pair(
    const float* u, const float* av, float rc, float rm, const float* ask,
    float ask_desired, bool feas_b, bool dev_fit, bool pen, float aff,
    float jit, float coll, float spread_total, int seed, int* c) {
  bool fit = true;
  float util_cpu = 0.f, util_mem = 0.f, denom_cpu = 0.f, denom_mem = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float after_r = u[r] + ask[r];
    bool fit_r = after_r <= av[r];
    fit = fit && fit_r;
    c[3 + r] += (feas_b && !fit_r) ? 1 : 0;
    if (r == 0) {
      util_cpu = after_r + rc;
      denom_cpu = av[r];
    } else if (r == 1) {
      util_mem = after_r + rm;
      denom_mem = av[r];
    }
  }
  bool placeable = feas_b && fit && dev_fit;
  c[0] += feas_b ? 1 : 0;
  c[1] += (feas_b && !(fit && dev_fit)) ? 1 : 0;
  c[2] += placeable ? 1 : 0;

  bool ok_denoms = (denom_cpu > 0.f) && (denom_mem > 0.f);
  float free_cpu = 1.0f - util_cpu / fmaxf(denom_cpu, 1.0f);
  float free_mem = 1.0f - util_mem / fmaxf(denom_mem, 1.0f);
  float raw = 20.0f - (powf(10.0f, free_cpu) + powf(10.0f, free_mem));
  float binpack = ok_denoms ? fminf(fmaxf(raw, 0.0f), 18.0f) / 18.0f : 0.0f;

  float anti = coll > 0.f ? -(coll + 1.0f) / ask_desired : 0.0f;
  float anti_count = coll > 0.f ? 1.0f : 0.0f;
  float spread_count = spread_total != 0.0f ? 1.0f : 0.0f;
  float pen_score = pen ? -1.0f : 0.0f;
  float n_scorers = 1.0f + anti_count + (pen ? 1.0f : 0.0f)
                    + (aff != 0.0f ? 1.0f : 0.0f) + spread_count;
  float total = ((((binpack + anti) + pen_score) + aff) + spread_total)
                / n_scorers;
  if (seed != 0) total = floorf(total / SCORE_BIN_F) * SCORE_BIN_F;
  total = total + jit;
  return placeable ? total : NEG_INF_F;
}

// Block sum of per-thread counters for up to SCORE_MAX_GB groups: warp
// sums (one __reduce_add_sync a slot), then the warps' sums in shared
// memory, then per block, group and slot ONE atomicAdd into a.cnt or, with
// `out`, one plain store of the block's sum (out[group * cnt + slot]).
// red holds [SCORE_MAX_GB][MAX_CNT][32 warps]; every thread of the block
// calls warp_counters for each group slot, then block_counters once.
__device__ __forceinline__ void warp_counters(int* red, int gi, int cnt,
                                              const int* c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < cnt; ++k) {
    int v = __reduce_add_sync(FULL_MASK, c[k]);
    if (lane == 0) red[(gi * MAX_CNT + k) * 32 + warp] = v;
  }
}

__device__ __forceinline__ void block_counters(const WaveArgs& a,
                                               const int* red, int g0,
                                               int n_groups, int cnt,
                                               int32_t* out) {
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  for (int t = threadIdx.x; t < n_groups * cnt; t += blockDim.x) {
    const int gi = t / cnt, k = t % cnt;
    int v = 0;
    for (int w = 0; w < n_warps; ++w) v += red[(gi * MAX_CNT + k) * 32 + w];
    if (out != nullptr) {
      out[gi * cnt + k] = v;
    } else if (v != 0) {
      atomicAdd(&a.cnt[(g0 + gi) * cnt + k], v);
    }
  }
}

// ------------------------------------------------------ bounds check
// A test build (-DNOMAD_WAVE_BOUNDS_CHECK, tests/test_torch_wave_kernel_gpu.py)
// checks each read of the score kernel's planes at the load itself: a
// read of elements [i, i + cnt) of a plane of n elements that reaches
// past n is counted in `nomad_wave_oob_reads` and not made.  n passes an
// asm move, so the compiler cannot fold the check into the lane count
// that guards the read.  The default build compiles IN_PLANE to true.
#ifdef NOMAD_WAVE_BOUNDS_CHECK
__device__ unsigned int nomad_wave_oob_reads;

__device__ __forceinline__ bool in_plane(size_t i, int cnt, size_t n) {
  size_t m;
  asm volatile("mov.b64 %0, %1;" : "=l"(m) : "l"(n));
  if (i + (size_t)cnt <= m) return true;
  atomicAdd(&nomad_wave_oob_reads, 1u);
  return false;
}
#define IN_PLANE(i, cnt, n) in_plane((i), (cnt), (n))

// the reads counted since the last call, and the count zeroed
extern "C" int nomad_wave_oob_take(unsigned int* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, nomad_wave_oob_reads,
                                       sizeof(unsigned int));
  if (e != cudaSuccess) return (int)e;
  const unsigned int zero = 0;
  return (int)cudaMemcpyToSymbol(nomad_wave_oob_reads, &zero,
                                 sizeof(unsigned int));
}
#else
#define IN_PLANE(i, cnt, n) true
#endif

// ---------------------------------------------------------- score mode
// Four consecutive f32 / i16 values at element i of a plane of n
// elements; nv of them exist (the ragged end of the node axis); vec:
// 16-byte (8-byte) loads.
__device__ __forceinline__ float4 ld4(const float* p, size_t i, int nv,
                                      bool vec, size_t n) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec && nv == 4) {
    if (IN_PLANE(i, 4, n))
      r = __ldg(reinterpret_cast<const float4*>(p + i));
    return r;
  }
  if (nv > 0 && IN_PLANE(i, 1, n)) r.x = p[i];
  if (nv > 1 && IN_PLANE(i, 2, n)) r.y = p[i + 1];
  if (nv > 2 && IN_PLANE(i, 3, n)) r.z = p[i + 2];
  if (nv > 3 && IN_PLANE(i, 4, n)) r.w = p[i + 3];
  return r;
}

__device__ __forceinline__ short4 ld4s(const int16_t* p, size_t i, int nv,
                                       bool vec, size_t n) {
  short4 r = make_short4(-1, -1, -1, -1);
  if (vec && nv == 4) {
    if (IN_PLANE(i, 4, n))
      r = __ldg(reinterpret_cast<const short4*>(p + i));
    return r;
  }
  if (nv > 0 && IN_PLANE(i, 1, n)) r.x = p[i];
  if (nv > 1 && IN_PLANE(i, 2, n)) r.y = p[i + 1];
  if (nv > 2 && IN_PLANE(i, 3, n)) r.z = p[i + 2];
  if (nv > 3 && IN_PLANE(i, 4, n)) r.w = p[i + 3];
  return r;
}

__device__ __forceinline__ float f4at(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ int s4at(const short4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// The warp's packed mask word for this lane's four nodes: lanes 0..3 load
// the warp's four words (128 nodes), the lanes take theirs by shuffle, and
// the lane's four bits are returned in bits 0..3.
__device__ __forceinline__ uint32_t lane_bits(const int32_t* words,
                                              const WaveArgs& a, int g,
                                              int word0) {
  const int lane = threadIdx.x & 31;
  uint32_t w = 0;
  if (words != nullptr && lane < 4 && word0 + lane < a.W32)
    w = (uint32_t)__ldg(words + (size_t)g * a.W32 + word0 + lane);
  w = __shfl_sync(FULL_MASK, w, lane >> 3);
  return (w >> ((lane & 7) * 4)) & 0xfu;
}

// wave_score_kernel: replaces the score mode of `_wave_tile_kernel`
// (pallas_kernel.py:385, store :539-541).
//   Bound: bytes (8.9 us at Gp 128, Np 10,240).
//   Measured: ~37 us cold, ~28 us warm at the main path's shape, at ~100
//   registers a thread (see the file's head for what holds it).
//   Design: a block owns a stripe of 1,024 nodes (4 a thread) for GB
//   consecutive groups.  The node rows ([Np, R] used / avail, reserved
//   cpu / mem) are loaded once into registers (float4 rows when R = 4)
//   and reused for all GB groups.  The [Gp, Np] planes and the score go
//   16 bytes a thread (8 for the i16 value ranks), neighbouring threads on
//   neighbouring nodes; each mask word is read once per warp and spread by
//   shuffle.  Counters are summed in registers over the thread's nodes,
//   across the warp and across the block, and folded in with one atomic
//   per block, group and slot.  The plan picks GB so the whole grid fits
//   in one round of two blocks an SM (the most ~100 registers allow):
//   260 blocks at the main path's shape; 320 blocks (GB = 4) ran slower,
//   a second round of stragglers after the first.  Plain loads with that
//   many in flight keep the memory system busy, so neither cp.async nor
//   TMA is used (no tile is reused from shared memory; there is no
//   product for wgmma).
template <int R>
__global__ void __launch_bounds__(SCORE_THREADS)
wave_score_kernel(WaveArgs a, int GB, float* __restrict__ score) {
  __shared__ int red[SCORE_MAX_GB * MAX_CNT * 32];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n0 = blockIdx.x * SCORE_STRIPE + tid * SCORE_NODES;
  // nodes of this lane's quad (0 past the node axis).  Not written as
  // max(0, min(SCORE_NODES, rem)): built with nvcc (-O3, sm_90a) that
  // form let the first lane past a node axis ending inside a stripe read
  // the four floats after each plane (an illegal address whenever a
  // plane ended a segment of the allocator: mesh shards of 2,560 and 640
  // nodes did).  The bounds-check build counts those reads at every
  // ragged width (test_score_kernel_reads_stay_in_the_planes).
  const int rem = a.Np - n0;
  const int nv = rem >= SCORE_NODES ? SCORE_NODES : (rem > 0 ? rem : 0);
  const int word0 = (blockIdx.x * SCORE_STRIPE + warp * 128) >> 5;
  const int g0 = blockIdx.y * GB;
  const int n_groups = min(GB, a.Gp - g0);
  const bool vec = a.vec != 0;
  // elements of a [Np, R] node plane, a [Gp, Np] plane and the spread
  // planes [S, Gp, Np] (for the bounds-check build)
  const size_t n_rows = (size_t)a.Np * R, n_plane = (size_t)a.Gp * a.Np,
               n_spread = n_plane * a.S;

  float u[SCORE_NODES][R], av[SCORE_NODES][R], rc[SCORE_NODES],
      rm[SCORE_NODES];
#pragma unroll
  for (int k = 0; k < SCORE_NODES; ++k) {
    const size_t row = (size_t)(n0 + k) * R;
    if constexpr (R == 4) {
      if (k < nv && a.node_vec && IN_PLANE(row, 4, n_rows)) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(a.used + row));
        const float4 y =
            __ldg(reinterpret_cast<const float4*>(a.avail + row));
        const float4 z =
            __ldg(reinterpret_cast<const float4*>(a.reserved + row));
        u[k][0] = x.x; u[k][1] = x.y; u[k][2] = x.z; u[k][3] = x.w;
        av[k][0] = y.x; av[k][1] = y.y; av[k][2] = y.z; av[k][3] = y.w;
        rc[k] = z.x;
        rm[k] = z.y;
        continue;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in = k < nv && IN_PLANE(row, r + 1, n_rows);
      u[k][r] = in ? __ldg(a.used + row + r) : 0.f;
      av[k][r] = in ? __ldg(a.avail + row + r) : 0.f;
    }
    rc[k] = k < nv && IN_PLANE(row, 1, n_rows) ? __ldg(a.reserved + row)
                                               : 0.f;
    rm[k] = k < nv && IN_PLANE(row, 2, n_rows) ? __ldg(a.reserved + row + 1)
                                               : 0.f;
  }

  for (int gi = 0; gi < n_groups; ++gi) {
    const int g = g0 + gi;
    const size_t gn = (size_t)g * a.Np + n0;
    float ask[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ask[r] = __ldg(a.ask_res + g * R + r);
    const float ask_des = __ldg(a.ask_desired + g);
    const uint32_t fb = lane_bits(a.feas, a, g, word0)
                        & ~lane_bits(a.blocked, a, g, word0);
    const uint32_t pb = lane_bits(a.pen, a, g, word0);
    const float4 aff = ld4(a.aff, gn, nv, vec, n_plane);
    const float4 jit = ld4(a.jitter, gn, nv, vec, n_plane);
    const float4 coll = ld4(a.coll, gn, nv, vec, n_plane);
    float spread[SCORE_NODES] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = 0; s < a.S; ++s) {
      const size_t sgn = ((size_t)s * a.Gp + g) * a.Np + n0;
      const short4 v = ld4s(a.sp_vnode, sgn, nv, vec, n_spread);
      const float4 des = ld4(a.sp_des, sgn, nv, vec, n_spread);
      const SpreadParams sp = spread_params(a, g, s);
#pragma unroll
      for (int k = 0; k < SCORE_NODES; ++k)
        spread[k] = spread[k]
                    + spread_contrib(sp, a.V, s4at(v, k), f4at(des, k));
    }
    // every lane scores all four slots; a slot past the node axis is
    // infeasible (NEG_INF, counts nothing), so the loop has no branch
    int c[3 + R];
#pragma unroll
    for (int k = 0; k < 3 + R; ++k) c[k] = 0;
    float out[SCORE_NODES];
#pragma unroll
    for (int k = 0; k < SCORE_NODES; ++k) {
      const bool feas_k = k < nv && ((fb >> k) & 1u);
      const bool dfit = feas_k && a.D > 0 ? dev_fit_at(a, g, n0 + k) : true;
      out[k] = score_pair<R>(u[k], av[k], rc[k], rm[k], ask, ask_des,
                             feas_k, dfit, ((pb >> k) & 1u) != 0,
                             f4at(aff, k), f4at(jit, k), f4at(coll, k),
                             spread[k], a.seed, c);
    }
    // A lane past the node axis must not reach the stores at all: on the
    // H100 (nvcc 12.8, -O3) the form `if (vec && nv == 4) ... else if
    // (nv > 0) ...` let the first such lane of a partly filled warp store
    // its NEG_INF quad over the next row's first four scores, racing with
    // that row's block; the outer `if (nv > 0)` keeps it out.
    if (nv > 0) {
      float* dst = score + gn;
      if (vec && nv == 4) {
        __stcs(reinterpret_cast<float4*>(dst),
               make_float4(out[0], out[1], out[2], out[3]));
      } else {
#pragma unroll
        for (int k = 0; k < SCORE_NODES; ++k)
          if (k < nv) dst[k] = out[k];
      }
    }
    warp_counters(red, gi, 3 + R, c);
  }
  block_counters(a, red, g0, n_groups, 3 + R, nullptr);
}

// ----------------------------------------------------------- topk mode
// Order key of an entry: (score desc, column asc) as one unsigned 64-bit
// value, larger = better.  The high word is the float's bits made
// monotone (after + 0.0f, so -0.0 and 0.0 are one key as in the float
// compares of the reference); the low word is ~column.  Columns are
// unique, so keys are unique and any correct selection gives lax.top_k's
// order exactly.
__device__ __forceinline__ uint32_t ord_of(float s) {
  uint32_t b = __float_as_uint(s + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float score_of(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ unsigned long long key_of(uint32_t ord,
                                                     int col) {
  return ((unsigned long long)ord << 32) | (uint32_t)(~(uint32_t)col);
}

struct TopkArgs {
  int n_tiles, TKt, Vs, TKvt;
  unsigned long long* part;   // [Gp, n_tiles, TKt] keys
  unsigned long long* vpart;  // [Vs + 1, Gp, n_tiles, TKvt] keys
  int32_t* tcnt;              // [Gp, n_tiles, 3 + R] tile counter sums
};

// wave_topk_kernel: replaces the topk mode of `_wave_tile_kernel`
// (pallas_kernel.py:543-551, `_extract_topk` :370) and its per-value
// tables (`want_tables`, :553-563).
//   Bound: 1.3 MB at Gp 4 (0.4 us); in practice the latency of the chain
//   of dependent steps in a block.  The TPU kernel pops one entry per
//   step, 128 + 5 x 8 pops; here that would be ~340 block barriers.
//   Design: no pop loop.  Each thread scores its node and keeps (order
//   key, class) in shared memory; after one barrier it counts, by T
//   broadcast reads, the entries of the tile that beat it (its rank) and
//   those of its own class that beat it (its class rank), and writes
//   itself to slot `rank` if that is below the partial's width.
//   A class table is the top of where(in_class, score, NEG_INF): its head
//   is the class's placeable entries in main order (slot = class rank),
//   its tail every other entry at NEG_INF in column order, so an entry
//   that is tail in class c has slot H_c + i - P_c(i) (H_c: the class's
//   head count, P_c(i): heads before column i), found with one ballot
//   per class and warp.  Tiles are 256 nodes, so Gp = 4 and Np = 10,240
//   give 160 blocks for the 132 SMs.
template <int R>
__global__ void __launch_bounds__(TOPK_TILE)
wave_topk_kernel(WaveArgs a, TopkArgs t) {
  __shared__ int red[MAX_CNT * 32];
  __shared__ uint2 ent[TOPK_TILE];          // (order key, class)
  __shared__ int whead[TOPK_TILE / 32][17]; // heads per warp and class
  const int tile = blockIdx.x, g = blockIdx.y, i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const int base = tile * TOPK_TILE;
  const int Tt = min(TOPK_TILE, a.Np - base);
  const int n = base + i;
  const bool valid = i < Tt;
  const bool tables = t.Vs > 0;

  // a thread past the node axis scores node `nn` = 0 as infeasible (NEG_INF,
  // counts nothing), so no branch separates the lanes of a warp
  const int nn = valid ? n : 0;
  int c[3 + R];
#pragma unroll
  for (int k = 0; k < 3 + R; ++k) c[k] = 0;
  float u[R], av[R], ask[R];
  const size_t row = (size_t)nn * R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    u[r] = __ldg(a.used + row + r);
    av[r] = __ldg(a.avail + row + r);
    ask[r] = __ldg(a.ask_res + g * R + r);
  }
  const size_t gn = (size_t)g * a.Np + nn;
  const int word = (int)((size_t)g * a.W32 + (nn >> 5));
  const uint32_t bit = 1u << (nn & 31);
  bool feas_b = valid && ((uint32_t)__ldg(a.feas + word) & bit) != 0;
  if (a.blocked)
    feas_b = feas_b && !((uint32_t)__ldg(a.blocked + word) & bit);
  const bool pen = ((uint32_t)__ldg(a.pen + word) & bit) != 0;
  float spread = 0.0f;
  for (int s = 0; s < a.S; ++s) {
    const size_t sgn = ((size_t)s * a.Gp + g) * a.Np + nn;
    spread = spread + spread_contrib(spread_params(a, g, s), a.V,
                                     a.sp_vnode[sgn], __ldg(a.sp_des + sgn));
  }
  const float sc = score_pair<R>(
      u, av, __ldg(a.reserved + row), __ldg(a.reserved + row + 1), ask,
      __ldg(a.ask_desired + g), feas_b,
      feas_b && a.D > 0 ? dev_fit_at(a, g, nn) : true, pen,
      __ldg(a.aff + gn), __ldg(a.jitter + gn), __ldg(a.coll + gn), spread,
      a.seed, c);
  uint32_t cls = NO_CLASS;
  if (tables && valid) {
    const int v = a.sp_vnode[gn];       // value plane of constraint 0
    cls = v < 0 ? (uint32_t)t.Vs : (v < t.Vs ? (uint32_t)v : NO_CLASS);
  }
  warp_counters(red, 0, 3 + R, c);
  const uint32_t ord = ord_of(sc);
  ent[i] = make_uint2(ord, cls);
  // the tile's counter sums; the merge adds them up (no atomics, and no
  // zeroing launch before this kernel).  The barrier publishes ent.
  block_counters(a, red, g, 1, 3 + R,
                 t.tcnt + ((size_t)g * t.n_tiles + tile) * (3 + R));

  // ranks by counting: column order is thread order, so an entry j
  // before i beats it on ord_j >= ord_i, one after it on ord_j > ord_i
  int rank = 0, crank = 0;
  if (valid) {
    for (int j = 0; j < i; ++j) {
      const uint2 e = ent[j];
      const int b = e.x >= ord ? 1 : 0;
      rank += b;
      crank += (e.y == cls) ? b : 0;
    }
    for (int j = i + 1; j < Tt; ++j) {
      const uint2 e = ent[j];
      const int b = e.x > ord ? 1 : 0;
      rank += b;
      crank += (e.y == cls) ? b : 0;
    }
    if (rank < t.TKt)
      t.part[((size_t)g * t.n_tiles + tile) * t.TKt + rank] = key_of(ord, n);
  }
  if (!tables) return;

  // class tables: heads per class and warp, then each entry's slots
  const uint32_t ord_neg = ord_of(NEG_INF_F);
  const bool head = valid && cls != NO_CLASS && ord != ord_neg;
  for (int cc = 0; cc <= t.Vs; ++cc) {
    const uint32_t m = __ballot_sync(FULL_MASK, head && cls == (uint32_t)cc);
    if (lane == 0) whead[warp][cc] = __popc(m);
  }
  __syncthreads();
  const uint32_t lt = (1u << lane) - 1u;
  for (int cc = 0; cc <= t.Vs; ++cc) {
    const uint32_t m = __ballot_sync(FULL_MASK, head && cls == (uint32_t)cc);
    int before = __popc(m & lt), total = 0;
    for (int w = 0; w < TOPK_TILE / 32; ++w) {
      const int h = whead[w][cc];
      total += h;
      before += w < warp ? h : 0;
    }
    if (!valid) continue;
    const size_t row = (((size_t)cc * a.Gp + g) * t.n_tiles + tile) * t.TKvt;
    if (head && cls == (uint32_t)cc) {
      if (crank < t.TKvt) t.vpart[row + crank] = key_of(ord, n);
    } else {
      const int slot = total + i - before;
      if (slot < t.TKvt) t.vpart[row + slot] = key_of(ord_neg, n);
    }
  }
}

struct MergeArgs {
  int Gp, Np, n_tiles, NE, TKt, Vs, TKv, TKvt, batch, CNT;
  const unsigned long long* part;
  const unsigned long long* vpart;
  const int32_t* tcnt;  // [Gp, n_tiles, CNT] tile counter sums
  int32_t* cnt;         // [Gp, CNT]
  float* top_s;         // [Gp, NE]
  int32_t* top_i;
  float* tab_s;         // [Gp, Vs + 1, TKv]
  int32_t* tab_i;
};

// Top-Kw merge of two descending lists of unique keys, in one warp's
// registers: lane j holds elements j, j + 32, ... (E = Kw / 32 of them).
// C[e] = max(A[e], B[Kw-1-e]) keeps exactly the Kw best keys of A and B
// (the half-cleaner of a bitonic merge of A with B reversed) and is
// bitonic, so log2(Kw) half-cleaner stages sort it: strides >= 32 pair
// registers of a lane, strides < 32 pair lanes (shfl_xor).  Short lists
// read as 0, which every real key beats, so a merged list's first
// min(Kw, la + lb) keys are its real ones.  The loads and stores of a
// lane are to consecutive addresses: no bank conflict, no search.
template <int E>
__device__ __forceinline__ void merge_top(const unsigned long long* A,
                                          int la,
                                          const unsigned long long* B,
                                          int lb, unsigned long long* D) {
  constexpr int Kw = 32 * E;
  const int lane = threadIdx.x & 31;
  unsigned long long c[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int e = 32 * r + lane, eb = Kw - 1 - e;
    const unsigned long long x = e < la ? A[e] : 0ull;
    const unsigned long long y = eb < lb ? B[eb] : 0ull;
    c[r] = x > y ? x : y;
  }
#pragma unroll
  for (int s = Kw / 2; s >= 32; s >>= 1) {      // within a lane
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int q = r ^ (s / 32);
      if (q > r) {
        const unsigned long long hi = c[r] > c[q] ? c[r] : c[q];
        const unsigned long long lo = c[r] > c[q] ? c[q] : c[r];
        c[r] = hi;
        c[q] = lo;
      }
    }
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {            // across lanes
    const bool upper = (lane & s) == 0;         // keeps the larger key
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const unsigned long long o = __shfl_xor_sync(FULL_MASK, c[r], s);
      c[r] = (upper == (c[r] > o)) ? c[r] : o;
    }
  }
#pragma unroll
  for (int r = 0; r < E; ++r) D[32 * r + lane] = c[r];
}

// wave_merge_kernel: replaces the merge of the tile partials that follows
// the pallas_call (lax.top_k over the partials, pallas_kernel.py:333-361,
// with its padding :338-343) and the sum of the tile counters (:362).
//   Bound: bytes, the partial keys (~40 KB per group at NE = 128) read
//   once from L2; in practice the depth of the merge.
//   Design: one block per (group, list): the main list and each class
//   table.  The lists of `batch` tiles and the running result merge
//   pairwise in shared memory, one warp per pair (`merge_top`, a bitonic
//   top-Kw merge in registers), log2(batch + 1) levels of one barrier
//   each; Kw = 32 E is the output width rounded up to a power of two, at
//   least 32.  A first version ranked every key by binary search in the
//   other list; its random 8-byte probes held each level to the rate of
//   shared-memory wavefronts, several times slower on the H100.  The
//   plan picks `batch` so that the two buffers fit (all 40 tiles of the
//   main path in one batch).  Places past the real entries get the
//   reference's (NEG_INF, 0) padding.  One block a group also adds up the
//   group's tile counters.
template <int E>
__global__ void __launch_bounds__(MERGE_THREADS)
wave_merge_kernel(MergeArgs m) {
  constexpr int Kw = 32 * E;
  extern __shared__ unsigned long long buf[];
  const int g = blockIdx.x, list = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, n_warps = blockDim.x >> 5;
  const bool main_list = list == 0;
  const int K = main_list ? m.NE : m.TKv;
  const int L = main_list ? m.TKt : m.TKvt;
  const int slots = m.batch + 1;
  unsigned long long* src = buf;
  unsigned long long* dst = buf + (size_t)slots * Kw;
  int* len_src = reinterpret_cast<int*>(buf + 2 * (size_t)slots * Kw);
  int* len_dst = len_src + slots;
  const unsigned long long* part =
      main_list ? m.part + (size_t)g * m.n_tiles * L
                : m.vpart + ((size_t)(list - 1) * m.Gp + g) * m.n_tiles * L;

  // warp k of one block a group sums counter slot k over the tiles (a
  // table block where there are tables: they finish well before the main
  // list's)
  if (list == (m.Vs > 0 ? 1 : 0) && warp < m.CNT) {
    const int lane = tid & 31;
    int v = 0;
    for (int t = lane; t < m.n_tiles; t += 32)
      v += m.tcnt[((size_t)g * m.n_tiles + t) * m.CNT + warp];
    v = __reduce_add_sync(FULL_MASK, v);
    if (lane == 0) m.cnt[g * m.CNT + warp] = v;
  }
  if (tid == 0) len_src[0] = 0;
  for (int t0 = 0; t0 < m.n_tiles; t0 += m.batch) {
    const int nb = min(m.batch, m.n_tiles - t0);
    // the batch's lists, all threads over all keys; the loop is unrolled
    // so a thread's loads are in flight together
#pragma unroll 8
    for (int e = tid; e < nb * L; e += blockDim.x) {
      const int tt = e / L, i = e - tt * L;
      if (i < min(L, m.Np - (t0 + tt) * TOPK_TILE))
        src[(size_t)(1 + tt) * Kw + i] = part[(size_t)t0 * L + e];
    }
    for (int tt = tid; tt < nb; tt += blockDim.x)
      len_src[1 + tt] = min(L, m.Np - (t0 + tt) * TOPK_TILE);
    __syncthreads();
    for (int nl = nb + 1; nl > 1; nl = (nl + 1) >> 1) {
      for (int p = warp; 2 * p < nl; p += n_warps) {
        const int lb = 2 * p + 1 < nl ? len_src[2 * p + 1] : 0;
        merge_top<E>(src + (size_t)(2 * p) * Kw, len_src[2 * p],
                     src + (size_t)(2 * p + 1) * Kw, lb,
                     dst + (size_t)p * Kw);
        if ((tid & 31) == 0) len_dst[p] = min(Kw, len_src[2 * p] + lb);
      }
      __syncthreads();
      unsigned long long* tb = src; src = dst; dst = tb;
      int* tl = len_src; len_src = len_dst; len_dst = tl;
    }
  }
  float* out_s = main_list ? m.top_s + (size_t)g * K
                           : m.tab_s + ((size_t)g * (m.Vs + 1) + list - 1) * K;
  int32_t* out_i = main_list ? m.top_i + (size_t)g * K
                             : m.tab_i + ((size_t)g * (m.Vs + 1) + list - 1) * K;
  const int len = len_src[0];
  for (int i = tid; i < K; i += blockDim.x) {
    if (i < len) {
      const unsigned long long key = src[i];
      out_s[i] = score_of((uint32_t)(key >> 32));
      out_i[i] = (int32_t)~(uint32_t)key;
    } else {
      out_s[i] = NEG_INF_F;
      out_i[i] = 0;
    }
  }
}

// ------------------------------------------------------------- launch
template <int E>
static int launch_merge(const MergeArgs& m, int smem, cudaStream_t st) {
  // the dynamic shared-memory limit is a per-device attribute: set it on
  // each device the merge runs on (shards of a mesh may span cards)
  constexpr int MAX_DEVICES = 64;
  static int smem_set[MAX_DEVICES] = {};   // per instantiation and device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(
        wave_merge_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = smem;
  }
  dim3 grid(m.Gp, m.Vs > 0 ? m.Vs + 2 : 1);
  wave_merge_kernel<E><<<grid, MERGE_THREADS, smem, st>>>(m);
  return (int)cudaGetLastError();
}

template <int R>
static int launch_r(int mode, const WaveArgs& a, int GB, float* score,
                    const TopkArgs& t, cudaStream_t st) {
  if (mode == 0) {
    dim3 grid((a.Np + SCORE_STRIPE - 1) / SCORE_STRIPE,
              (a.Gp + GB - 1) / GB);
    wave_score_kernel<R><<<grid, SCORE_THREADS, 0, st>>>(a, GB, score);
  } else {
    dim3 grid(t.n_tiles, a.Gp);
    wave_topk_kernel<R><<<grid, TOPK_TILE, 0, st>>>(a, t);
  }
  return (int)cudaGetLastError();
}

static bool aligned(const void* p, size_t b) {
  return p == nullptr || ((uintptr_t)p % b) == 0;
}

// mode 0: score (a zeroing memset, then the kernel); 1: topk (tile kernel,
// then the merge); 2: the merge alone on the partials a mode-1 launch left
// (chip_smoke.py times it so).
// Geometry (T, GB, batch, merge_width, merge_smem) comes from wave_kernel.py
// `launch_plan`.  Returns a cudaError_t; no kernel runs when the
// arguments are refused.
extern "C" int nomad_wave_launch(
    int mode, const void* feas, const void* pen, const void* blocked,
    const void* aff, const void* jitter, const void* coll, const void* used,
    const void* avail, const void* reserved, const void* ask_res,
    const void* ask_desired, const void* dev_used, const void* dev_cap,
    const void* dev_ask, const void* sp_vnode, const void* sp_des,
    const void* sp_used, const void* sp_w, const void* sp_t,
    const void* sp_has, const void* minc, const void* maxc, const void* anyp,
    int Gp, int Np, int R, int D, int S, int V, int seed, void* cnt,
    void* score, void* part, void* vpart, void* tcnt, void* top_s,
    void* top_i, void* tab_s, void* tab_i, int T, int GB, int NE, int TKt, int Vs,
    int TKv, int TKvt, int batch, int merge_width, int merge_smem,
    void* stream) {
  if (R > MAX_R || R < 2 || Gp < 1 || Np < 1) return (int)cudaErrorInvalidValue;
  if (mode == 0 && (GB < 1 || GB > SCORE_MAX_GB))
    return (int)cudaErrorInvalidValue;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (mode != 0 && (T != TOPK_TILE || Vs > 16 || batch < 1 || NE < 1
                    || merge_width < 32 || merge_width > 1024
                    || (merge_width & (merge_width - 1)) != 0
                    || merge_width < NE || merge_width < TKv))
    return (int)cudaErrorInvalidValue;
  WaveArgs a;
  a.feas = (const int32_t*)feas;
  a.pen = (const int32_t*)pen;
  a.blocked = (const int32_t*)blocked;
  a.aff = (const float*)aff;
  a.jitter = (const float*)jitter;
  a.coll = (const float*)coll;
  a.used = (const float*)used;
  a.avail = (const float*)avail;
  a.reserved = (const float*)reserved;
  a.ask_res = (const float*)ask_res;
  a.ask_desired = (const float*)ask_desired;
  a.dev_used = (const float*)dev_used;
  a.dev_cap = (const float*)dev_cap;
  a.dev_ask = (const float*)dev_ask;
  a.sp_vnode = (const int16_t*)sp_vnode;
  a.sp_des = (const float*)sp_des;
  a.sp_used = (const float*)sp_used;
  a.sp_w = (const float*)sp_w;
  a.sp_t = (const int8_t*)sp_t;
  a.sp_has = (const int8_t*)sp_has;
  a.minc = (const float*)minc;
  a.maxc = (const float*)maxc;
  a.anyp = (const int8_t*)anyp;
  a.Gp = Gp;
  a.Np = Np;
  a.W32 = (Np + 31) / 32;
  a.R = R;
  a.D = D;
  a.S = S;
  a.V = V;
  a.seed = seed;
  a.vec = (Np % 4 == 0) && aligned(aff, 16) && aligned(jitter, 16)
          && aligned(coll, 16) && aligned(sp_des, 16) && aligned(score, 16)
          && aligned(sp_vnode, 8);
  a.node_vec = aligned(used, 16) && aligned(avail, 16)
               && aligned(reserved, 16);
  a.cnt = (int32_t*)cnt;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  TopkArgs t;
  t.n_tiles = (Np + TOPK_TILE - 1) / TOPK_TILE;
  t.TKt = TKt;
  t.Vs = Vs;
  t.TKvt = TKvt;
  t.part = (unsigned long long*)part;
  t.vpart = (unsigned long long*)vpart;
  t.tcnt = (int32_t*)tcnt;
  if (mode == 0) {          // score mode folds its counters in atomically
    e = cudaMemsetAsync(cnt, 0, sizeof(int32_t) * Gp * (3 + R), st);
    if (e != cudaSuccess) return (int)e;
  }
  if (mode != 2) {
    int rc;
    switch (R) {
      case 2: rc = launch_r<2>(mode, a, GB, (float*)score, t, st); break;
      case 3: rc = launch_r<3>(mode, a, GB, (float*)score, t, st); break;
      case 4: rc = launch_r<4>(mode, a, GB, (float*)score, t, st); break;
      case 5: rc = launch_r<5>(mode, a, GB, (float*)score, t, st); break;
      case 6: rc = launch_r<6>(mode, a, GB, (float*)score, t, st); break;
      case 7: rc = launch_r<7>(mode, a, GB, (float*)score, t, st); break;
      default: rc = launch_r<8>(mode, a, GB, (float*)score, t, st); break;
    }
    if (rc != 0 || mode == 0) return rc;
  }

  MergeArgs m;
  m.Gp = Gp;
  m.Np = Np;
  m.n_tiles = t.n_tiles;
  m.NE = NE;
  m.TKt = TKt;
  m.Vs = Vs;
  m.TKv = TKv;
  m.TKvt = TKvt;
  m.batch = batch;
  m.CNT = 3 + R;
  m.tcnt = (const int32_t*)tcnt;
  m.cnt = (int32_t*)cnt;
  m.part = (const unsigned long long*)part;
  m.vpart = (const unsigned long long*)vpart;
  m.top_s = (float*)top_s;
  m.top_i = (int32_t*)top_i;
  m.tab_s = (float*)tab_s;
  m.tab_i = (int32_t*)tab_i;
  switch (merge_width) {
    case 32: return launch_merge<1>(m, merge_smem, st);
    case 64: return launch_merge<2>(m, merge_smem, st);
    case 128: return launch_merge<4>(m, merge_smem, st);
    case 256: return launch_merge<8>(m, merge_smem, st);
    case 512: return launch_merge<16>(m, merge_smem, st);
    default: return launch_merge<32>(m, merge_smem, st);
  }
}
