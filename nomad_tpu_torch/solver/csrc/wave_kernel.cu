// Fused wave scoring for the placement solve, written for Hopper (sm_90a).
//
// Replaces the TPU kernel nomad_tpu/solver/pallas_kernel.py `fused_wave`
// (body `_wave_tile_kernel`): one pass over every (group, node) pair that
// unpacks the bit-packed feasibility / penalty / blocked planes, computes
// resource and device fit, the bin-pack score, anti-affinity, targeted and
// even spread, the append-then-average normalization in the reference's
// exact summation order, seeded binning and jitter, and the NEG_INF mask,
// together with the per-group explainability counters.
//
//   mode score (wave_score_kernel): writes the [Gp, Np] score plane.
//   mode topk  (wave_topk_kernel):  one block per (node tile, group) keeps
//       the tile's scores in shared memory and extracts its top entries in
//       (score desc, column asc) order, plus, with tables, the top entries
//       of each spread value class; the [Gp, Np] plane never reaches device
//       memory.  The caller merges the tile partials (a stable sort).
//
// Bound: the pass is memory-bound.  Per wave it must read the three f32
// [Gp, Np] planes (affinity, jitter, collocation), the spread planes
// (i16 value ranks, f32 desired counts) and the packed masks, and (score
// mode) write the f32 score plane; the [Np, R] node planes are small and
// stay in L2 across group rows.  The design reads every per-(group, node)
// input exactly once with neighbouring threads on neighbouring nodes, and
// keeps all intermediates in registers (score mode) or shared memory (topk
// mode).  Counters are integer warp sums folded in with atomicAdd, which
// is exact and order-independent.
//
// Numerics: build with -fmad=false and without fast math, so that no
// multiply-add is contracted (XLA does not contract either) and division
// stays IEEE; pow is powf(10.f, x).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NEG_INF_F (-1e30f)
#define EXTRACTED_F (-2e30f)
#define SCORE_BIN_F 0.05f
#define MAX_R 8
#define MAX_CNT (3 + MAX_R)
#define THREADS 256

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
  int32_t* cnt;             // [Gp, 3 + R]: n_feas, n_exh, n_placeable, dim
};

__device__ __forceinline__ bool bit_at(const int32_t* words, int W32, int g,
                                       int n) {
  uint32_t w = (uint32_t)words[(size_t)g * W32 + (n >> 5)];
  return (w >> (n & 31)) & 1u;
}

// Score of one (group, node) pair; adds its counter contributions to c.
__device__ float score_at(const WaveArgs& a, int g, int n, int* c) {
  const size_t gn = (size_t)g * a.Np + n;
  bool feas_b = bit_at(a.feas, a.W32, g, n);
  if (a.blocked) feas_b = feas_b && !bit_at(a.blocked, a.W32, g, n);

  bool fit = true;
  float util_cpu = 0.f, util_mem = 0.f, denom_cpu = 0.f, denom_mem = 0.f;
  for (int r = 0; r < a.R; ++r) {
    float after_r = a.used[(size_t)n * a.R + r] + a.ask_res[g * a.R + r];
    float av = a.avail[(size_t)n * a.R + r];
    bool fit_r = after_r <= av;
    fit = fit && fit_r;
    c[3 + r] += (feas_b && !fit_r) ? 1 : 0;
    if (r == 0) {
      util_cpu = after_r + a.reserved[(size_t)n * a.R + r];
      denom_cpu = av;
    } else if (r == 1) {
      util_mem = after_r + a.reserved[(size_t)n * a.R + r];
      denom_mem = av;
    }
  }
  bool dev_fit = true;
  for (int d = 0; d < a.D; ++d) {
    dev_fit = dev_fit && ((a.dev_used[(size_t)n * a.D + d]
                           + a.dev_ask[g * a.D + d])
                          <= a.dev_cap[(size_t)n * a.D + d]);
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

  float coll = a.coll[gn];
  float anti = coll > 0.f ? -(coll + 1.0f) / a.ask_desired[g] : 0.0f;
  float anti_count = coll > 0.f ? 1.0f : 0.0f;

  float spread_total = 0.0f;
  for (int s = 0; s < a.S; ++s) {
    const size_t sgn = ((size_t)s * a.Gp + g) * a.Np + n;
    const int gs = g * a.S + s;
    int v = a.sp_vnode[sgn];
    bool has_v = v >= 0;
    // select-sum over the value vocabulary: 0 plus the one matching entry
    float cur = 0.0f;
    if (v >= 0 && v < a.V) cur = cur + a.sp_used[(size_t)gs * a.V + v];
    float desired = a.sp_des[sgn];
    float boost = ((desired - (cur + 1.0f)) / fmaxf(desired, 1e-9f))
                  * a.sp_w[gs];
    float targeted = !has_v ? -1.0f : (desired <= 0.f ? -1.0f : boost);
    float minc = a.minc[gs], maxc = a.maxc[gs];
    float delta_boost = (minc - cur) / fmaxf(minc, 1e-9f);
    float even = cur != minc
                     ? delta_boost
                     : (minc == maxc ? -1.0f
                                     : (maxc - minc) / fmaxf(minc, 1e-9f));
    even = !has_v ? -1.0f : even;
    even = a.anyp[gs] != 0 ? even : 0.0f;
    float contrib = a.sp_t[gs] != 0 ? targeted : even;
    spread_total = spread_total + (a.sp_has[gs] != 0 ? contrib : 0.0f);
  }
  float spread_count = spread_total != 0.0f ? 1.0f : 0.0f;

  bool pen = bit_at(a.pen, a.W32, g, n);
  float pen_score = pen ? -1.0f : 0.0f;
  float aff = a.aff[gn];
  float n_scorers = 1.0f + anti_count + (pen ? 1.0f : 0.0f)
                    + (aff != 0.0f ? 1.0f : 0.0f) + spread_count;
  float total = ((((binpack + anti) + pen_score) + aff) + spread_total)
                / n_scorers;
  if (a.seed != 0) total = floorf(total / SCORE_BIN_F) * SCORE_BIN_F;
  total = total + a.jitter[gn];
  return placeable ? total : NEG_INF_F;
}

// Warp sums of the per-thread counters, one atomicAdd per warp and slot.
__device__ void flush_counters(const WaveArgs& a, int g, const int* c) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < 3 + a.R; ++k) {
    int v = __reduce_add_sync(0xffffffffu, c[k]);
    if (lane == 0 && v != 0) atomicAdd(&a.cnt[g * (3 + a.R) + k], v);
  }
}

__global__ void wave_score_kernel(WaveArgs a, float* __restrict__ score) {
  const int g = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  int c[MAX_CNT] = {0};
  if (n < a.Np) score[(size_t)g * a.Np + n] = score_at(a, g, n, c);
  flush_counters(a, g, c);
}

__device__ __forceinline__ bool lex_better(float s, int i, float bs,
                                           int bi) {
  return s > bs || (s == bs && i < bi);
}

// Pops the tile's best (score desc, column asc) entry n_out times from
// work[0, Tt), masking each popped slot with EXTRACTED; untouched NEG_INF
// entries therefore still come out in column order.  Slots n_out..TKt-1
// of the partial are filled with -inf so the merge sorts them last.
__device__ void extract_topk(float* work, int Tt, int n_out, int TKt,
                             int base, float* out_s, int32_t* out_i) {
  __shared__ float ws[THREADS / 32];
  __shared__ int wi[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < n_out; ++j) {
    float bs = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = tid; i < Tt; i += blockDim.x) {
      float s = work[i];
      if (lex_better(s, i, bs, bi)) { bs = s; bi = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      float os = __shfl_down_sync(0xffffffffu, bs, off);
      int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (lex_better(os, oi, bs, bi)) { bs = os; bi = oi; }
    }
    if (lane == 0) { ws[warp] = bs; wi[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      const int nw = blockDim.x >> 5;
      bs = lane < nw ? ws[lane] : -INFINITY;
      bi = lane < nw ? wi[lane] : 0x7fffffff;
      for (int off = 16; off > 0; off >>= 1) {
        float os = __shfl_down_sync(0xffffffffu, bs, off);
        int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (lex_better(os, oi, bs, bi)) { bs = os; bi = oi; }
      }
      if (lane == 0) {
        out_s[j] = bs;
        out_i[j] = base + bi;
        work[bi] = EXTRACTED_F;
      }
    }
    __syncthreads();
  }
  for (int j = n_out + tid; j < TKt; j += blockDim.x) {
    out_s[j] = -INFINITY;
    out_i[j] = 0;
  }
}

// grid (n_tiles, Gp); dynamic shared memory: T floats of work, and with
// tables T floats of scores and T shorts of value ranks.
__global__ void wave_topk_kernel(WaveArgs a, int T, int TKt, int Vs,
                                 int TKvt, float* part_s, int32_t* part_i,
                                 float* vpart_s, int32_t* vpart_i) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int base = tile * T;
  const int Tt = min(T, a.Np - base);
  const bool tables = Vs > 0;
  float* work = smem;
  float* orig = smem + T;
  int16_t* vn = (int16_t*)(smem + 2 * T);

  int c[MAX_CNT] = {0};
  for (int i = tid; i < Tt; i += blockDim.x) {
    float sc = score_at(a, g, base + i, c);
    work[i] = sc;
    if (tables) {
      orig[i] = sc;
      vn[i] = a.sp_vnode[(size_t)g * a.Np + base + i];
    }
  }
  flush_counters(a, g, c);
  __syncthreads();

  const int n_tiles = gridDim.x;
  const size_t P = (size_t)n_tiles * TKt;
  extract_topk(work, Tt, min(TKt, Tt), TKt, base,
               part_s + g * P + (size_t)tile * TKt,
               part_i + g * P + (size_t)tile * TKt);
  if (!tables) return;
  const size_t Pv = (size_t)n_tiles * TKvt;
  for (int vv = 0; vv <= Vs; ++vv) {
    for (int i = tid; i < Tt; i += blockDim.x) {
      bool in_class = vv < Vs ? (vn[i] == vv) : (vn[i] < 0);
      work[i] = in_class ? orig[i] : NEG_INF_F;
    }
    __syncthreads();
    const size_t row = ((size_t)vv * a.Gp + g) * Pv + (size_t)tile * TKvt;
    extract_topk(work, Tt, min(TKvt, Tt), TKvt, base, vpart_s + row,
                 vpart_i + row);
  }
}

extern "C" int nomad_wave_launch(
    int mode, const void* feas, const void* pen, const void* blocked,
    const void* aff, const void* jitter, const void* coll, const void* used,
    const void* avail, const void* reserved, const void* ask_res,
    const void* ask_desired, const void* dev_used, const void* dev_cap,
    const void* dev_ask, const void* sp_vnode, const void* sp_des,
    const void* sp_used, const void* sp_w, const void* sp_t,
    const void* sp_has, const void* minc, const void* maxc, const void* anyp,
    int Gp, int Np, int R, int D, int S, int V, int seed, void* cnt,
    void* score, void* part_s, void* part_i, void* vpart_s, void* vpart_i,
    int T, int TKt, int Vs, int TKvt, void* stream) {
  if (R > MAX_R || R < 2) return (int)cudaErrorInvalidValue;
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
  a.cnt = (int32_t*)cnt;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    dim3 grid((Np + THREADS - 1) / THREADS, Gp);
    wave_score_kernel<<<grid, THREADS, 0, st>>>(a, (float*)score);
  } else {
    dim3 grid((Np + T - 1) / T, Gp);
    size_t smem = (size_t)T * sizeof(float)
                  + (Vs > 0 ? (size_t)T * (sizeof(float) + sizeof(int16_t))
                            : 0);
    wave_topk_kernel<<<grid, THREADS, smem, st>>>(
        a, T, TKt, Vs, TKvt, (float*)part_s, (int32_t*)part_i,
        (float*)vpart_s, (int32_t*)vpart_i);
  }
  return (int)cudaGetLastError();
}
