// Node-segmented reductions of the wave body's same-wave conflict check
// and commits, written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package leaves the same work to XLA:
// above 2,048 placements a wave it sorts the candidates by node, takes a
// cumulative sum over the sorted rows and scatters it back, and commits
// with scatter-adds whose duplicate targets XLA serialises.  On the H100
// PyTorch runs those as a dim-0 scan (a few threads walk every row) and
// accumulating index_puts that sort their indices again, about 1.7 ms a
// wave at 8,192 placements for a few hundred kilobytes.  Two kernels:
//
//   seg_scan_kernel  one block over rows sorted by a key (the wave's one
//                    stable sort): each row's exclusive prefix of `vals`
//                    within its key's segment, written to the row's own
//                    position (the rows' positions are a permutation, so
//                    no scatter accumulates); or its rank in the segment;
//                    or, in commit mode, the segment's sum of vals x
//                    weight added to target[key] by the segment's last
//                    row (one writer a key: no atomics).
//   seg_hist_kernel  counts a wave's commits per cell of a small target
//                    ([Gp, S, V] spread counts, [Gp, C] collocation
//                    counts) in shared memory and adds each count once.
//
// Bound on the H100: latency.  A wave moves under 0.5 MB; the chain of
// dependent steps (a thread's rows, a warp scan, a block scan, the rows
// again) sets the time.  One block of SEG_THREADS threads, each owning a
// run of consecutive sorted rows, needs no second pass across blocks.
//
// Numerics: sums run in double and round once to float.  The values are
// integers (MHz, MB, counts), so every partial sum is exact and the
// result is the exact sum rounded once whatever the order: the same bits
// as a sequential float sum wherever that one is exact, and as the plain
// version (seg_kernel.py), which sums in double too.  Rows outside every
// segment (sort key SEG_NONE, the largest int32, so the end of the sorted
// order) read 0 and write nothing but 0.

#include <cuda_runtime.h>
#include <stdint.h>

#define SEG_THREADS 512
#define SEG_WARPS (SEG_THREADS / 32)
#define SEG_TILE 16
#define HIST_THREADS 1024
#define FULL_MASK 0xffffffffu
#define SEG_NONE 0x7fffffff

// Inclusive segmented scan across a warp of (head seen, sum since it):
// the left operand's sum is dropped where the right one saw a head.
__device__ __forceinline__ void warp_seg_scan(int lane, int& f, double& a) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int fo = __shfl_up_sync(FULL_MASK, f, d);
    const double ao = __shfl_up_sync(FULL_MASK, a, d);
    if (lane >= d) {
      if (!f) a = ao + a;
      f |= fo;
    }
  }
}

// Block-wide exclusive segmented scan of each thread's (flag, agg): the
// sum, since the last segment head, of the rows of all earlier threads.
__device__ __forceinline__ double block_carry(int flag, double agg) {
  __shared__ int s_flag[SEG_WARPS];
  __shared__ double s_sum[SEG_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int f = flag;
  double a = agg;
  warp_seg_scan(lane, f, a);
  int fe = __shfl_up_sync(FULL_MASK, f, 1);
  double ae = __shfl_up_sync(FULL_MASK, a, 1);
  if (lane == 0) {
    fe = 0;
    ae = 0.0;
  }
  if (lane == 31) {
    s_flag[warp] = f;
    s_sum[warp] = a;
  }
  __syncthreads();
  if (warp == 0) {  // the warp totals, scanned by one warp
    int wf = lane < SEG_WARPS ? s_flag[lane] : 0;
    double wa = lane < SEG_WARPS ? s_sum[lane] : 0.0;
    warp_seg_scan(lane, wf, wa);
    double x = __shfl_up_sync(FULL_MASK, wa, 1);
    if (lane == 0) x = 0.0;
    if (lane < SEG_WARPS) s_sum[lane] = x;
  }
  __syncthreads();
  const double carry = fe ? ae : s_sum[warp] + ae;
  __syncthreads();  // s_sum is read before the next column writes it
  return carry;
}

// A tile of up to SEG_TILE consecutive sorted rows of one thread, loaded
// at once so that its loads overlap: the keys, the rows, and bit masks
// of the rows that head a segment, lie in one and carry weight.
struct Tile {
  int32_t k[SEG_TILE];
  int r[SEG_TILE];
  unsigned head, member, live;
};

__device__ __forceinline__ void load_tile(Tile& t, const int32_t* key,
                                          const int64_t* ix,
                                          const bool* weight, int base,
                                          int hi) {
  const int32_t prev = base > 0 ? key[base - 1] : SEG_NONE;
#pragma unroll
  for (int j = 0; j < SEG_TILE; ++j) {
    const bool in = base + j < hi;
    t.k[j] = in ? key[base + j] : SEG_NONE;
    t.r[j] = in ? (int)ix[base + j] : 0;
  }
  t.head = t.member = t.live = 0;
#pragma unroll
  for (int j = 0; j < SEG_TILE; ++j) {
    if (base + j >= hi) break;
    const int32_t before = j == 0 ? prev : t.k[j - 1];
    if (base + j == 0 || before != t.k[j]) t.head |= 1u << j;
    if (t.k[j] != SEG_NONE) {
      t.member |= 1u << j;
      if (weight == nullptr || weight[t.r[j]]) t.live |= 1u << j;
    }
  }
}

// Column c of a tile's rows: vals (1 where vals is null, and in the
// rank column c == nc) on the live rows, 0 elsewhere.
__device__ __forceinline__ void tile_vals(const Tile& t,
                                          const float* vals, int nc, int c,
                                          float* v) {
  const bool ones = c == nc || vals == nullptr;
#pragma unroll
  for (int j = 0; j < SEG_TILE; ++j) {
    const bool on = (t.live >> j) & 1u;
    v[j] = !on ? 0.0f
               : ones ? 1.0f : vals[(int64_t)t.r[j] * nc + c];
  }
}

// Over K rows sorted by `key` (positions `ix` into the row arrays): with
// `target`, adds each segment's sum of vals x weight to its key's row of
// target ([*, nc] floats); else writes each row's exclusive segment prefix
// of vals to out[ix] ([K, nc], with `out`) and its exclusive rank to
// rank[ix] (with `rank`).  `vals` [K, nc] in row positions; null reads 1.
// `weight` [K] in row positions, or null.  The rank is one more column, of
// ones.  A thread owns ceil(K / SEG_THREADS) consecutive rows, read in
// tiles (one tile, for K up to 8,192, loaded once); the columns run one
// after another, which keeps a thread's registers to one tile.
__global__ void __launch_bounds__(SEG_THREADS)
seg_scan_kernel(const int32_t* __restrict__ key, const int64_t* __restrict__ ix,
                int K, const float* __restrict__ vals, int nc,
                const bool* __restrict__ weight,
                float* __restrict__ out, int64_t* __restrict__ rank,
                float* __restrict__ target) {
  const int ncol = nc + (rank != nullptr ? 1 : 0);
  const int per = (K + SEG_THREADS - 1) / SEG_THREADS;
  const int lo = min(K, (int)threadIdx.x * per);
  const int hi = min(K, lo + per);
  // a thread of at most one tile (K <= SEG_THREADS * SEG_TILE) loads it
  // once for every column and both passes
  const bool one = per <= SEG_TILE;
  Tile t;
  float v[SEG_TILE];
  if (one) load_tile(t, key, ix, weight, lo, hi);
#pragma unroll 1
  for (int c = 0; c < ncol; ++c) {
    int flag = 0;
    double a = 0.0;
    for (int base = lo; base < hi; base += SEG_TILE) {
      if (!one) load_tile(t, key, ix, weight, base, hi);
      tile_vals(t, vals, nc, c, v);
      flag |= t.head != 0;
#pragma unroll
      for (int j = 0; j < SEG_TILE; ++j) {
        if ((t.head >> j) & 1u) a = 0.0;
        a += (double)v[j];
      }
    }
    a = block_carry(flag, a);
    for (int base = lo; base < hi; base += SEG_TILE) {
      if (!one) load_tile(t, key, ix, weight, base, hi);
      tile_vals(t, vals, nc, c, v);
#pragma unroll
      for (int j = 0; j < SEG_TILE; ++j) {
        if (base + j >= hi) break;
        if ((t.head >> j) & 1u) a = 0.0;
        const bool member = (t.member >> j) & 1u;
        if (c == nc) {
          rank[t.r[j]] = member ? (int64_t)a : 0;
        } else if (out != nullptr) {
          out[(int64_t)t.r[j] * nc + c] = member ? (float)a : 0.0f;
        }
        a += (double)v[j];
        const bool tail = base + j == K - 1
            || (j + 1 < SEG_TILE && base + j + 1 < hi
                    ? t.k[j + 1] != t.k[j]
                    : key[base + j + 1] != t.k[j]);
        if (target != nullptr && member && tail) {
          float* dst = target + (int64_t)t.k[j] * nc + c;
          *dst = (float)((double)*dst + a);
        }
      }
    }
  }
}

// target[idx[i]] += 1 for each i < M with weight[i] (or all, without
// weights) and 0 <= idx[i] < ncell.  With `smem` the counts gather in
// shared memory and each cell is written once; a target too large for
// it takes float atomics of 1.0, exact for counts below 2^24 in any
// order.
__global__ void __launch_bounds__(HIST_THREADS)
seg_hist_kernel(const int64_t* __restrict__ idx,
                const bool* __restrict__ weight, int M, int ncell,
                int smem, float* __restrict__ target) {
  extern __shared__ int cnt[];
  if (smem) {
    for (int i = threadIdx.x; i < ncell; i += blockDim.x) cnt[i] = 0;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    if (weight != nullptr && !weight[i]) continue;
    const int64_t j = idx[i];
    if (j < 0 || j >= ncell) continue;
    if (smem) {
      atomicAdd(&cnt[j], 1);
    } else {
      atomicAdd(&target[j], 1.0f);
    }
  }
  if (!smem) return;
  __syncthreads();
  for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
    if (cnt[i] != 0) target[i] = (float)((double)target[i] + cnt[i]);
  }
}

// Launch entry points (a plain C interface, bound with ctypes by
// wave_kernel.py).  Each returns a cudaError_t; nothing runs on refused
// arguments.
extern "C" int nomad_seg_scan(const void* key, const void* ix,
                              int K, const void* vals, int nc,
                              const void* weight, void* out, void* rank,
                              void* target, void* stream) {
  if (K < 1 || nc < 0 || (nc == 0 && rank == nullptr)
      || (target != nullptr && rank != nullptr))
    return (int)cudaErrorInvalidValue;
  seg_scan_kernel<<<1, SEG_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)key, (const int64_t*)ix, K, (const float*)vals, nc,
      (const bool*)weight, (float*)out, (int64_t*)rank, (float*)target);
  return (int)cudaGetLastError();
}

extern "C" int nomad_seg_hist(const void* idx, const void* weight, int M,
                              int ncell, int smem_cells, void* target,
                              void* stream) {
  if (M < 1 || ncell < 1) return (int)cudaErrorInvalidValue;
  const int smem = ncell <= smem_cells;
  seg_hist_kernel<<<1, HIST_THREADS, smem ? sizeof(int) * ncell : 0,
                    (cudaStream_t)stream>>>(
      (const int64_t*)idx, (const bool*)weight, M, ncell, smem,
      (float*)target);
  return (int)cudaGetLastError();
}
