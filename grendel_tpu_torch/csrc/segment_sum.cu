// K2s: the fixed-order segment sum of K2's per-entry gradient rows.
//
// Replaces the jax.ops.segment_sum that ends the backward blend in
// grendel_tpu/ops/rasterize_pallas.py _core_bwd (:648): each Gaussian's 9
// gradients are the sum of the rows of the entries that name it. K2
// (rasterize_bwd.cu) stores one row per entry; this kernel sums them per
// Gaussian, with no atomics, so the sum comes out the same on every run.
//
// Input: the rows (n_entries, 9) f32, and the entries ordered by Gaussian:
// sorted_ids (n_entries,) i32 ascending and perm (n_entries,) i64 from a
// stable sort of the entry ids (torch.sort(ids, stable=True)), so that
// sorted_ids[i] = ids[perm[i]] and each Gaussian's entries stand in
// ascending entry order. Output: out (n_seg, 9) f32, every row written
// (zero for a Gaussian with no entry). Ids outside [0, n_seg) (the
// sentinel, which every list builder of ops/isect.py gives the entries
// outside its spans) sort before or after every segment and are dropped.
//
// Order: each output value is one chain of adds, serial in ascending
// entry order from 0.0f, one rounding an add (built with --fmad=false,
// kernels.py): bit-equal to index_add_ on the CPU in entry order
// (ops/rasterize_torch.py segment_sum_rows). The parallelism comes only
// from across Gaussians and across the 9 columns, which are 9 chains of
// their own; no chain is split, so no partial sums are joined.
//
// Bound on an H100: bytes. The function reads each entry's id once (4
// bytes an entry), the rows of the entries it sums (36 bytes each: those
// whose id lies in [0, n_seg)) and writes the output rows (36 bytes a
// Gaussian), at 3.35 TB/s. This design adds its own floor: the sorted ids
// and the permutation (12 bytes an entry), and two 32-byte sectors for
// every 36-byte row it gathers.
//
// Design: a block of 256 threads owns a tile of 256 consecutive
// Gaussians, whose segments are one range [e0, e1) of the sorted entries.
//   - Bounds: two warps find e0 and e1 at once, each by a 32-way search
//     (32 probes a round, a ballot keeps the piece between the last probe
//     below the key and the first not below it: 5 rounds at 8M entries).
//     The block then reads the range's sorted ids once, coalesced (4 a
//     thread a round), and each entry at which the id steps up writes the
//     start offset of every Gaussian it steps over into shared memory.
//   - Rows: the range is staged through a ring of two stages of 256
//     entries in shared memory, or of 512 where the tiles hold more than
//     2,048 entries on average. For stage k+1, the permutation is copied
//     in with cp.async (8 bytes an entry, coalesced) a stage ahead, then
//     its rows are gathered with cp.async (4 bytes a copy: 9 neighbouring
//     threads take one row's 9 floats), every copy in flight while the
//     block adds stage k. A long segment costs one memory round trip a
//     stage, not two a few rows.
//   - Adds: thread t holds 9 of the block's 2,304 (Gaussian, column)
//     chains in registers, chain c = t + 256 j (Gaussian c / 9, column
//     c % 9), and adds each chain's rows of the stage from shared memory
//     in entry order. A Gaussian's 9 columns lie on 9 neighbouring
//     threads, so a long segment is added 9 columns side by side while
//     the whole block gathers its rows: no one thread walks it.
//   - Stores: chain c is output float g0 * 9 + c, so the block writes its
//     rows coalesced.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (cold L2;
// scripts/time_kernels.py, the parent's one thread a Gaussian in
// brackets; PERF.md, PR 12): 0.0614-0.0617 ms on the garden's 1,179,648
// rows, 955,118 of them summed (0.0659-0.0661; bound 0.0173; index_add_
// 0.542), 0.0778-0.0801 on a loop step's 1,835,008 (0.1161-0.1167;
// bound 0.0211) and 0.3030-0.3033 on the 4K step's 7,864,320, 5,558,033
// summed in segments of up to 1,248 (0.8034-0.8053; bound 0.0756). The
// stable sort before it takes 0.110, 0.143 and 0.437 ms. One index_select
// of the same rows in the same order takes 0.052, 0.062 and 0.313 ms: the
// scattered 36-byte rows set the pace, not the searches or the adds.
// Measured no faster: 16-byte copies of the 48 bytes around each row
// (past L1), a pass of its own for the tiles' bounds, heavy tiles first by
// such a pass, rings of 3 stages, 6 to 16 blocks an SM, deeper unrolling
// of the adds. The tiles from the last to the first gained 0.005-0.02 ms
// at 4K and cost up to 6% on the garden.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 9;
constexpr int kThreads = 256;
constexpr int kGauss = kThreads;              // Gaussians a block owns
constexpr int kChains = kCols * kGauss / kThreads;  // chains a thread adds
// Entries a ring stage holds: 256, or 512 where a tile holds more than
// kWideMean entries on average. Long segments want the wide stage (half
// the round trips of a tile), short ones the narrow (48 registers against
// about 100: 5 blocks an SM, not 2, to hide the searches): on an NVIDIA
// H100 80GB HBM3 at 700.00 W the wide stage took 0.29-0.30 ms against
// 0.37 at 4K and 0.083 against 0.061 on the garden (PERF.md, PR 12).
constexpr int kNarrow = kThreads, kWide = 2 * kThreads;
constexpr int64_t kWideMean = 2048;
constexpr int kSweep = 4;                     // sorted ids a thread reads a round
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(int64_t* smem,
                                          const int64_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The first position in sorted[0, n) whose value is not below key, found
// by the 32 lanes of a warp together: each round probes 32 points of
// [lo, hi) and keeps the piece between the last probe below key and the
// first that is not. Every lane returns it.
__device__ __forceinline__ int64_t warp_lower_bound(const int32_t* sorted,
                                                    int64_t n,
                                                    int32_t key) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t span = hi - lo;
    const bool below = sorted[lo + span * (lane + 1) / 33] < key;
    const int n_below = __popc(__ballot_sync(kFull, below));
    const int64_t base = lo;
    if (n_below > 0) lo = base + span * n_below / 33 + 1;
    if (n_below < 32) hi = base + span * (n_below + 1) / 33;
  }
  return lo;
}

// The block's ring stage of chunk k, whose entries start at cs.
struct Stage {
  int64_t cs;
  int n;
};

template <int kChunk>
__device__ __forceinline__ Stage stage_of(int64_t e0, int64_t e1,
                                          int64_t k) {
  const int64_t cs = e0 + k * kChunk;
  return {cs, (int)min((int64_t)kChunk, e1 - cs)};
}

// x clamped to [0, n]: an offset into a stage of n entries.
__device__ __forceinline__ int clamp_to(int64_t x, int n) {
  return (int)min(max(x, (int64_t)0), (int64_t)n);
}

template <int kChunk>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ rows,
                   const int32_t* __restrict__ sorted_ids,
                   const int64_t* __restrict__ perm, int64_t n_entries,
                   int32_t n_seg, float* __restrict__ out) {
  __shared__ __align__(16) float s_rows[2][kChunk * kCols];
  __shared__ __align__(16) int64_t s_perm[2][kChunk];
  __shared__ int64_t s_off[kGauss + 1];   // segment starts, absolute
  __shared__ int64_t s_range[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t g0 = (int64_t)blockIdx.x * kGauss;
  const int n_g = (int)min((int64_t)kGauss, (int64_t)n_seg - g0);
  const int64_t g1 = g0 + n_g;

  if (warp < 2) {
    const int64_t e = warp_lower_bound(sorted_ids, n_entries,
                                       (int32_t)(warp == 0 ? g0 : g1));
    if (lane == 0) s_range[warp] = e;
  }
  __syncthreads();
  const int64_t e0 = s_range[0], e1 = s_range[1];
  const int64_t n_chunks = (e1 - e0 + kChunk - 1) / kChunk;

  auto load_perm = [&](int64_t k) {
    const Stage st = stage_of<kChunk>(e0, e1, k);
#pragma unroll
    for (int u = 0; u < kChunk / kThreads; ++u) {
      const int r = t + u * kThreads;
      if (r < st.n) cp_async8(&s_perm[k & 1][r], perm + st.cs + r);
    }
  };
  auto gather = [&](int64_t k) {
    const Stage st = stage_of<kChunk>(e0, e1, k);
    float* dst = s_rows[k & 1];
    const int64_t* src = s_perm[k & 1];
#pragma unroll
    for (int j = 0; j < kCols * kChunk / kThreads; ++j) {
      const int f = t + j * kThreads;
      const int r = f / kCols;
      if (r < st.n) cp_async4(dst + f, rows + src[r] * kCols + (f - r * kCols));
    }
  };

  if (n_chunks > 0) load_perm(0);
  cp_async_commit();

  // Segment starts: s_off[g - g0] = the first entry whose id is not below
  // g, for g in [g0, g1]. Entry i (i in [e0, e1], e1 read as an entry of
  // id g1) writes it for every g in (id of i - 1, id of i].
  for (int64_t base = e0; base <= e1; base += kThreads * kSweep) {
    int32_t cur[kSweep];
#pragma unroll
    for (int u = 0; u < kSweep; ++u) {
      const int64_t i = base + u * kThreads + t;
      cur[u] = i < e1 ? sorted_ids[i] : (int32_t)g1;
    }
#pragma unroll
    for (int u = 0; u < kSweep; ++u) {
      const int64_t i = base + u * kThreads + t;
      int64_t prev = __shfl_up_sync(kFull, cur[u], 1);
      if (lane == 0) prev = (i > e0 && i <= e1) ? sorted_ids[i - 1] : g0 - 1;
      if (i <= e1) {
        for (int64_t g = prev + 1; g <= cur[u]; ++g) s_off[g - g0] = i;
      }
    }
  }

  cp_async_wait_all();
  __syncthreads();
  if (n_chunks > 0) gather(0);
  if (n_chunks > 1) load_perm(1);
  cp_async_commit();

  float acc[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) acc[j] = 0.0f;

  for (int64_t k = 0; k < n_chunks; ++k) {
    cp_async_wait_all();      // this thread's copies of chunk k (and the
    __syncthreads();          // permutation of k + 1); then everyone's
    if (k + 1 < n_chunks) gather(k + 1);
    if (k + 2 < n_chunks) load_perm(k + 2);
    cp_async_commit();
    const Stage st = stage_of<kChunk>(e0, e1, k);
    const float* buf = s_rows[k & 1];
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      const int c = t + j * kThreads;
      const int p = c / kCols;
      if (p < n_g) {
        const int a = clamp_to(s_off[p] - st.cs, st.n);
        const int b = clamp_to(s_off[p + 1] - st.cs, st.n);
        const float* src = buf + a * kCols + (c - p * kCols);
        float x = acc[j];
#pragma unroll 4
        for (int i = a; i < b; ++i, src += kCols) x = x + *src;
        acc[j] = x;
      }
    }
    __syncthreads();          // before chunk k + 2 lands in this stage
  }

#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    const int c = t + j * kThreads;
    if (c < n_g * kCols) out[g0 * kCols + c] = acc[j];
  }
}

}  // namespace

extern "C" {

// Every pointer is a device pointer to a contiguous array: rows
// f32[n_entries*9], sorted_ids i32[n_entries] (ascending), perm
// i64[n_entries] (the stable sort's permutation of the entries), out
// f32[n_seg*9]. Returns cudaGetLastError() after the launch (0 =
// success).
int gts_segment_sum_rows(const void* rows, const void* sorted_ids,
                         const void* perm, int64_t n_entries, int32_t n_seg,
                         void* out, void* stream) {
  if (n_entries < 0 || n_seg < 0) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return (int)cudaSuccess;
  const int64_t blocks = ((int64_t)n_seg + kGauss - 1) / kGauss;
  auto kernel = n_entries > kWideMean * blocks ? segment_sum_kernel<kWide>
                                               : segment_sum_kernel<kNarrow>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const int32_t*)sorted_ids, (const int64_t*)perm,
      n_entries, n_seg, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
