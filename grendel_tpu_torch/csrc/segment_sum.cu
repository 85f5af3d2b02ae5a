// K2s: the fixed-order segment sum of K2's per-entry gradient rows.
//
// Replaces the jax.ops.segment_sum that follows the backward blend kernel
// in grendel_tpu/ops/rasterize_pallas.py _core_bwd (:621-653): each
// Gaussian's 9 gradients are the sum of the rows of the entries that name
// it. K2 (rasterize_bwd.cu) stores one row per entry; this kernel sums
// them per Gaussian, with no atomics, so the sum comes out the same on
// every run.
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
// Design: one thread per Gaussian. It finds its segment [lo, hi) by two
// binary searches of sorted_ids and adds the rows of perm[lo..hi) in that
// order into 9 registers that start at 0.0f, reading four rows ahead
// before it adds them. Built with --fmad=false (kernels.py), so every add
// rounds on its own: the result is bit-equal to index_add_ on the CPU in
// entry order (ops/rasterize_torch.py segment_sum_rows), which adds the
// rows one after another into a zero row.
//
// Bound on an H100: bytes. The function reads each entry's id once (4
// bytes an entry), the rows of the entries it sums (36 bytes each: those
// whose id lies in [0, n_seg)) and writes the output rows (36 bytes a
// Gaussian), at 3.35 TB/s; the sorted ids and the permutation are this
// design's own traffic, not the function's. A long segment is one
// thread's serial walk: its rows are scattered, so a Gaussian that spans
// thousands of tiles sets a tail of dependent-latency reads.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (cold L2; chip_smoke.py):
// 0.066 ms on the garden's 1,179,648 rows, 955,118 of them summed (bound
// 0.017 ms; index_add_ 0.543 ms), 0.117 ms on a loop step's 1,835,008
// (0.021; 1.433) and 0.803 ms on the 4K step's 7,864,320, whose segments
// reach 1,248 entries (0.076; 4.930). The stable sort before it takes
// 0.108, 0.142 and 0.439 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 9;
constexpr int kThreads = 256;
constexpr int kAhead = 4;   // rows loaded before they are added

// The first position in sorted[lo, hi) whose value is not below key.
template <typename T>
__device__ __forceinline__ int64_t lower_bound(const T* sorted, int64_t lo,
                                               int64_t hi, T key) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (sorted[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ rows,
                   const int32_t* __restrict__ sorted_ids,
                   const int64_t* __restrict__ perm, int64_t n_entries,
                   int32_t n_seg, float* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_seg) return;
  const int64_t lo = lower_bound(sorted_ids, 0, n_entries, (int32_t)g);
  const int64_t hi = lower_bound(sorted_ids, lo, n_entries, (int32_t)g + 1);
  float acc[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
  int64_t i = lo;
  for (; i + kAhead <= hi; i += kAhead) {
    float v[kAhead][kCols];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const float* row = rows + perm[i + k] * kCols;
#pragma unroll
      for (int q = 0; q < kCols; ++q) v[k][q] = row[q];
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[q] = acc[q] + v[k][q];
    }
  }
  for (; i < hi; ++i) {
    const float* row = rows + perm[i] * kCols;
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[q] = acc[q] + row[q];
  }
  float* dst = out + g * kCols;
#pragma unroll
  for (int q = 0; q < kCols; ++q) dst[q] = acc[q];
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
  const int64_t blocks = ((int64_t)n_seg + kThreads - 1) / kThreads;
  segment_sum_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)rows, (const int32_t*)sorted_ids, (const int64_t*)perm,
      n_entries, n_seg, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
