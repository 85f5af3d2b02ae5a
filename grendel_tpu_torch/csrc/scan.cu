// K3: inclusive int32 prefix scan over C channels of equal length M.
//
// Replaces grendel_tpu/ops/scan_pallas.py:65 _cumsum_kernel (launched by
// cumsum_i32_multi:79 and cumsum_i32:118). The tile-list build calls it on
// the per-Gaussian entry counts (C=1, M=B*N) and on the scatter-delta
// buffers of the segment broadcasts (C=3..4, M=isect capacity).
//
// Bound on an H100: bytes. Every element is read and written once, so the
// least traffic is 2*C*M*4 bytes at 3.35 TB/s; the adds are free.
//
// Design: reduce-then-scan in three launches, simple first.
//   1. tile_sums: one block per (4096-element tile, channel) reads its tile
//      once and writes the tile's sum.
//   2. scan_sums: one block per channel turns the tile sums into exclusive
//      tile offsets (a few hundred values).
//   3. scan_tiles: one block per (tile, channel) reads the tile again into
//      shared memory, scans it (8 consecutive items per thread, then a
//      warp-shuffle scan of the thread totals), adds the tile offset and
//      writes it out with coalesced stores.
// That is 3*C*M*4 bytes of traffic against the 2*C*M*4 bound; a single-pass
// decoupled-lookback scan would reach the bound and is later work.
//
// Exactness: all adds are done on uint32, which wraps exactly like int32
// addition in torch.cumsum(dtype=int32), in any association order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxChannels = 8;

struct Channels {
  const int32_t* in[kMaxChannels];
  int32_t* out[kMaxChannels];
};

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// Inclusive scan of one value per thread over the block. Every thread of
// the block must call it; warp_tot is kWarps words of shared memory.
__device__ uint32_t block_incl_scan(uint32_t v, uint32_t* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t incl = warp_incl_scan(v);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_tot[lane] : 0u;
    w = warp_incl_scan(w);
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const uint32_t r = incl + (warp > 0 ? warp_tot[warp - 1] : 0u);
  __syncthreads();  // warp_tot may be reused by the next call
  return r;
}

// Shared-memory index with one pad word per 32: thread i reading items
// [8i, 8i+8) then hits 32 distinct banks across a warp.
__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

__global__ void __launch_bounds__(kThreads)
tile_sums_kernel(Channels ch, int64_t m, int n_tiles, uint32_t* sums) {
  __shared__ uint32_t warp_tot[kWarps];
  const int c = blockIdx.y;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int32_t* in = ch.in[c];
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k * kThreads + threadIdx.x;
    if (i < m) s += (uint32_t)in[i];
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    uint32_t v = threadIdx.x < kWarps ? warp_tot[threadIdx.x] : 0u;
    v = warp_sum(v);
    if (threadIdx.x == 0) sums[(int64_t)c * n_tiles + blockIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_sums_kernel(uint32_t* sums, int n_tiles) {
  __shared__ uint32_t warp_tot[kWarps];
  uint32_t* s = sums + (int64_t)blockIdx.x * n_tiles;
  uint32_t carry = 0;
  for (int start = 0; start < n_tiles; start += kThreads) {
    const int i = start + threadIdx.x;
    const uint32_t v = i < n_tiles ? s[i] : 0u;
    const uint32_t incl = block_incl_scan(v, warp_tot);
    if (i < n_tiles) s[i] = carry + incl - v;  // exclusive offset
    // the last thread's inclusive value is this round's total
    if (threadIdx.x == kThreads - 1) warp_tot[0] = incl;
    __syncthreads();
    carry += warp_tot[0];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(Channels ch, int64_t m, int n_tiles, const uint32_t* offs) {
  __shared__ uint32_t buf[kTile + kTile / 32];
  __shared__ uint32_t warp_tot[kWarps];
  const int c = blockIdx.y;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int32_t* in = ch.in[c];
  int32_t* out = ch.out[c];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    const int64_t i = base + j;
    buf[padded(j)] = i < m ? (uint32_t)in[i] : 0u;
  }
  __syncthreads();
  uint32_t local[kItems];
  uint32_t run = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run += buf[padded(threadIdx.x * kItems + k)];
    local[k] = run;
  }
  const uint32_t incl = block_incl_scan(run, warp_tot);
  const uint32_t pre = offs[(int64_t)c * n_tiles + blockIdx.x] + incl - run;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    buf[padded(threadIdx.x * kItems + k)] = pre + local[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    const int64_t i = base + j;
    if (i < m) out[i] = (int32_t)buf[padded(j)];
  }
}

}  // namespace

extern "C" {

// Elements per tile: the wrapper sizes the scratch as channels * tiles.
int gts_scan_tile_elems() { return kTile; }

// ins/outs: host arrays of n_channels device pointers to int32[m].
// scratch: device uint32[n_channels * ceil(m / tile)].
// Returns cudaGetLastError() after the launches (0 = success).
int gts_scan_i32(const void* const* ins, void* const* outs, int n_channels,
                 int64_t m, void* scratch, void* stream) {
  if (n_channels < 1 || n_channels > kMaxChannels || m < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return (int)cudaSuccess;
  const int64_t n_tiles64 = (m + kTile - 1) / kTile;
  if (n_tiles64 > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)n_tiles64;
  Channels ch;
  for (int c = 0; c < kMaxChannels; ++c) {
    ch.in[c] = c < n_channels ? (const int32_t*)ins[c] : nullptr;
    ch.out[c] = c < n_channels ? (int32_t*)outs[c] : nullptr;
  }
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* sums = (uint32_t*)scratch;
  const dim3 grid(n_tiles, n_channels);
  tile_sums_kernel<<<grid, kThreads, 0, s>>>(ch, m, n_tiles, sums);
  scan_sums_kernel<<<n_channels, kThreads, 0, s>>>(sums, n_tiles);
  scan_tiles_kernel<<<grid, kThreads, 0, s>>>(ch, m, n_tiles, sums);
  return (int)cudaGetLastError();
}

}  // extern "C"
