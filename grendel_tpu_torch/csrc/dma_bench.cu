// K4 and K5: the two kernels of the DMA microbenchmark.
//
// K4 replaces scripts/microbench_dma.py:98 contig_kernel: one contiguous
// (16, 128) f32 chunk (8 KiB, the blend payload's chunk layout) brought
// on chip per grid step. K5 replaces scripts/microbench_dma.py:126
// scattered_kernel: 128 rows table[ids[c * 128 + j]] gathered one by one
// per chunk, optionally followed by arithmetic on the gathered tile, to
// see whether the gather can live inside a blend kernel. Both TPU kernels
// write only placeholders (K4's output block keeps the last chunk only
// because the TPU grid runs in order; K5 deletes its output). Here what
// a chunk loads is folded into one int32 checksum, the wrap-around sum of
// the float32 bit patterns: the compiler cannot drop the loads, and the
// plain versions (ops/dma_bench.py) check the result bit for bit in any
// order of summation.
//
// Bound on an H100: bytes. Every input byte is read once (K4: 8 KiB per
// chunk; K5: each distinct table row the ids touch, and 128 ids per
// chunk) and 4 bytes are written per chunk, at 3.35 TB/s. K5 reads a
// row as often as the ids name it (about four times at the
// microbenchmark's sizes), from the L2 where the table fits it. K5's
// arithmetic (2 operations per element and round) stays below that at
// the microbenchmark's 24 rounds.
//
// Design:
//   K4: one block of 256 threads per chunk; each thread issues both of
//       its 16-byte loads (coalesced: neighbouring threads, neighbouring
//       addresses) before it stores them to shared memory, then folds 8
//       words of the tile, strided so that a warp hits 32 banks.
//   K5: the tile of a chunk (128 rows of W floats, W = 16 or 128) is
//       split into 16-byte pieces (2 a thread of 256 at W = 16, 16 at
//       W = 128), each copied straight into shared memory by cp.async:
//       every load is in flight at once and holds no register, and an
//       id outside [0, n_rows) copies nothing and fills zeros. The grid
//       is the blocks the card holds at once; each block walks chunks
//       blockIdx.x, + gridDim.x, ... through a ring of two tiles, so
//       that the next chunk's copies are in flight while a chunk is
//       folded: the counterpart of the TPU kernel's window of 8 row DMAs.
//       (Rings of 3, 4 and 6 tiles measured no faster; PERF.md.)
//       A thread loads the ids of its pieces a chunk ahead. Each element
//       of a landed tile runs vpu_iters rounds of x = x * 1.000001f +
//       0.5f, rounded after the product and after the sum as the plain
//       version rounds (four elements' rounds side by side), and is
//       folded. One bulk copy (1D TMA) per row, completing on an
//       mbarrier, measured slower at both widths (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkElems = 16 * 128;     // K4 chunk: (16, 128) f32
constexpr int kIdsPerChunk = 128;         // K5 rows per chunk

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// Wrap-around sum of one value per thread over the block; thread 0 gets it.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* warp_tot) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t r = 0;
  if (threadIdx.x < 32) {
    r = threadIdx.x < kWarps ? warp_tot[threadIdx.x] : 0u;
    r = warp_sum(r);
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
contig_kernel(const float4* __restrict__ src, int32_t* __restrict__ out) {
  __shared__ float4 tile[kChunkElems / 4];
  __shared__ uint32_t warp_tot[kWarps];
  const float4* chunk = src + (int64_t)blockIdx.x * (kChunkElems / 4);
  const float4 a = chunk[threadIdx.x];
  const float4 b = chunk[threadIdx.x + kThreads];
  tile[threadIdx.x] = a;
  tile[threadIdx.x + kThreads] = b;
  __syncthreads();
  const uint32_t* words = reinterpret_cast<const uint32_t*>(tile);
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < kChunkElems / kThreads; ++k) {
    s += words[k * kThreads + threadIdx.x];
  }
  s = block_sum(s, warp_tot);
  if (threadIdx.x == 0) out[blockIdx.x] = (int32_t)s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           unsigned src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The checksum of one gathered tile after vpu_iters rounds, on thread 0.
// Each thread runs four elements' rounds side by side.
template <int W>
__device__ __forceinline__ uint32_t fold_tile(const float4* tile,
                                              int vpu_iters,
                                              uint32_t* warp_tot) {
  constexpr int kPer = kIdsPerChunk * W / kThreads;   // elements a thread
  static_assert(kPer % 4 == 0, "four elements at a time");
  const float* f = reinterpret_cast<const float*>(tile);
  uint32_t s = 0;
#pragma unroll 1
  for (int g = 0; g < kPer; g += 4) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = f[(g + u) * kThreads + threadIdx.x];
    for (int i = 0; i < vpu_iters; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x[u] = __fadd_rn(__fmul_rn(x[u], 1.000001f), 0.5f);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) s += __float_as_uint(x[u]);
  }
  return block_sum(s, warp_tot);
}

// A ring of two tiles: chunk c + gridDim.x's copies are in flight while
// chunk c is folded
template <int W>
__global__ void __launch_bounds__(kThreads)
scattered_kernel(const float* __restrict__ table, int64_t n_rows,
                 const int32_t* __restrict__ ids, int64_t n_chunks,
                 int vpu_iters, int32_t* __restrict__ out) {
  constexpr int kVec = W / 4;                       // 16-byte pieces a row
  constexpr int kTileVec = kIdsPerChunk * kVec;
  constexpr int kPer = kTileVec / kThreads;         // pieces a thread
  static_assert(kTileVec % kThreads == 0, "tile must split evenly");
  extern __shared__ float4 tiles[];                 // 2 x kTileVec pieces
  __shared__ uint32_t warp_tot[kWarps];
  const int64_t step = gridDim.x;
  int64_t c = blockIdx.x;
  if (c >= n_chunks) return;

  // the ids of a thread's pieces of one chunk, loaded a chunk ahead
  int32_t id[kPer];
  auto load_ids = [&](int64_t chunk) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      id[k] = __ldg(ids + chunk * kIdsPerChunk +
                    (k * kThreads + threadIdx.x) / kVec);
    }
  };
  auto load_rows = [&](float4* tile) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = k * kThreads + threadIdx.x;
      const bool ok = id[k] >= 0 && (int64_t)id[k] < n_rows;
      // an id outside the table reads nothing and fills zeros
      cp_async16(tile + q,
                 reinterpret_cast<const float4*>(
                     table + (ok ? (int64_t)id[k] * W : 0)) + q % kVec,
                 ok ? 16u : 0u);
    }
    cp_async_commit();
  };

  load_ids(c);
  load_rows(tiles);
  if (c + step < n_chunks) load_ids(c + step);
  for (int s = 0; c < n_chunks; c += step, s ^= 1) {
    // chunk c has landed for every thread, and every thread has folded
    // the chunk before it, whose tile the next copies overwrite
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const int64_t next = c + step;
    if (next < n_chunks) {
      load_rows(tiles + (s ^ 1) * kTileVec);
      if (next + step < n_chunks) load_ids(next + step);
    }
    const uint32_t sum = fold_tile<W>(tiles + s * kTileVec, vpu_iters,
                                      warp_tot);
    if (threadIdx.x == 0) out[c] = (int32_t)sum;
  }
}

// K5's grid is the blocks the card holds at once, found on the first call
// on each device: they walk the chunks in a ring.
template <int W>
int launch_scattered(const float* table, int64_t n_rows, const int32_t* ids,
                     int64_t n_chunks, int vpu_iters, int32_t* out,
                     cudaStream_t s) {
  const size_t smem = 2 * (size_t)kIdsPerChunk * W * sizeof(float);
  static unsigned grid_of[16];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  unsigned grid = dev < 16 ? grid_of[dev] : 0;
  if (grid == 0) {
    e = cudaFuncSetAttribute(scattered_kernel<W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, scattered_kernel<W>, kThreads, smem);
    }
    if (e != cudaSuccess) return (int)e;
    grid = (unsigned)(sms * (per_sm > 0 ? per_sm : 1));
    if (dev < 16) grid_of[dev] = grid;
  }
  if (grid > n_chunks) grid = (unsigned)n_chunks;
  scattered_kernel<W><<<grid, kThreads, smem, s>>>(table, n_rows, ids,
                                                   n_chunks, vpu_iters, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4. src: device f32[n_chunks * 2048], 16-byte aligned; out: int32[n_chunks].
int gts_dma_contig(const void* src, int64_t n_chunks, void* out,
                   void* stream) {
  if (n_chunks < 0 || n_chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaSuccess;
  contig_kernel<<<(unsigned)n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)src, (int32_t*)out);
  return (int)cudaGetLastError();
}

// K5. table: device f32[n_rows * width], 16-byte aligned, width 16 or 128;
// ids: int32[n_chunks * 128]; out: int32[n_chunks].
int gts_dma_scattered(const void* table, int64_t n_rows, int width,
                      const void* ids, int64_t n_chunks, int vpu_iters,
                      void* out, void* stream) {
  if (n_chunks < 0 || n_chunks > 0x7fffffff || vpu_iters < 0 ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_chunks == 0) return (int)cudaSuccess;
  const float* t = (const float*)table;
  const int32_t* i = (const int32_t*)ids;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (width == 16) {
    return launch_scattered<16>(t, n_rows, i, n_chunks, vpu_iters, o, s);
  }
  if (width == 128) {
    return launch_scattered<128>(t, n_rows, i, n_chunks, vpu_iters, o, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
