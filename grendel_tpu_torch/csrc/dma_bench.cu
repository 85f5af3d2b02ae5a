// K4 and K5: the two kernels of the DMA microbenchmark.
//
// K4 replaces scripts/microbench_dma.py:98 contig_kernel: one contiguous
// (16, 128) f32 chunk (8 KiB, the blend payload's chunk layout) brought
// on chip per grid step. K5 replaces scripts/microbench_dma.py:126
// scattered_kernel: 128 rows table[ids[c * 128 + j]] gathered one by one
// per chunk, optionally followed by arithmetic on the gathered tile, to
// see whether the gather can live inside a blend kernel. Both TPU kernels
// write only placeholders (K4's output block keeps the last chunk only
// because the TPU grid runs in order; K5 deletes its output). Here each
// block folds what it loaded into one int32 checksum per chunk, the
// wrap-around sum of the float32 bit patterns: the compiler cannot drop
// the loads, and the plain versions (ops/dma_bench.py) check the result
// bit for bit in any order of summation.
//
// Bound on an H100: bytes. Every input byte is read once (K4: 8 KiB per
// chunk; K5: 128 rows of W floats plus 128 ids per chunk) and 4 bytes are
// written per chunk, at 3.35 TB/s. K5's arithmetic (2 operations per
// element and round) stays below that at the microbenchmark's 24 rounds.
//
// Design, simple first:
//   K4: one block of 256 threads per chunk; each thread issues both of
//       its 16-byte loads (coalesced: neighbouring threads, neighbouring
//       addresses) before it stores them to shared memory, then folds 8
//       words of the tile, strided so that a warp hits 32 banks.
//   K5: one block of 256 threads per chunk of 128 ids; the tile
//       (128 x W floats, W = 16 or 128) is split into 16-byte pieces
//       (2 a thread at W = 16, 16 at W = 128). Each thread loads its
//       pieces into registers, then stores them to shared memory; the
//       TPU's window of 8 DMA semaphores has no counterpart. How many
//       loads are in flight at once is ptxas's choice: at W = 16 a
//       thread's two pieces take 8 registers; at W = 128 all 16 would
//       take 64, and ptxas gives the kernel under 40 (the build log), so
//       it interleaves loads and stores and keeps only a few pieces a
//       thread in flight.
//       Then each element of the shared tile runs vpu_iters
//       rounds of x = x * 1.000001f + 0.5f, rounded after the product and
//       after the sum as the plain version rounds, and is folded. An id
//       outside [0, n_rows) gathers a row of zeros.
//   cp.async and TMA variants of both are later work.

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

template <int W>
__global__ void __launch_bounds__(kThreads)
scattered_kernel(const float* __restrict__ table, int64_t n_rows,
                 const int32_t* __restrict__ ids, int vpu_iters,
                 int32_t* __restrict__ out) {
  constexpr int kVec = W / 4;                       // 16-byte pieces a row
  constexpr int kTileVec = kIdsPerChunk * kVec;
  constexpr int kPer = kTileVec / kThreads;         // pieces a thread
  static_assert(kTileVec % kThreads == 0, "tile must split evenly");
  extern __shared__ float4 tile[];                  // kTileVec pieces
  __shared__ uint32_t warp_tot[kWarps];
  const int32_t* chunk_ids = ids + (int64_t)blockIdx.x * kIdsPerChunk;

  float4 v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = k * kThreads + threadIdx.x;
    const int32_t id = __ldg(chunk_ids + q / kVec);
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (id >= 0 && (int64_t)id < n_rows) {
      v[k] = __ldg(reinterpret_cast<const float4*>(table + (int64_t)id * W) +
                   q % kVec);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) tile[k * kThreads + threadIdx.x] = v[k];
  __syncthreads();

  const float* f = reinterpret_cast<const float*>(tile);
  uint32_t s = 0;
  for (int e = threadIdx.x; e < kIdsPerChunk * W; e += kThreads) {
    float x = f[e];
    for (int i = 0; i < vpu_iters; ++i) {
      x = __fadd_rn(__fmul_rn(x, 1.000001f), 0.5f);
    }
    s += __float_as_uint(x);
  }
  s = block_sum(s, warp_tot);
  if (threadIdx.x == 0) out[blockIdx.x] = (int32_t)s;
}

template <int W>
int launch_scattered(const float* table, int64_t n_rows, const int32_t* ids,
                     int64_t n_chunks, int vpu_iters, int32_t* out,
                     cudaStream_t s) {
  const size_t smem = (size_t)kIdsPerChunk * W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scattered_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  scattered_kernel<W><<<(unsigned)n_chunks, kThreads, smem, s>>>(
      table, n_rows, ids, vpu_iters, out);
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
  if (n_chunks < 0 || n_chunks > 0x7fffffff || vpu_iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_chunks == 0) return (int)cudaSuccess;
  const float* t = (const float*)table;
  const int32_t* i = (const int32_t*)ids;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (width == 16) return launch_scattered<16>(t, n_rows, i, n_chunks,
                                               vpu_iters, o, s);
  if (width == 128) return launch_scattered<128>(t, n_rows, i, n_chunks,
                                                 vpu_iters, o, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
