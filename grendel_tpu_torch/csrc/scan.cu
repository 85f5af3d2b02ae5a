// K3: inclusive int32 prefix scan over C channels of equal length M.
//
// Replaces grendel_tpu/ops/scan_pallas.py:65 _cumsum_kernel (launched by
// cumsum_i32_multi:79 and cumsum_i32:118). The tile-list build calls it on
// the per-Gaussian entry counts (C=1, M=B*N) and on the scatter-delta
// buffers of its segment broadcasts (C=4, M=isect capacity).
//
// Bound on an H100: bytes. Every element is read and written once, so the
// least traffic is 2*C*M*4 bytes at 3.35 TB/s (1.25 us at C=1, M=524,288);
// the adds are free. At these sizes a launch's own latency is of the same
// order, so the design counts launches as well as bytes.
//
// Design: one launch of a single-pass scan with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016). The three-launch reduce-then-scan it replaces
// read the input twice and paid three launch latencies.
//   * Each block takes a ticket from a counter in device memory; the ticket
//     names its (channel, tile), channel-major. A block therefore waits
//     only on tiles whose blocks have already started, whatever order the
//     card runs blocks in (the C=4 grid is larger than the card holds).
//     The counter is never reset: the wrapper passes the count of tickets
//     issued by earlier calls as `ticket_base`.
//   * A block of 512 threads reads its tile of 8,192 elements once, with
//     16-byte loads where the channel is aligned and the tile whole, into
//     shared memory; each thread scans 16 consecutive elements in
//     registers, and one warp-shuffle pass over the thread totals scans
//     the tile. (Tiles of 2,048 and 4,096 elements, which give the card
//     more blocks at C=1, measured slower at both main-path shapes:
//     0.0122 and 0.0116 ms at C=1, 0.0408 and 0.0299 ms at C=4.)
//   * The block publishes its tile's aggregate, then its inclusive prefix,
//     as one 64-bit status word per (channel, tile):
//       flag (2 bits: 1 aggregate, 2 prefix) | epoch (30 bits) | value.
//     A word whose epoch is not this call's is "not ready", so the status
//     array is never cleared: the wrapper raises the epoch on every call
//     and zeroes the array only when the epoch wraps.
//   * One warp looks back over 32 predecessors at a time, summing
//     aggregates until it meets a prefix.
// Exactness: all adds are done on uint32, which wraps exactly like int32
// addition in torch.cumsum(dtype=int32), in any association order.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (cold L2; chip_smoke.py):
// 0.0114-0.0115 ms at C=1, M=524,288, where one torch.cumsum takes 0.0120
// ms and the three-launch design took 0.0192-0.0195 ms, and 0.0266 ms at
// C=4, M=1,179,648 (0.077-0.079 ms before). That is near one launch's
// latency, not the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;   // elements per thread
constexpr int kTile = kThreads * kItems;
constexpr int kMaxChannels = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint64_t kFlagAggregate = 1ull << 62;
constexpr uint64_t kFlagPrefix = 2ull << 62;
constexpr uint32_t kEpochMask = (1u << 30) - 1u;

struct Channels {
  const int32_t* in[kMaxChannels];
  int32_t* out[kMaxChannels];
};

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t n = __shfl_up_sync(kFullMask, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFullMask, v, d);
  return v;
}

// Shared-memory index with one pad word per 32: thread i reading items
// [16i, 16i+16) then hits 32 distinct banks across a warp.
__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

__device__ __forceinline__ void publish(uint64_t* word, uint64_t flag,
                                       uint32_t epoch, uint32_t value) {
  __threadfence();
  *reinterpret_cast<volatile uint64_t*>(word) =
      flag | ((uint64_t)epoch << 32) | value;
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(Channels ch, int64_t m, int n_tiles, uint64_t* status,
            uint32_t* counter, uint32_t ticket_base, uint32_t epoch) {
  __shared__ uint32_t buf[kTile + kTile / 32];
  __shared__ uint32_t warp_tot[kWarps];
  __shared__ uint32_t s_ticket;
  __shared__ uint32_t s_exclusive;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) s_ticket = atomicAdd(counter, 1u) - ticket_base;
  __syncthreads();
  const int ticket = (int)s_ticket;
  const int c = ticket / n_tiles;
  const int tile = ticket - c * n_tiles;
  const int64_t base = (int64_t)tile * kTile;
  // select the channel without indexing the parameter struct (which
  // would copy it to the stack)
  const int32_t* in = ch.in[0];
  int32_t* out = ch.out[0];
#pragma unroll
  for (int k = 1; k < kMaxChannels; ++k) {
    if (k == c) {
      in = ch.in[k];
      out = ch.out[k];
    }
  }
  in += base;
  out += base;
  const int64_t rem = m - base;
  const int valid = rem < kTile ? (int)rem : kTile;
  const bool vec = valid == kTile &&
                   ((reinterpret_cast<uintptr_t>(in) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;

  // --- load the tile, coalesced, into shared memory ---
  if (vec) {
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const int q = k * kThreads + tid;
      const int4 v = reinterpret_cast<const int4*>(in)[q];
      buf[padded(4 * q)] = (uint32_t)v.x;
      buf[padded(4 * q + 1)] = (uint32_t)v.y;
      buf[padded(4 * q + 2)] = (uint32_t)v.z;
      buf[padded(4 * q + 3)] = (uint32_t)v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = k * kThreads + tid;
      buf[padded(j)] = j < valid ? (uint32_t)in[j] : 0u;
    }
  }
  __syncthreads();

  // --- scan: items in registers, then the thread totals over the block ---
  uint32_t local[kItems];
  uint32_t run = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run += buf[padded(tid * kItems + k)];
    local[k] = run;
  }
  const uint32_t incl = warp_incl_scan(run);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_tot[lane] : 0u;
    w = warp_incl_scan(w);
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const uint32_t thread_pre =
      incl - run + (warp > 0 ? warp_tot[warp - 1] : 0u);
  const uint32_t aggregate = warp_tot[kWarps - 1];

  // --- decoupled look-back: warp 0 finds the sum of all earlier tiles ---
  if (warp == 0) {
    uint64_t* st = status + (int64_t)c * n_tiles;
    uint32_t exclusive = 0;
    if (tile == 0) {
      if (lane == 0) publish(st, kFlagPrefix, epoch, aggregate);
    } else {
      if (lane == 0) publish(st + tile, kFlagAggregate, epoch, aggregate);
      int idx = tile - 1;  // lane l reads tile idx - l
      while (true) {
        const int j = idx - lane;
        uint64_t word = kFlagPrefix | ((uint64_t)epoch << 32);  // j < 0: 0
        if (j >= 0) word = *reinterpret_cast<volatile uint64_t*>(st + j);
        const uint64_t flag = word & (3ull << 62);
        const bool ready = flag != 0 && ((word >> 32) & kEpochMask) == epoch;
        const unsigned pm =
            __ballot_sync(kFullMask, ready && flag == kFlagPrefix);
        const unsigned xm = __ballot_sync(kFullMask, !ready);
        // lanes up to the nearest prefix, or all 32 if none is ready yet
        const unsigned need = pm ? (((pm & (0u - pm)) << 1) - 1u) : kFullMask;
        if (xm & need) continue;  // a predecessor has not published yet
        exclusive += warp_sum((need >> lane) & 1u ? (uint32_t)word : 0u);
        if (pm) break;
        idx -= 32;
      }
      if (lane == 0) {
        publish(st + tile, kFlagPrefix, epoch, exclusive + aggregate);
      }
    }
    if (lane == 0) s_exclusive = exclusive;
  }
  __syncthreads();

  // --- add the prefix and store, coalesced ---
  const uint32_t pre = s_exclusive + thread_pre;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    buf[padded(tid * kItems + k)] = pre + local[k];
  }
  __syncthreads();
  if (vec) {
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const int q = k * kThreads + tid;
      int4 v;
      v.x = (int32_t)buf[padded(4 * q)];
      v.y = (int32_t)buf[padded(4 * q + 1)];
      v.z = (int32_t)buf[padded(4 * q + 2)];
      v.w = (int32_t)buf[padded(4 * q + 3)];
      reinterpret_cast<int4*>(out)[q] = v;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = k * kThreads + tid;
      if (j < valid) out[j] = (int32_t)buf[padded(j)];
    }
  }
}

}  // namespace

extern "C" {

// Elements per tile (one block's share of a channel).
int gts_scan_tile_elems(void) { return kTile; }

// ins/outs: host arrays of n_channels device pointers to int32[m].
// status: device uint64[n_channels * ceil(m / tile)] (tile:
// gts_scan_tile_elems()), words of earlier epochs or zero; counter: device uint32 holding ticket_base (the tickets
// issued so far, mod 2^32); epoch: 1 .. 2^30 - 1, not used by any word
// in status. The launch issues n_channels * ceil(m / tile) tickets.
// Returns cudaGetLastError() after the launch (0 = success).
int gts_scan_i32(const void* const* ins, void* const* outs, int n_channels,
                 int64_t m, void* status, void* counter,
                 uint32_t ticket_base, uint32_t epoch, void* stream) {
  if (n_channels < 1 || n_channels > kMaxChannels || m < 0 ||
      epoch == 0 || epoch > kEpochMask) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return (int)cudaSuccess;
  const int64_t n_tiles64 = (m + kTile - 1) / kTile;
  if (n_tiles64 * n_channels > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)n_tiles64;
  Channels ch;
  for (int c = 0; c < kMaxChannels; ++c) {
    ch.in[c] = c < n_channels ? (const int32_t*)ins[c] : nullptr;
    ch.out[c] = c < n_channels ? (int32_t*)outs[c] : nullptr;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = n_tiles * n_channels;
  scan_kernel<<<grid, kThreads, 0, s>>>(ch, m, n_tiles, (uint64_t*)status,
                                        (uint32_t*)counter, ticket_base,
                                        epoch);
  return (int)cudaGetLastError();
}

}  // extern "C"
