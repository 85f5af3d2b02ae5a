// PIL's bilinear resize of uint8 images, bit for bit: the ground truth's
// resize under --resolution, on the card.
//
// Replaces no TPU kernel: the JAX package resizes its ground truth on the
// host with PIL (grendel_tpu/data/scene.py decode_image, :63,
// im.resize(size, Image.BILINEAR)), and the card's machine has no PIL.
// The function is Pillow's ImagingResample (Resample.c) for the bilinear
// filter: a horizontal pass over the input rows into a uint8
// intermediate, then a vertical pass into the output (out_h, out_w, C).
// Each output byte is
//   clip8((1 << 21) + sum over taps t of pixel[first + t] * k[t]),
// clip8(v) = 0 for v <= 0, 255 for v >= 1 << 30, else v >> 22, in 32-bit
// integers, with the 22-bit coefficients and the (first, taps) bounds of
// each output position computed on the host in double precision as
// Pillow computes them (ops/resize.py coefficients). C = 1 (grey), 3
// (RGB) or 4 (RGBA): RGBA is premultiplied by alpha as the horizontal pass
// reads it and divided again as the vertical pass writes it, as Pillow's
// resize does through its mode "RGBa". Integer arithmetic only, so the
// kernel is bit-equal to its plain version (ops/resize.py
// resize_bilinear_plain) and to PIL.
//
// Bound on an H100: bytes. The function reads the input once and writes
// the output once (1957x1091 -> 1600x891 RGB: 10.7 MB, 3.2 us at 3.35
// TB/s); its multiply-adds (a few taps an output byte a pass) take less
// at the card's integer rate.
//
// Design: one launch, and nothing between the passes in device memory.
// Each block owns a tile of tile_w x tile_h output pixels, planned on the
// host from the scale (ops/resize.py tile_plan) so that the input rows
// and columns its taps span fit in shared memory; the tile shrinks as the
// scale grows. A block
//   1. copies its span's input rows into shared memory in aligned 16-byte
//      chunks with cp.async (a chunk that crosses either end of the
//      input's allocation goes byte by byte), and its tile's coefficient
//      rows and bounds beside them, once;
//   2. runs the horizontal pass from shared memory over every row of the
//      span, into a uint8 intermediate in shared memory (clip8'd, so the
//      bytes stay Pillow's, whose intermediate is uint8 too): each thread
//      keeps one column of the tile, its coefficients in registers, and
//      walks its rows, reading its taps' bytes as aligned 32-bit words
//      shifted into place (a byte load each would make the shared loads,
//      one a clock on an SM, the limit);
//   3. runs the vertical pass four bytes of an intermediate row at a time
//      (the coefficients depend on the row alone; RGBA's four are one
//      pixel) into an output tile in shared memory, on the input's dead
//      rows, each row at its global address's offset within 16 bytes;
//   4. writes the tile's rows out as 16-byte stores, bytes only at a
//      row's unaligned ends.
// Where every position has at most 3, 4, 8 or 16 taps the tap loops are
// unrolled to that count (zero coefficients past a position's own taps);
// otherwise they run to each position's count. Several output pixels a
// thread in each pass (256 threads a block). The input rows shared by
// vertically adjacent tiles are read and passed horizontally by each of
// them: a tile of tile_h rows at scale s spans about tile_h * s + taps - 1
// input rows where tile_h * s are its own.
// A persistent, double-buffered walk over the tiles and a horizontal
// pass with a row a lane at odd strides (fewer bank conflicts) were no
// faster on an H100 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPrecisionBits = 22;
constexpr int kThreads = 256;
constexpr size_t kSmemMax = 232448;   // a Hopper block's dynamic shared max

__device__ __forceinline__ int clip8(int v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return v >> kPrecisionBits;
}

// Pillow's MULDIV255: a * b / 255, rounded
__device__ __forceinline__ int muldiv255(int a, int b) {
  int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

__host__ __device__ __forceinline__ size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// bytes past a span's last row that the horizontal pass may read: its
// taps padded to K (at most 16 of 4 bytes) and a word beyond
constexpr int kInPad = 80;

// The shared memory of a block, in order: the input rows (rows x
// row_bytes, then kInPad), which the output tile (tile_h rows of
// out_stride bytes) reuses; the intermediate (rows + K rows of mid_stride
// bytes: the vertical pass reads up to K rows from a row's first tap);
// the coefficient rows of the tile's columns and rows (int32, strides
// ksx and ksy: K, zero-padded, or the whole table row where K is 0) and
// their bounds. ops/resize.py smem_bytes computes the same total.
struct Layout {
  int mid_stride, out_stride, ksx, ksy;
  size_t mid, xk, total;
  __host__ __device__ Layout(int c, int k, int tile_w, int tile_h, int rows,
                             int row_bytes, int xks, int yks) {
    ksx = k ? k : xks;
    ksy = k ? k : yks;
    mid_stride = (tile_w * c + 3) & ~3;
    out_stride = (int)round16((size_t)tile_w * c + 18);
    size_t a = (size_t)rows * row_bytes + kInPad;
    size_t o = (size_t)tile_h * out_stride;
    mid = round16(a > o ? a : o);
    xk = mid + round16((size_t)(rows + k) * mid_stride);
    total = xk + 4 * ((size_t)tile_w * ksx + (size_t)tile_h * ksy +
                      2 * (size_t)tile_w + 2 * (size_t)tile_h);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// byte i of the little-endian words a
#define BYTE_OF(a, i) ((int)(((a)[(i) >> 2] >> (8 * ((i) & 3))) & 0xFF))

// The horizontal pass of one input row at one output column, K taps
// unrolled: the K * C bytes of the taps come from shared memory as
// aligned 32-bit words, shifted into place (a byte load for each would
// make the shared loads, one a clock on an SM, the limit). Taps past the
// column's own have zero coefficients.
template <int C, int K>
__device__ __forceinline__ void horizontal_k(const uint8_t* s, const int* kx,
                                             int* ss) {
  constexpr int kWords = (K * C + 3) / 4;
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<uintptr_t>(s) & ~(uintptr_t)3);
  const int sh = (int)(reinterpret_cast<uintptr_t>(s) & 3) * 8;
  uint32_t a[kWords];
  uint32_t lo = wp[0];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint32_t hi = wp[j + 1];
    a[j] = __funnelshift_r(lo, hi, sh);
    lo = hi;
  }
#pragma unroll
  for (int t = 0; t < K; ++t) {
    if (C == 4) {
      const int al = BYTE_OF(a, 4 * t + 3);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        ss[c] += muldiv255(BYTE_OF(a, 4 * t + c), al) * kx[t];
      ss[3] += al * kx[t];
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) ss[c] += BYTE_OF(a, C * t + c) * kx[t];
    }
  }
}

// K: the taps unrolled (every position's taps at most K), or 0: each
// position's own count, looped
template <int C, int K>
__global__ void __launch_bounds__(kThreads)
    resize_fused(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int in_h, int in_w, int out_h, int out_w,
                 const int* __restrict__ xbounds, const int* __restrict__ xk,
                 int xks, const int* __restrict__ ybounds,
                 const int* __restrict__ yk, int yks, int log_tile_w,
                 int tile_h, int rows, int row_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tile_w = 1 << log_tile_w;
  const Layout lay(C, K, tile_w, tile_h, rows, row_bytes, xks, yks);
  const int ksx = lay.ksx, ksy = lay.ksy, ms = lay.mid_stride;
  uint8_t* in_s = smem;
  uint8_t* out_s = smem;            // after the horizontal pass
  uint8_t* mid_s = smem + lay.mid;
  int* xk_s = reinterpret_cast<int*>(smem + lay.xk);
  int* yk_s = xk_s + tile_w * ksx;
  int* xb_s = yk_s + tile_h * ksy;
  int* yb_s = xb_s + 2 * tile_w;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * tile_w, y0 = blockIdx.y * tile_h;
  const int vw = min(tile_w, out_w - x0), vh = min(tile_h, out_h - y0);
  // the input span of the tile's taps: the first tap of its first
  // position to the last tap of its last (both bounds rise with the
  // position)
  const int xl = x0 + vw - 1, yl = y0 + vh - 1;
  const int xlo = xbounds[2 * x0];
  const int xhi = xbounds[2 * xl] + xbounds[2 * xl + 1];
  const int ylo = ybounds[2 * y0];
  const int n_rows = ybounds[2 * yl] + ybounds[2 * yl + 1] - ylo;
  const uintptr_t base = reinterpret_cast<uintptr_t>(in);
  const uintptr_t end = base + (size_t)in_h * in_w * C;

  // 1. the span's rows in 16-byte chunks, the tables
  const int chunks = row_bytes / 16;
  for (int i = tid; i < n_rows * chunks; i += kThreads) {
    const int r = i / chunks, j = i - r * chunks;
    const size_t row = (size_t)(ylo + r) * in_w;
    const uintptr_t a = base + (row + xlo) * C, b = base + (row + xhi) * C;
    const uintptr_t c0 = (a & ~(uintptr_t)15) + 16 * (uintptr_t)j;
    if (c0 >= b) continue;
    uint8_t* dst = in_s + (size_t)r * row_bytes + 16 * j;
    if (c0 >= base && c0 + 16 <= end) {
      cp_async16(dst, reinterpret_cast<const void*>(c0));
    } else {
      for (int q = 0; q < 16; ++q) {
        const uintptr_t p = c0 + q;
        dst[q] = (p >= base && p < end) ? *reinterpret_cast<const uint8_t*>(p)
                                        : 0;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < vw * ksx; i += kThreads) {
    const int x = i / ksx, t = i - x * ksx;
    xk_s[i] = t < xks ? xk[(size_t)(x0 + x) * xks + t] : 0;
  }
  for (int i = tid; i < vh * ksy; i += kThreads) {
    const int y = i / ksy, t = i - y * ksy;
    yk_s[i] = t < yks ? yk[(size_t)(y0 + y) * yks + t] : 0;
  }
  for (int i = tid; i < 2 * vw; i += kThreads) xb_s[i] = xbounds[2 * x0 + i];
  for (int i = tid; i < 2 * vh; i += kThreads) yb_s[i] = ybounds[2 * y0 + i];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 2. the horizontal pass: each thread keeps one column of the tile
  // (kThreads is a multiple of tile_w) and walks its rows of the span
  {
    const int x = tid & (tile_w - 1);
    if (x < vw) {
      const int first = (xb_s[2 * x] - xlo) * C;
      int kx[K > 0 ? K : 1];
#pragma unroll
      for (int t = 0; t < K; ++t) kx[t] = xk_s[x * ksx + t];
      // the offset of a row's span within its first 16-byte chunk, from
      // the low bits alone
      const unsigned lead = (unsigned)base + (unsigned)xlo * C;
      const unsigned pitch = (unsigned)in_w * C;
      for (int r = tid >> log_tile_w; r < n_rows;
           r += kThreads >> log_tile_w) {
        const unsigned off = (lead + (unsigned)(ylo + r) * pitch) & 15u;
        const uint8_t* px = in_s + r * row_bytes + off + first;
        int ss[C];
#pragma unroll
        for (int c = 0; c < C; ++c) ss[c] = 1 << (kPrecisionBits - 1);
        if (K > 0) {
          horizontal_k<C, (K > 0 ? K : 1)>(px, kx, ss);
        } else {
          const int* k = xk_s + x * ksx;
          const int taps = xb_s[2 * x + 1];
          for (int t = 0; t < taps; ++t) {
            const int w = k[t];
            if (C == 4) {
              const int al = px[4 * t + 3];
#pragma unroll
              for (int c = 0; c < 3; ++c)
                ss[c] += muldiv255(px[4 * t + c], al) * w;
              ss[3] += al * w;
            } else {
#pragma unroll
              for (int c = 0; c < C; ++c) ss[c] += px[C * t + c] * w;
            }
          }
        }
        uint8_t* o = mid_s + r * ms + x * C;
#pragma unroll
        for (int c = 0; c < C; ++c) o[c] = (uint8_t)clip8(ss[c]);
      }
    }
  }
  __syncthreads();

  // 3. the vertical pass, four bytes of a row of the intermediate at a
  // time (the coefficients depend on the row alone; RGBA's four are one
  // pixel), into the output tile at its row's offset within 16 bytes
  const unsigned olead = (unsigned)reinterpret_cast<uintptr_t>(out) +
                         (unsigned)x0 * C;
  const unsigned opitch = (unsigned)out_w * C;
  const int groups = (vw * C + 3) / 4;
  for (int i = tid; i < vh * groups; i += kThreads) {
    const int y = i / groups, g = i - y * groups;
    const int taps = K > 0 ? K : yb_s[2 * y + 1];
    const uint8_t* px = mid_s + (yb_s[2 * y] - ylo) * ms + 4 * g;
    const int* k = yk_s + y * ksy;
    int acc[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[b] = 1 << (kPrecisionBits - 1);
#pragma unroll
    for (int t = 0; t < (K > 0 ? K : taps); ++t) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(px + t * ms);
      const int kt = k[t];
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[b] += (int)((w >> (8 * b)) & 0xFF) * kt;
    }
    uint32_t v[4];
    if (C == 4) {
      // Pillow's rgba2rgbA: divide the colours by alpha again
      const int al = clip8(acc[3]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        int u = clip8(acc[c]);
        if (al != 0 && al != 255) u = min(255, (255 * u) / al);
        v[c] = (uint32_t)u;
      }
      v[3] = (uint32_t)al;
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) v[b] = (uint32_t)clip8(acc[b]);
    }
    const uint32_t packed = v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24;
    const unsigned off = (olead + (unsigned)(y0 + y) * opitch) & 15u;
    uint8_t* o = out_s + y * lay.out_stride + off + 4 * g;
    if ((off & 3) == 0) {
      *reinterpret_cast<uint32_t*>(o) = packed;
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) o[b] = (uint8_t)(packed >> (8 * b));
    }
  }
  __syncthreads();

  // 4. the tile's rows out, 16 bytes a store
  const uintptr_t obase = reinterpret_cast<uintptr_t>(out);
  const int out_chunks = lay.out_stride / 16;
  for (int i = tid; i < vh * out_chunks; i += kThreads) {
    const int y = i / out_chunks, j = i - y * out_chunks;
    const uintptr_t a = obase + ((size_t)(y0 + y) * out_w + x0) * C;
    const uintptr_t b = a + (size_t)vw * C;
    const uintptr_t c0 = (a & ~(uintptr_t)15) + 16 * (uintptr_t)j;
    if (c0 >= b) continue;
    const uint8_t* src = out_s + (size_t)y * lay.out_stride + 16 * j;
    if (c0 >= a && c0 + 16 <= b) {
      *reinterpret_cast<uint4*>(c0) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int q = 0; q < 16; ++q) {
        const uintptr_t p = c0 + q;
        if (p >= a && p < b) *reinterpret_cast<uint8_t*>(p) = src[q];
      }
    }
  }
}

template <int C, int K>
int launch(const uint8_t* in, uint8_t* out, int in_h, int in_w, int out_h,
           int out_w, const int* xbounds, const int* xk, int xks,
           const int* ybounds, const int* yk, int yks, int log_tile_w,
           int tile_h, int rows, int row_bytes, cudaStream_t stream) {
  const int tile_w = 1 << log_tile_w;
  const size_t smem =
      Layout(C, K, tile_w, tile_h, rows, row_bytes, xks, yks).total;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resize_fused<C, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((out_w + tile_w - 1) / tile_w),
                  (unsigned)((out_h + tile_h - 1) / tile_h));
  resize_fused<C, K><<<grid, kThreads, smem, stream>>>(
      in, out, in_h, in_w, out_h, out_w, xbounds, xk, xks, ybounds, yk, yks,
      log_tile_w, tile_h, rows, row_bytes);
  return (int)cudaGetLastError();
}

template <int C>
int launch_taps(int taps, const uint8_t* in, uint8_t* out, int in_h,
                int in_w, int out_h, int out_w, const int* xb, const int* xk,
                int xks, const int* yb, const int* yk, int yks,
                int log_tile_w, int tile_h, int rows, int row_bytes,
                cudaStream_t s) {
  switch (taps) {
    case 0:
      return launch<C, 0>(in, out, in_h, in_w, out_h, out_w, xb, xk, xks,
                          yb, yk, yks, log_tile_w, tile_h, rows, row_bytes,
                          s);
    case 3:
      return launch<C, 3>(in, out, in_h, in_w, out_h, out_w, xb, xk, xks,
                          yb, yk, yks, log_tile_w, tile_h, rows, row_bytes,
                          s);
    case 4:
      return launch<C, 4>(in, out, in_h, in_w, out_h, out_w, xb, xk, xks,
                          yb, yk, yks, log_tile_w, tile_h, rows, row_bytes,
                          s);
    case 8:
      return launch<C, 8>(in, out, in_h, in_w, out_h, out_w, xb, xk, xks,
                          yb, yk, yks, log_tile_w, tile_h, rows, row_bytes,
                          s);
    case 16:
      return launch<C, 16>(in, out, in_h, in_w, out_h, out_w, xb, xk, xks,
                           yb, yk, yks, log_tile_w, tile_h, rows, row_bytes,
                           s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in (in_h, in_w, channels) uint8, out (out_h, out_w, channels); the
// bounds (out, 2) int32 and coefficients (out, ksize) int32 of each axis;
// the tile plan of ops/resize.py tile_plan: tile_w = 1 << log_tile_w
// output columns and tile_h output rows a block, at most `rows` input rows
// a tile's taps span and `row_bytes` (a multiple of 16) of shared memory
// for each, and `taps`: 3, 4, 8 or 16 where every position of both axes
// has at most that many taps (unrolled), else 0. One launch. Returns its
// cudaError_t (cudaErrorInvalidValue for a plan whose shared memory
// passes a block's).
int gts_resize_bilinear(const void* in, void* out, int in_h, int in_w,
                        int out_h, int out_w, int channels,
                        const void* xbounds, const void* xk, int xksize,
                        const void* ybounds, const void* yk, int yksize,
                        int log_tile_w, int tile_h, int rows, int row_bytes,
                        int taps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const uint8_t*>(in);
  auto dst = static_cast<uint8_t*>(out);
  auto xb = static_cast<const int*>(xbounds);
  auto xkk = static_cast<const int*>(xk);
  auto yb = static_cast<const int*>(ybounds);
  auto ykk = static_cast<const int*>(yk);
  if (out_h * (int64_t)out_w == 0) return 0;
  if (log_tile_w < 0 || log_tile_w > 8 || tile_h < 1 || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  switch (channels) {
    case 1:
      return launch_taps<1>(taps, src, dst, in_h, in_w, out_h, out_w, xb,
                            xkk, xksize, yb, ykk, yksize, log_tile_w, tile_h,
                            rows, row_bytes, s);
    case 3:
      return launch_taps<3>(taps, src, dst, in_h, in_w, out_h, out_w, xb,
                            xkk, xksize, yb, ykk, yksize, log_tile_w, tile_h,
                            rows, row_bytes, s);
    case 4:
      return launch_taps<4>(taps, src, dst, in_h, in_w, out_h, out_w, xb,
                            xkk, xksize, yb, ykk, yksize, log_tile_w, tile_h,
                            rows, row_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
