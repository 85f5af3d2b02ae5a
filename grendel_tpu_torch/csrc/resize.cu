// PIL's bilinear resize of uint8 images, bit for bit: the ground truth's
// resize under --resolution, on the card.
//
// Replaces no TPU kernel: the JAX package resizes its ground truth on the
// host with PIL (grendel_tpu/data/scene.py decode_image, :63,
// im.resize(size, Image.BILINEAR)), and the card's machine has no PIL.
// The function is Pillow's ImagingResample (Resample.c) for the bilinear
// filter: a horizontal pass over every input row into a uint8
// intermediate (in_h, out_w, C), then a vertical pass into the output
// (out_h, out_w, C). Each output byte is
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
// TB/s); its multiply-adds (about 5 taps an output byte a pass) take less
// at the card's integer rate.
//
// Design: the simple one. One thread per output pixel per pass, its C
// channels in registers; the tables in global memory (they are small and
// shared by a row or a column of threads, so they stay in L1). A thread
// of the horizontal pass reads its taps' pixels from one input row; the
// neighbouring threads of a warp read neighbouring pixels, so the reads
// coalesce. The vertical pass's threads of a warp read one row of the
// intermediate each tap. The intermediate (in_h * out_w * C bytes) goes
// through device memory between the two launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPrecisionBits = 22;
constexpr int kThreads = 256;

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

template <int C>
__global__ void resize_horizontal(const uint8_t* __restrict__ in,
                                  uint8_t* __restrict__ tmp, int rows,
                                  int in_w, int out_w,
                                  const int* __restrict__ bounds,
                                  const int* __restrict__ kk, int ksize) {
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)rows * out_w) return;
  int y = (int)(i / out_w), x = (int)(i - (int64_t)y * out_w);
  int first = bounds[2 * x], taps = bounds[2 * x + 1];
  const int* k = kk + (int64_t)x * ksize;
  const uint8_t* px = in + ((int64_t)y * in_w + first) * C;
  int ss[C];
#pragma unroll
  for (int c = 0; c < C; ++c) ss[c] = 1 << (kPrecisionBits - 1);
  for (int t = 0; t < taps; ++t) {
    int w = k[t];
    if (C == 4) {
      int a = px[4 * t + 3];
#pragma unroll
      for (int c = 0; c < 3; ++c) ss[c] += muldiv255(px[4 * t + c], a) * w;
      ss[3] += a * w;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) ss[c] += px[C * t + c] * w;
    }
  }
  uint8_t* o = tmp + i * C;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = (uint8_t)clip8(ss[c]);
}

template <int C>
__global__ void resize_vertical(const uint8_t* __restrict__ tmp,
                                uint8_t* __restrict__ out, int out_h,
                                int w, const int* __restrict__ bounds,
                                const int* __restrict__ kk, int ksize) {
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)out_h * w) return;
  int y = (int)(i / w), x = (int)(i - (int64_t)y * w);
  int first = bounds[2 * y], taps = bounds[2 * y + 1];
  const int* k = kk + (int64_t)y * ksize;
  const uint8_t* px = tmp + ((int64_t)first * w + x) * C;
  int ss[C];
#pragma unroll
  for (int c = 0; c < C; ++c) ss[c] = 1 << (kPrecisionBits - 1);
  for (int t = 0; t < taps; ++t) {
    int wt = k[t];
#pragma unroll
    for (int c = 0; c < C; ++c) ss[c] += px[(int64_t)t * w * C + c] * wt;
  }
  uint8_t* o = out + i * C;
  if (C == 4) {
    // Pillow's rgba2rgbA: divide the colours by alpha again
    int a = clip8(ss[3]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      int v = clip8(ss[c]);
      if (a != 0 && a != 255) v = min(255, (255 * v) / a);
      o[c] = (uint8_t)v;
    }
    o[3] = (uint8_t)a;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = (uint8_t)clip8(ss[c]);
  }
}

template <int C>
void launch(const uint8_t* in, uint8_t* tmp, uint8_t* out, int in_h,
            int in_w, int out_h, int out_w, const int* xbounds,
            const int* xk, int xksize, const int* ybounds, const int* yk,
            int yksize, cudaStream_t stream) {
  int64_t n1 = (int64_t)in_h * out_w, n2 = (int64_t)out_h * out_w;
  resize_horizontal<C><<<(unsigned)((n1 + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(in, tmp, in_h, in_w, out_w,
                                                xbounds, xk, xksize);
  resize_vertical<C><<<(unsigned)((n2 + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(tmp, out, out_h, out_w,
                                              ybounds, yk, yksize);
}

}  // namespace

extern "C" {

// in (in_h, in_w, channels) uint8, tmp (in_h, out_w, channels), out
// (out_h, out_w, channels); the bounds (out, 2) int32 and coefficients
// (out, ksize) int32 of each axis. Returns the launches' cudaError_t.
int gts_resize_bilinear(const void* in, void* tmp, void* out, int in_h,
                        int in_w, int out_h, int out_w, int channels,
                        const void* xbounds, const void* xk, int xksize,
                        const void* ybounds, const void* yk, int yksize,
                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const uint8_t*>(in);
  auto mid = static_cast<uint8_t*>(tmp);
  auto dst = static_cast<uint8_t*>(out);
  auto xb = static_cast<const int*>(xbounds);
  auto xkk = static_cast<const int*>(xk);
  auto yb = static_cast<const int*>(ybounds);
  auto ykk = static_cast<const int*>(yk);
  if (in_h * (int64_t)out_w == 0 || out_h * (int64_t)out_w == 0) return 0;
  switch (channels) {
    case 1:
      launch<1>(src, mid, dst, in_h, in_w, out_h, out_w, xb, xkk, xksize,
                yb, ykk, yksize, s);
      break;
    case 3:
      launch<3>(src, mid, dst, in_h, in_w, out_h, out_w, xb, xkk, xksize,
                yb, ykk, yksize, s);
      break;
    case 4:
      launch<4>(src, mid, dst, in_h, in_w, out_h, out_w, xb, xkk, xksize,
                yb, ykk, yksize, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
