// K2: backward of the front-to-back alpha blend (the VJP of K1).
//
// Replaces grendel_tpu/ops/rasterize_pallas.py:262 _bwd_kernel (launched by
// _core_bwd:582), which writes one gradient row per entry (d_payload,
// :614-619) for the segment-sum that follows it there (:621-653). K2 does
// the same: given the forward's inputs, its outputs c_total (T, P, 3)
// (before background) and final_t (T, P), and the cotangents g (T, P, 3)
// and g_t (T, P), it stores for every entry e of a slot's span its sums
// over the slot's pixels of
//   d_means2d (2), d_conics (3), d_colors (3), d_opacity (1)
// into row e of an (n_entries, 9) float buffer (36 bytes an entry), which
// it zeroes first. K2s (segment_sum.cu) then sums each Gaussian's rows in
// ascending entry order. For every entry a pixel blended:
//   T_i    = transmittance before entry i;  w_i = alpha_i T_i
//   s_i    = sum_{j <= i} w_j (g . c_j)                  (running prefix)
//   dalpha = T_i (g . c_i) - (g . c_total - s_i + T_fin g_t) / (1 - alpha_i)
//            (0 where o exp(power) >= 0.99: the clamp)
//   dpower = dalpha alpha_i
//   d_x = dpower (a dx + b dy)   d_y = dpower (c dy + b dx)
//   d_a = -0.5 dpower dx^2   d_b = -dpower dx dy   d_c = -0.5 dpower dy^2
//   d_rgb = w_i g            d_o = dalpha exp(power)
// Ids outside [0, n_gauss) are the sentinel: their rows are zero. Spans
// must not overlap (each entry belongs to at most one slot, as in the
// reference's d_payload); entries that no span reaches, that lie past
// max_per_tile, or that a block leaves unwalked when all its pixels have
// stopped keep the zero of the memset. The list builders (ops/isect.py)
// give every entry outside the spans the sentinel id, so K2s drops them
// (the reference drops the same entries by their position, _core_bwd's
// in_span).
//
// Bound on an H100: operations. Each (entry, pixel) pair walked costs one
// expf and K1's 16 f32 operations to rebuild alpha and T; each pair the
// forward blended costs about 44 more (the gradient arithmetic and the 9
// adds that sum the pair into its entry). The bytes are a few tens of MB
// of inputs, and the rows: 36 bytes an entry written twice (the memset and
// the store).
//
// Design. The stop rule stays bit for bit: every pixel re-walks K1's exact
// sequence of f32 operations (built with --fmad=false, like K1, no fast
// exp), so it stops where K1 and the plain walk stop, and carries T and s.
// The first design (one thread per pixel, a warp on one 32x1 image row,
// 9 warp sums of 5 shuffles and 9 serial shared atomics for every entry
// any pixel of a warp blended) spent most of its time summing. Now:
//   * Each thread walks kPpt pixels (4 on a slot whose height is a
//     multiple of 16: 128 threads for a 32x16 slot) and sums their 9
//     gradients per entry in registers, in pixel order; the entry's fields
//     are read from shared memory once for all of them.
//   * A warp covers a compact patch instead of a row (8x16 at 4 pixels a
//     thread), so fewer warps find a blended pixel for an entry. The patch
//     is patch_w x 32/patch_w lanes, each lane's kPpt pixels stacked down
//     it; pick_shape takes the first of 8x16, 8x8 (2 pixels a thread), then
//     8x4, 16x2, 32x1, 4x8, 2x16 and 1x32 (1 pixel) that tiles the slot, so
//     every slot of a multiple of 32 pixels runs. Before walking an entry the
//     warp rejects it when the entry's ellipse {o exp(power) >= 1/255},
//     widened by 5%, misses the patch's pixel box; the margin keeps the
//     reject conservative, so no pixel skips an entry it would blend. The
//     shape rule, the reject and the stop rule's constants are K1's too
//     (blend_common.cuh).
//   * The 9 per-warp sums take a transposed butterfly: a reduce-scatter of
//     8 values over lanes (4 + 2 + 1 shuffles, then 2 to finish) and one
//     5-shuffle sum for the ninth, 14 shuffles instead of 45, in a fixed
//     pattern. The nine sums end on nine lanes, which write them in one
//     instruction.
//   * No shared atomics: each warp writes its nine sums for the entry into
//     its own slice of shared memory (kBatch entries a batch); after the
//     batch one pass sums the slices per entry in warp order and stores the
//     entry's row, consecutive threads on consecutive floats of the rows.
// Every sum is taken in an order fixed by the slot's shape, and no float
// atomic is used: like inputs give like bits on every run, and K2s keeps
// that through the reduction. Results agree with the plain version
// (ops/rasterize_torch.py rasterize_slots_bwd_rows) up to reassociation
// inside the slot.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (cold L2; chip_smoke.py):
// 0.967 ms on the garden's tile lists against a 0.163 ms bound, 1.438 ms
// on a training-loop step against 0.215 ms and 7.558 ms on the 4K step
// against 1.401 ms. Other designs, measured on the garden when K2 still
// added each entry's sums into its Gaussian with float atomics: the first
// design 2.92 ms; 2 pixels a thread 1.056 ms and 1 pixel 1.515 ms; shared
// atomics in place of the slices 1.218 ms; no patch reject 1.324 ms.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

using gts_blend::kAlphaClamp;
using gts_blend::kAlphaMin;
using gts_blend::kMaxPixels;
using gts_blend::kTEps;
constexpr int kGrads = 9;   // d_x d_y d_a d_b d_c d_r d_g d_b d_o: a row
constexpr int kBatch = 128;  // entries gathered into shared memory at once
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, off);
  }
  return v;
}

// Sums v[0..8] over the warp. Returns, on lane l with l % 4 == 0, the sum
// of v[k] with k = 4 bit4(l) + 2 bit3(l) + bit2(l); on lane 1, the sum of
// v[8]; elsewhere a partial sum (see grad_of_lane).
__device__ __forceinline__ float warp_sum9(const float (&v)[kGrads],
                                          int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h16 ? v[i] : v[i + 4];
    a[i] = (h16 ? v[i + 4] : v[i]) + __shfl_xor_sync(kFullMask, send, 16);
  }
  float b[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = h8 ? a[i] : a[i + 2];
    b[i] = (h8 ? a[i + 2] : a[i]) + __shfl_xor_sync(kFullMask, send, 8);
  }
  float c = (h4 ? b[1] : b[0]) +
            __shfl_xor_sync(kFullMask, h4 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(kFullMask, c, 2);
  c += __shfl_xor_sync(kFullMask, c, 1);
  const float o = warp_sum(v[8]);
  return lane == 1 ? o : c;
}

// Which of the 9 sums lane l holds after warp_sum9, or -1.
__device__ __forceinline__ int grad_of_lane(int lane) {
  if (lane == 1) return 8;
  if (lane & 3) return -1;
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

template <int kPpt>
__global__ void __launch_bounds__(kMaxPixels / kPpt)
rasterize_bwd_kernel(const float* __restrict__ means2d,
                     const float* __restrict__ conics,
                     const float* __restrict__ colors,
                     const float* __restrict__ opacities,
                     const int32_t* __restrict__ gauss_ids,
                     int64_t n_entries, int32_t n_gauss,
                     const int32_t* __restrict__ tile_lo,
                     const int32_t* __restrict__ tile_hi,
                     const int32_t* __restrict__ slot_px0,
                     const int32_t* __restrict__ slot_py0,
                     int tile_w, int patch_w, int max_per_tile,
                     const float* __restrict__ c_total,
                     const float* __restrict__ final_t,
                     const float* __restrict__ g_colors,
                     const float* __restrict__ g_t,
                     float* __restrict__ d_rows) {
  extern __shared__ float smem[];
  const int n_threads = blockDim.x;
  const int n_warps = n_threads >> 5;
  float* s_x = smem;
  float* s_y = s_x + kBatch;
  float* s_a = s_y + kBatch;
  float* s_b = s_a + kBatch;
  float* s_c = s_b + kBatch;
  float* s_r = s_c + kBatch;
  float* s_g = s_r + kBatch;
  float* s_bl = s_g + kBatch;
  float* s_o = s_bl + kBatch;
  float* s_rx = s_o + kBatch;   // the ellipse's half extents, for rejects
  float* s_ry = s_rx + kBatch;
  // the warps' slices of sums, (n_warps, kGrads, kBatch)
  float* s_d = s_ry + kBatch;

  const int lanes_h = 32 / patch_w;   // lane rows of the warp's patch
  const int patch_h = lanes_h * kPpt;
  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int my_grad = grad_of_lane(lane);
  const int64_t lo = tile_lo[slot];
  const int64_t hi = tile_hi[slot];
  const int64_t hi_eff = hi < lo + max_per_tile ? hi : lo + max_per_tile;
  const int patches_x = tile_w / patch_w;
  const int lx0 = (warp % patches_x) * patch_w;   // the warp's patch
  const int ly0 = (warp / patches_x) * patch_h;
  const float box_x0 = (float)(slot_px0[slot] + lx0);
  const float box_y0 = (float)(slot_py0[slot] + ly0);
  const float box_x1 = box_x0 + (float)(patch_w - 1);
  const float box_y1 = box_y0 + (float)(patch_h - 1);
  float* my_slice = s_d + warp * kGrads * kBatch;

  // per pixel: position, cotangent, g . c_total, T_fin * dL/dT_fin
  float px[kPpt], py[kPpt], gr[kPpt], gg[kPpt], gb[kPpt], ctg[kPpt],
      gtt[kPpt], t[kPpt], s[kPpt];
  bool done[kPpt];
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    const int lx = lx0 + lane % patch_w;
    const int ly = ly0 + lane / patch_w + lanes_h * k;
    px[k] = (float)slot_px0[slot] + (float)lx;
    py[k] = (float)slot_py0[slot] + (float)ly;
    const int64_t pix = (int64_t)slot * (n_threads * kPpt) + ly * tile_w + lx;
    gr[k] = g_colors[3 * pix];
    gg[k] = g_colors[3 * pix + 1];
    gb[k] = g_colors[3 * pix + 2];
    ctg[k] = c_total[3 * pix] * gr[k] + c_total[3 * pix + 1] * gg[k] +
             c_total[3 * pix + 2] * gb[k];
    gtt[k] = g_t[pix] * final_t[pix];
    t[k] = 1.0f;
    s[k] = 0.0f;
    done[k] = false;
  }

  for (int64_t start = lo; start < hi_eff; start += kBatch) {
    const int64_t rem = hi_eff - start;
    const int cnt = rem < kBatch ? (int)rem : kBatch;
    for (int i = tid; i < cnt; i += n_threads) {
      const int64_t e = start + i;
      const int32_t id = (e >= 0 && e < n_entries) ? gauss_ids[e] : n_gauss;
      float rx = -CUDART_INF_F, ry = -CUDART_INF_F;  // no pixel can blend it
      if (id >= 0 && id < n_gauss) {
        const int64_t g = id;
        const float a = conics[3 * g], b = conics[3 * g + 1],
                    c = conics[3 * g + 2], o = opacities[g];
        s_x[i] = means2d[2 * g];
        s_y[i] = means2d[2 * g + 1];
        s_a[i] = a;
        s_b[i] = b;
        s_c[i] = c;
        s_r[i] = colors[3 * g];
        s_g[i] = colors[3 * g + 1];
        s_bl[i] = colors[3 * g + 2];
        s_o[i] = o;
        gts_blend::blend_extent(a, b, c, o, &rx, &ry);
      } else {
        s_x[i] = s_y[i] = s_a[i] = s_b[i] = s_c[i] = 0.0f;
        s_r[i] = s_g[i] = s_bl[i] = 0.0f;
        s_o[i] = 0.0f;  // alpha 0: skipped by every pixel
      }
      s_rx[i] = rx;
      s_ry[i] = ry;
    }
    __syncthreads();

    bool live = false;
#pragma unroll
    for (int k = 0; k < kPpt; ++k) live |= !done[k];
    if (__any_sync(kFullMask, live)) {
      for (int j = 0; j < cnt; ++j) {
        float v[kGrads];
#pragma unroll
        for (int q = 0; q < kGrads; ++q) v[q] = 0.0f;
        bool blended = false;
        const float mx = s_x[j], my = s_y[j], rx = s_rx[j], ry = s_ry[j];
        const bool off_patch = gts_blend::misses_box(
            mx, my, rx, ry, box_x0, box_y0, box_x1, box_y1);
        if (!off_patch) {  // warp-uniform
#pragma unroll
          for (int k = 0; k < kPpt; ++k) {
            if (done[k]) continue;
            // K1's operations, in K1's order
            const float dx = px[k] - s_x[j];
            const float dy = py[k] - s_y[j];
            const float power = -0.5f * (s_a[j] * dx * dx + s_c[j] * dy * dy) -
                                s_b[j] * dx * dy;
            if (!(power <= 0.0f)) continue;
            const float ex = expf(power);
            const float raw = s_o[j] * ex;
            const float alpha = raw > kAlphaClamp ? kAlphaClamp : raw;
            if (!(alpha >= kAlphaMin)) continue;
            const float t_after = t[k] * (1.0f - alpha);
            if (t_after < kTEps) {
              done[k] = true;  // K1 stops here and does not blend this entry
              continue;
            }
            const float w = alpha * t[k];
            const float gc = s_r[j] * gr[k] + s_g[j] * gg[k] + s_bl[j] * gb[k];
            s[k] = s[k] + w * gc;
            float dalpha =
                t[k] * gc - (ctg[k] - s[k] + gtt[k]) / (1.0f - alpha);
            if (!(raw < kAlphaClamp)) dalpha = 0.0f;
            const float dpower = dalpha * alpha;
            v[0] += dpower * (s_a[j] * dx + s_b[j] * dy);
            v[1] += dpower * (s_c[j] * dy + s_b[j] * dx);
            v[2] += dpower * (-0.5f * dx * dx);
            v[3] += dpower * (-(dx * dy));
            v[4] += dpower * (-0.5f * dy * dy);
            v[5] += w * gr[k];
            v[6] += w * gg[k];
            v[7] += w * gb[k];
            v[8] += dalpha * ex;
            blended = true;
            t[k] = t_after;
          }
        }
        float sum = 0.0f;
        if (__any_sync(kFullMask, blended)) sum = warp_sum9(v, lane);
        if (my_grad >= 0) my_slice[my_grad * kBatch + j] = sum;
      }
    } else {
      // every pixel of the warp has stopped: its slice is zero
      for (int i = lane; i < kGrads * cnt; i += 32) {
        const int q = i / cnt;
        my_slice[q * kBatch + (i - q * cnt)] = 0.0f;
      }
    }
    __syncthreads();
    // each entry's row: the warps' slices summed in warp order, stored to
    // rows [start, start + cnt) of d_rows (kGrads * cnt consecutive floats)
    float* out = d_rows + start * kGrads;
    const int64_t n_out = start < 0 ? 0 : (n_entries - start) * kGrads;
    for (int i = tid; i < kGrads * cnt && i < n_out; i += n_threads) {
      const int j = i / kGrads;
      const int idx = (i - j * kGrads) * kBatch + j;
      float acc = s_d[idx];
      for (int w = 1; w < n_warps; ++w) acc += s_d[w * kGrads * kBatch + idx];
      out[i] = acc;
    }
    // also the barrier before the next batch overwrites shared memory
    bool any_live = false;
#pragma unroll
    for (int k = 0; k < kPpt; ++k) any_live |= !done[k];
    if (__syncthreads_count(any_live) == 0) break;
  }
}

template <int kPpt>
int launch(const void* means2d, const void* conics, const void* colors,
           const void* opacities, const void* gauss_ids, int64_t n_entries,
           int32_t n_gauss, const void* tile_lo, const void* tile_hi,
           const void* slot_px0, const void* slot_py0, int n_slots,
           int tile_w, int tile_h, int patch_w, int max_per_tile,
           const void* c_total, const void* final_t, const void* g_colors,
           const void* g_t, void* d_rows, cudaStream_t stream) {
  const int threads = tile_w * tile_h / kPpt;
  const int warps = threads / 32;
  // 11 fields per entry of a batch, then the warps' slices
  const size_t smem =
      (size_t)(11 * kBatch + warps * kGrads * kBatch) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_bwd_kernel<kPpt>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rasterize_bwd_kernel<kPpt><<<n_slots, threads, smem, stream>>>(
      (const float*)means2d, (const float*)conics, (const float*)colors,
      (const float*)opacities, (const int32_t*)gauss_ids, n_entries, n_gauss,
      (const int32_t*)tile_lo, (const int32_t*)tile_hi,
      (const int32_t*)slot_px0, (const int32_t*)slot_py0, tile_w, patch_w,
      max_per_tile, (const float*)c_total, (const float*)final_t,
      (const float*)g_colors, (const float*)g_t, (float*)d_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every pointer is a device pointer to a contiguous array:
// means2d f32[n_gauss*2], conics/colors f32[n_gauss*3], opacities f32[n_gauss],
// gauss_ids i32[n_entries], tile_lo/tile_hi/slot_px0/slot_py0 i32[n_slots],
// c_total/g_colors f32[n_slots*P*3], final_t/g_t f32[n_slots*P] with
// P = tile_w*tile_h <= 1024 and a multiple of 32; d_rows f32[n_entries*9],
// which the function zeroes (cudaMemsetAsync on the stream) before it
// stores each walked entry's row. Returns the memset's error or
// cudaGetLastError() after the launch (0 = success).
int gts_rasterize_bwd(const void* means2d, const void* conics,
                      const void* colors, const void* opacities,
                      const void* gauss_ids, int64_t n_entries,
                      int32_t n_gauss, const void* tile_lo,
                      const void* tile_hi, const void* slot_px0,
                      const void* slot_py0, int n_slots, int tile_w,
                      int tile_h, int max_per_tile, const void* c_total,
                      const void* final_t, const void* g_colors,
                      const void* g_t, void* d_rows, void* stream) {
  gts_blend::Shape shape;
  if (tile_w < 1 || tile_h < 1 || tile_w * tile_h > kMaxPixels ||
      !gts_blend::pick_shape(tile_w, tile_h, &shape) || n_slots < 0 ||
      max_per_tile < 0 || n_gauss < 0 || n_entries < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_entries > 0) {
    const cudaError_t err =
        cudaMemsetAsync(d_rows, 0, (size_t)n_entries * kGrads * sizeof(float),
                        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_slots == 0) return (int)cudaSuccess;
  auto* fn = shape.ppt == 4 ? launch<4> : shape.ppt == 2 ? launch<2>
                                                          : launch<1>;
  return fn(means2d, conics, colors, opacities, gauss_ids, n_entries,
            n_gauss, tile_lo, tile_hi, slot_px0, slot_py0, n_slots, tile_w,
            tile_h, shape.patch_w, max_per_tile, c_total, final_t, g_colors,
            g_t, d_rows, (cudaStream_t)stream);
}

}  // extern "C"
