// K1: forward front-to-back alpha blend of depth-sorted tile lists.
//
// Replaces grendel_tpu/ops/rasterize_pallas.py:181 _fwd_kernel (launched by
// _fwd_impl:516, payload from _build_payload:485). For every tile slot it
// walks the entry span [lo, min(hi, lo + max_per_tile)) front to back:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy
//   alpha = min(0.99, o exp(power)); skip if power > 0 or alpha < 1/255;
//   a pixel is done at the first entry whose T (1 - alpha) < 1e-4
//   (the reference rasterizer's stop rule; that entry is not blended).
// Output: colors (T, P, 3) and final_t (T, P), pixels row-major in the slot.
// The background is composited by the caller.
//
// Bound on an H100: operations. Each (entry, pixel) pair the plain walk
// evaluates costs one expf and about 15 f32 operations; the bytes (40 per
// entry, 16 per pixel) are small beside that at the few hundred entries a
// tile holds.
//
// Design. Every pixel runs the plain walk's f32 operations in its order
// (built with --fmad=false, the accurate expf), so the result is bit-equal
// to the plain version and K2 (rasterize_bwd.cu), which re-walks them,
// finds each pixel's stop where K1 made it. The time goes to the walk, so
// the design cuts what each walked pair costs and how many are walked:
//   * Each thread walks kPpt pixels stacked down a compact warp patch,
//     picked by K2's rule (blend_common.cuh pick_shape): 4 on an 8x16
//     patch where the slot's height is a multiple of 16 (128 threads for
//     a 32x16 slot), 2 on 8x8, then 1 on 8x4, 16x2, 32x1, ... An entry is
//     read from shared memory once for all of a thread's pixels, as three
//     float4 broadcasts: (x, y, rx, ry), (a, b, c, o), (p_min, r, g, b).
//   * A warp skips every entry whose ellipse {o exp(power) >= 1/255},
//     widened, misses its patch: K2's conservative reject, shared.
//   * A pair whose power < p_min = -ln(255 o) - 1e-3 skips its expf: there
//     o exp(power) <= 0.999/255 before rounding, and expf's two ulps and
//     the product's half ulp cannot lift it to 1/255, so the exact
//     sequence would skip the pair too. A NaN power or p_min never skips.
//   * Batches of 128 entries in two buffers: while the block walks batch
//     b, batch b+1 is gathered through gauss_ids with cp.async (one 8-byte
//     and seven 4-byte copies an entry), the counterpart of the TPU
//     kernel's double-buffered chunk DMA; the half extents and p_min are
//     computed once a batch has landed. An invalid id is stored as zeros:
//     opacity 0, which no pixel blends. (On the garden it measured no
//     faster than a synchronous gather: the SM's other blocks hide it.)
//   * A thread whose pixels have all stopped does not walk, so a warp
//     whose lanes have all stopped skips the batch; the block leaves once
//     __syncthreads_count finds no live pixel.
//   * A slot whose pixel count is not a multiple of 32 takes a kernel of
//     its own: one pixel a thread, row-major, without the patch reject.
// Ids outside [0, n_gauss) are the sentinel and contribute nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

using gts_blend::kAlphaClamp;
using gts_blend::kAlphaMin;
using gts_blend::kMaxPixels;
using gts_blend::kTEps;
constexpr int kBatch = 128;          // entries a buffer holds
constexpr float kPowerMargin = 1e-3f;  // p_min's margin below -ln(255 o)

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

template <int kPpt, bool kPatch>
__global__ void __launch_bounds__(kMaxPixels / kPpt)
rasterize_fwd_kernel(const float* __restrict__ means2d,
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
                     float* __restrict__ out_colors,
                     float* __restrict__ out_t) {
  __shared__ float4 s_geo[2][kBatch];   // x y rx ry
  __shared__ float4 s_con[2][kBatch];   // a b c o
  __shared__ float4 s_col[2][kBatch];   // p_min r g b

  const int n_threads = blockDim.x;
  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t lo = tile_lo[slot];
  const int64_t hi = tile_hi[slot];
  const int64_t hi_eff = hi < lo + max_per_tile ? hi : lo + max_per_tile;
  const int ox = slot_px0[slot], oy = slot_py0[slot];

  // the thread's pixels: column lx, rows ly0 + k * lanes_h
  int lx, ly0, lanes_h = 0;
  float box_x0 = 0.0f, box_y0 = 0.0f, box_x1 = 0.0f, box_y1 = 0.0f;
  if (kPatch) {
    const int lane = tid & 31, warp = tid >> 5;
    lanes_h = 32 / patch_w;
    const int patch_h = lanes_h * kPpt;
    const int patches_x = tile_w / patch_w;
    const int qx = (warp % patches_x) * patch_w;   // the warp's patch
    const int qy = (warp / patches_x) * patch_h;
    lx = qx + lane % patch_w;
    ly0 = qy + lane / patch_w;
    box_x0 = (float)(ox + qx);
    box_y0 = (float)(oy + qy);
    box_x1 = box_x0 + (float)(patch_w - 1);
    box_y1 = box_y0 + (float)(patch_h - 1);
  } else {
    lx = tid % tile_w;
    ly0 = tid / tile_w;
  }
  float px[kPpt], py[kPpt], t[kPpt], cr[kPpt], cg[kPpt], cb[kPpt];
  bool done[kPpt];
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    px[k] = (float)ox + (float)lx;
    py[k] = (float)oy + (float)(ly0 + lanes_h * k);
    t[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    done[k] = false;
  }
  bool live = true;

  // gather entries [start, start + cnt) into buffer buf, asynchronously
  auto gather = [&](int64_t start, int buf) {
    const int64_t rem = hi_eff - start;
    const int cnt = rem < kBatch ? (int)rem : kBatch;
    for (int i = tid; i < cnt; i += n_threads) {
      const int64_t e = start + i;
      const int32_t id = (e >= 0 && e < n_entries) ? gauss_ids[e] : n_gauss;
      if (id >= 0 && id < n_gauss) {
        const int64_t g = id;
        cp_async8(&s_geo[buf][i].x, means2d + 2 * g);
        cp_async4(&s_con[buf][i].x, conics + 3 * g);
        cp_async4(&s_con[buf][i].y, conics + 3 * g + 1);
        cp_async4(&s_con[buf][i].z, conics + 3 * g + 2);
        cp_async4(&s_con[buf][i].w, opacities + g);
        cp_async4(&s_col[buf][i].y, colors + 3 * g);
        cp_async4(&s_col[buf][i].z, colors + 3 * g + 1);
        cp_async4(&s_col[buf][i].w, colors + 3 * g + 2);
      } else {
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        s_geo[buf][i] = zero;
        s_con[buf][i] = zero;
        s_col[buf][i] = zero;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  int buf = 0;
  if (lo < hi_eff) gather(lo, 0);
  for (int64_t start = lo; start < hi_eff; start += kBatch, buf ^= 1) {
    const int64_t rem = hi_eff - start;
    const int cnt = rem < kBatch ? (int)rem : kBatch;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // the batch has landed for every thread; also the barrier before the
    // next batch overwrites the buffer walked last
    if (__syncthreads_count(live) == 0) break;
    for (int i = tid; i < cnt; i += n_threads) {
      const float4 c = s_con[buf][i];
      if (kPatch) {
        float rx, ry;
        gts_blend::blend_extent(c.x, c.y, c.z, c.w, &rx, &ry);
        s_geo[buf][i].z = rx;
        s_geo[buf][i].w = ry;
      }
      // o = 0 (an invalid id too): +inf, every pair skips; a negative or
      // NaN o: NaN, no pair skips
      s_col[buf][i].x = -logf(255.0f * c.w) - kPowerMargin;
    }
    __syncthreads();
    if (start + kBatch < hi_eff) gather(start + kBatch, buf ^ 1);
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float4 geo = s_geo[buf][j];
      if (kPatch && gts_blend::misses_box(geo.x, geo.y, geo.z, geo.w, box_x0,
                                          box_y0, box_x1, box_y1)) {
        continue;  // warp-uniform
      }
      const float4 con = s_con[buf][j];
      const float p_min = s_col[buf][j].x;
      bool stopped = false;
#pragma unroll
      for (int k = 0; k < kPpt; ++k) {
        if (done[k]) continue;
        const float dx = px[k] - geo.x;
        const float dy = py[k] - geo.y;
        const float power =
            -0.5f * (con.x * dx * dx + con.z * dy * dy) - con.y * dx * dy;
        if (!(power <= 0.0f) || power < p_min) continue;
        const float raw = con.w * expf(power);
        // min(0.99, raw) that keeps a NaN, as torch.minimum does
        const float alpha = raw > kAlphaClamp ? kAlphaClamp : raw;
        if (!(alpha >= kAlphaMin)) continue;
        const float t_after = t[k] * (1.0f - alpha);
        if (t_after < kTEps) {
          done[k] = true;
          stopped = true;
          continue;
        }
        const float w = alpha * t[k];
        const float4 col = s_col[buf][j];
        cr[k] = cr[k] + w * col.y;
        cg[k] = cg[k] + w * col.z;
        cb[k] = cb[k] + w * col.w;
        t[k] = t_after;
      }
      if (stopped) {
        live = false;
#pragma unroll
        for (int k = 0; k < kPpt; ++k) live |= !done[k];
        if (!live) break;
      }
    }
  }

  const int64_t base = (int64_t)slot * (n_threads * kPpt);
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    const int64_t pix = base + (int64_t)(ly0 + lanes_h * k) * tile_w + lx;
    out_colors[3 * pix] = cr[k];
    out_colors[3 * pix + 1] = cg[k];
    out_colors[3 * pix + 2] = cb[k];
    out_t[pix] = t[k];
  }
}

template <int kPpt, bool kPatch>
int launch(const void* means2d, const void* conics, const void* colors,
           const void* opacities, const void* gauss_ids, int64_t n_entries,
           int32_t n_gauss, const void* tile_lo, const void* tile_hi,
           const void* slot_px0, const void* slot_py0, int n_slots,
           int tile_w, int tile_h, int patch_w, int max_per_tile,
           void* out_colors, void* out_t, cudaStream_t stream) {
  const int threads = tile_w * tile_h / kPpt;
  rasterize_fwd_kernel<kPpt, kPatch><<<n_slots, threads, 0, stream>>>(
      (const float*)means2d, (const float*)conics, (const float*)colors,
      (const float*)opacities, (const int32_t*)gauss_ids, n_entries, n_gauss,
      (const int32_t*)tile_lo, (const int32_t*)tile_hi,
      (const int32_t*)slot_px0, (const int32_t*)slot_py0, tile_w, patch_w,
      max_per_tile, (float*)out_colors, (float*)out_t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every pointer is a device pointer to a contiguous array:
// means2d f32[n_gauss*2] (8-byte aligned), conics/colors f32[n_gauss*3],
// opacities f32[n_gauss], gauss_ids i32[n_entries],
// tile_lo/tile_hi/slot_px0/slot_py0 i32[n_slots], out_colors
// f32[n_slots*P*3], out_t f32[n_slots*P] with P = tile_w*tile_h <= 1024.
// Returns cudaGetLastError() after the launch (0 = success).
int gts_rasterize_fwd(const void* means2d, const void* conics,
                      const void* colors, const void* opacities,
                      const void* gauss_ids, int64_t n_entries,
                      int32_t n_gauss, const void* tile_lo,
                      const void* tile_hi, const void* slot_px0,
                      const void* slot_py0, int n_slots, int tile_w,
                      int tile_h, int max_per_tile, void* out_colors,
                      void* out_t, void* stream) {
  if (tile_w < 1 || tile_h < 1 || tile_w * tile_h > kMaxPixels ||
      n_slots < 0 || max_per_tile < 0 || n_gauss < 0 || n_entries < 0 ||
      (reinterpret_cast<uintptr_t>(means2d) & 7) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_slots == 0) return (int)cudaSuccess;
  gts_blend::Shape shape;
  if (!gts_blend::pick_shape(tile_w, tile_h, &shape)) {
    shape = gts_blend::Shape{1, 0};   // not a multiple of 32 pixels
  }
  auto* fn = shape.patch_w == 0 ? launch<1, false>
             : shape.ppt == 4   ? launch<4, true>
             : shape.ppt == 2   ? launch<2, true>
                                : launch<1, true>;
  return fn(means2d, conics, colors, opacities, gauss_ids, n_entries, n_gauss,
            tile_lo, tile_hi, slot_px0, slot_py0, n_slots, tile_w, tile_h,
            shape.patch_w, max_per_tile, out_colors, out_t,
            (cudaStream_t)stream);
}

}  // extern "C"
