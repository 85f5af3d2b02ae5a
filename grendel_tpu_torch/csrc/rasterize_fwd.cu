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
// Bound on an H100: operations. Each (entry, pixel) pair costs one expf and
// about 15 f32 operations; the bytes (40 per entry, 16 per pixel) are small
// beside that at the few hundred entries a tile holds.
//
// Design, simple first: one block per tile slot, one thread per pixel
// (512 threads at 32x16 tiles). The block loads a batch of blockDim entries
// into shared memory, each thread gathering one entry's 9 floats directly
// through gauss_ids (no payload table, which on the TPU existed only to make
// one gather of the whole entry axis), then every thread walks the batch
// from shared memory (all threads read the same word: a broadcast). The
// block leaves the span once __syncthreads_count says no pixel is live.
// Ids outside [0, n_gauss) are the sentinel and contribute nothing.
// The TPU kernel's 128-lane windows, lane-roll prefix products, Newton
// reciprocal and double-buffered DMA are not carried over.
//
// Build with --fmad=false: the plain PyTorch version (ops/rasterize_torch.py)
// rounds every product and sum separately, and the comparison on the card
// must differ by reassociation only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr int kFields = 9;  // x y a b c r g b opacity
constexpr int kMaxPixels = 1024;

__global__ void __launch_bounds__(kMaxPixels)
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
                     int tile_w, int max_per_tile,
                     float* __restrict__ out_colors,
                     float* __restrict__ out_t) {
  extern __shared__ float smem[];
  const int n = blockDim.x;  // pixels per slot == entries per batch
  float* s_x = smem;
  float* s_y = s_x + n;
  float* s_a = s_y + n;
  float* s_b = s_a + n;
  float* s_c = s_b + n;
  float* s_r = s_c + n;
  float* s_g = s_r + n;
  float* s_bl = s_g + n;
  float* s_o = s_bl + n;

  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t lo = tile_lo[slot];
  const int64_t hi = tile_hi[slot];
  const int64_t hi_eff = hi < lo + max_per_tile ? hi : lo + max_per_tile;
  const float px = (float)slot_px0[slot] + (float)(tid % tile_w);
  const float py = (float)slot_py0[slot] + (float)(tid / tile_w);

  float t = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  bool done = false;

  for (int64_t start = lo; start < hi_eff; start += n) {
    const int64_t rem = hi_eff - start;
    const int cnt = rem < n ? (int)rem : n;
    if (tid < cnt) {
      const int64_t e = start + tid;
      const int32_t id = (e >= 0 && e < n_entries) ? gauss_ids[e] : n_gauss;
      if (id >= 0 && id < n_gauss) {
        const int64_t g = id;
        s_x[tid] = means2d[2 * g];
        s_y[tid] = means2d[2 * g + 1];
        s_a[tid] = conics[3 * g];
        s_b[tid] = conics[3 * g + 1];
        s_c[tid] = conics[3 * g + 2];
        s_r[tid] = colors[3 * g];
        s_g[tid] = colors[3 * g + 1];
        s_bl[tid] = colors[3 * g + 2];
        s_o[tid] = opacities[g];
      } else {
        s_x[tid] = 0.0f;
        s_y[tid] = 0.0f;
        s_a[tid] = 0.0f;
        s_b[tid] = 0.0f;
        s_c[tid] = 0.0f;
        s_r[tid] = 0.0f;
        s_g[tid] = 0.0f;
        s_bl[tid] = 0.0f;
        s_o[tid] = 0.0f;
      }
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < cnt; ++j) {
        const float dx = px - s_x[j];
        const float dy = py - s_y[j];
        const float power =
            -0.5f * (s_a[j] * dx * dx + s_c[j] * dy * dy) - s_b[j] * dx * dy;
        if (!(power <= 0.0f)) continue;
        const float raw = s_o[j] * expf(power);
        // min(0.99, raw) that keeps a NaN, as torch.minimum does
        const float alpha = raw > kAlphaClamp ? kAlphaClamp : raw;
        if (!(alpha >= kAlphaMin)) continue;
        const float t_after = t * (1.0f - alpha);
        if (t_after < kTEps) {
          done = true;
          break;
        }
        const float w = alpha * t;
        cr = cr + w * s_r[j];
        cg = cg + w * s_g[j];
        cb = cb + w * s_bl[j];
        t = t_after;
      }
    }
    // also the barrier before the next batch overwrites shared memory
    if (__syncthreads_count(!done) == 0) break;
  }

  const int64_t pix = (int64_t)slot * n + tid;
  out_colors[3 * pix] = cr;
  out_colors[3 * pix + 1] = cg;
  out_colors[3 * pix + 2] = cb;
  out_t[pix] = t;
}

}  // namespace

extern "C" {

// Every pointer is a device pointer to a contiguous array:
// means2d f32[n_gauss*2], conics/colors f32[n_gauss*3], opacities f32[n_gauss],
// gauss_ids i32[n_entries], tile_lo/tile_hi/slot_px0/slot_py0 i32[n_slots],
// out_colors f32[n_slots*P*3], out_t f32[n_slots*P] with P = tile_w*tile_h.
// Returns cudaGetLastError() after the launch (0 = success).
int gts_rasterize_fwd(const void* means2d, const void* conics,
                      const void* colors, const void* opacities,
                      const void* gauss_ids, int64_t n_entries,
                      int32_t n_gauss, const void* tile_lo,
                      const void* tile_hi, const void* slot_px0,
                      const void* slot_py0, int n_slots, int tile_w,
                      int tile_h, int max_per_tile, void* out_colors,
                      void* out_t, void* stream) {
  const int p = tile_w * tile_h;
  if (tile_w < 1 || tile_h < 1 || p > kMaxPixels || n_slots < 0 ||
      max_per_tile < 0 || n_gauss < 0 || n_entries < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_slots == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)kFields * p * sizeof(float);
  rasterize_fwd_kernel<<<n_slots, p, smem, (cudaStream_t)stream>>>(
      (const float*)means2d, (const float*)conics, (const float*)colors,
      (const float*)opacities, (const int32_t*)gauss_ids, n_entries, n_gauss,
      (const int32_t*)tile_lo, (const int32_t*)tile_hi,
      (const int32_t*)slot_px0, (const int32_t*)slot_py0, tile_w,
      max_per_tile, (float*)out_colors, (float*)out_t);
  return (int)cudaGetLastError();
}

}  // extern "C"
