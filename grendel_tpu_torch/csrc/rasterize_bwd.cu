// K2: backward of the front-to-back alpha blend (the VJP of K1).
//
// Replaces grendel_tpu/ops/rasterize_pallas.py:262 _bwd_kernel (launched by
// _core_bwd:582) together with the segment-sum that follows it there
// (:621-660). Given the forward's inputs, its outputs c_total (T, P, 3)
// (before background) and final_t (T, P), and the cotangents g (T, P, 3)
// and g_t (T, P), it writes per Gaussian
//   d_means2d (2), d_conics (3), d_colors (3), d_opacity (1)
// into a zeroed (n_gauss, 9) float buffer. For every entry a pixel blended:
//   T_i    = transmittance before entry i;  w_i = alpha_i T_i
//   s_i    = sum_{j <= i} w_j (g . c_j)                  (running prefix)
//   dalpha = T_i (g . c_i) - (g . c_total - s_i + T_fin g_t) / (1 - alpha_i)
//            (0 where o exp(power) >= 0.99: the clamp)
//   dpower = dalpha alpha_i
//   d_x = dpower (a dx + b dy)   d_y = dpower (c dy + b dx)
//   d_a = -0.5 dpower dx^2   d_b = -dpower dx dy   d_c = -0.5 dpower dy^2
//   d_rgb = w_i g            d_o = dalpha exp(power)
// Ids outside [0, n_gauss) are the sentinel and contribute nothing.
//
// Bound on an H100: operations. Each (entry, pixel) pair walked costs one
// expf and K1's 16 f32 operations to rebuild alpha and T; each pair the
// forward blended costs about 44 more (the gradient arithmetic and the 9
// adds that sum the pair into its entry). The bytes are a few tens of MB.
// Beside that come the reductions over the block's pixels: 9 warp
// reductions (5 shuffles each) per entry and warp that touched it, and
// atomics.
//
// Design, simple first, the shape of K1: one block per tile slot, one
// thread per pixel; a batch of blockDim entries is gathered into shared
// memory through gauss_ids. Each thread re-walks its pixel front to back
// with K1's exact sequence of f32 operations (built with --fmad=false, like
// K1), so it stops where K1 stopped, bit for bit; it carries T and s. A
// pixel's 9 partial gradients per entry are summed over its warp with
// shuffles (warps with no blended pixel skip), lane 0 adds the warp's sums
// into a per-batch (9, blockDim) table in shared memory, and after the batch
// each entry's thread adds its nonzero sums to the Gaussian's row in device
// memory with one atomicAdd each. Blocks run in no order, so the atomics
// take the place of the TPU kernel's read-modify-write of the chunk shared
// with the previous tile, which relies on a sequential grid. The block
// leaves the span once __syncthreads_count finds no live pixel. The
// 128-lane payload table, lane-roll prefix scans, Newton reciprocal and
// double-buffered DMA of the TPU kernel are not carried over. The order of
// the float atomics changes from run to run: results agree with the plain
// version (ops/rasterize_torch.py rasterize_slots_bwd) up to reassociation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr int kFields = 9;  // x y a b c r g b opacity
constexpr int kGrads = 9;   // d_x d_y d_a d_b d_c d_r d_g d_b d_o
constexpr int kMaxPixels = 1024;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFullMask, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kMaxPixels)
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
                     int tile_w, int max_per_tile,
                     const float* __restrict__ c_total,
                     const float* __restrict__ final_t,
                     const float* __restrict__ g_colors,
                     const float* __restrict__ g_t,
                     float* __restrict__ d_out) {
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
  float* s_d = s_o + n;  // (kGrads, n): this batch's per-entry sums
  int32_t* s_id = reinterpret_cast<int32_t*>(s_d + kGrads * n);

  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t lo = tile_lo[slot];
  const int64_t hi = tile_hi[slot];
  const int64_t hi_eff = hi < lo + max_per_tile ? hi : lo + max_per_tile;
  const float px = (float)slot_px0[slot] + (float)(tid % tile_w);
  const float py = (float)slot_py0[slot] + (float)(tid / tile_w);

  const int64_t pix = (int64_t)slot * n + tid;
  const float gr = g_colors[3 * pix];
  const float gg = g_colors[3 * pix + 1];
  const float gb = g_colors[3 * pix + 2];
  // g . c_total, and T_fin * dL/dT_fin: both fixed per pixel
  const float ctg = c_total[3 * pix] * gr + c_total[3 * pix + 1] * gg +
                    c_total[3 * pix + 2] * gb;
  const float gtt = g_t[pix] * final_t[pix];

  float t = 1.0f;
  float s = 0.0f;
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
        s_id[tid] = id;
      } else {
        s_x[tid] = 0.0f;
        s_y[tid] = 0.0f;
        s_a[tid] = 0.0f;
        s_b[tid] = 0.0f;
        s_c[tid] = 0.0f;
        s_r[tid] = 0.0f;
        s_g[tid] = 0.0f;
        s_bl[tid] = 0.0f;
        s_o[tid] = 0.0f;  // alpha 0: skipped by every pixel
        s_id[tid] = -1;
      }
    }
#pragma unroll
    for (int k = 0; k < kGrads; ++k) s_d[k * n + tid] = 0.0f;
    __syncthreads();

    // warp-uniform: a warp whose pixels have all stopped adds nothing
    if (__any_sync(kFullMask, !done)) {
      for (int j = 0; j < cnt; ++j) {
        float v[kGrads];
#pragma unroll
        for (int k = 0; k < kGrads; ++k) v[k] = 0.0f;
        bool blended = false;
        if (!done) {
          // K1's operations, in K1's order
          const float dx = px - s_x[j];
          const float dy = py - s_y[j];
          const float power =
              -0.5f * (s_a[j] * dx * dx + s_c[j] * dy * dy) - s_b[j] * dx * dy;
          if (power <= 0.0f) {
            const float ex = expf(power);
            const float raw = s_o[j] * ex;
            const float alpha = raw > kAlphaClamp ? kAlphaClamp : raw;
            if (alpha >= kAlphaMin) {
              const float t_after = t * (1.0f - alpha);
              if (t_after < kTEps) {
                done = true;  // K1 stops here and does not blend this entry
              } else {
                const float w = alpha * t;
                const float gc = s_r[j] * gr + s_g[j] * gg + s_bl[j] * gb;
                s = s + w * gc;
                float dalpha = t * gc - (ctg - s + gtt) / (1.0f - alpha);
                if (!(raw < kAlphaClamp)) dalpha = 0.0f;
                const float dpower = dalpha * alpha;
                v[0] = dpower * (s_a[j] * dx + s_b[j] * dy);
                v[1] = dpower * (s_c[j] * dy + s_b[j] * dx);
                v[2] = dpower * (-0.5f * dx * dx);
                v[3] = dpower * (-(dx * dy));
                v[4] = dpower * (-0.5f * dy * dy);
                v[5] = w * gr;
                v[6] = w * gg;
                v[7] = w * gb;
                v[8] = dalpha * ex;
                blended = true;
                t = t_after;
              }
            }
          }
        }
        if (__any_sync(kFullMask, blended)) {
#pragma unroll
          for (int k = 0; k < kGrads; ++k) v[k] = warp_sum(v[k]);
          if (lane == 0) {
#pragma unroll
            for (int k = 0; k < kGrads; ++k) atomicAdd(&s_d[k * n + j], v[k]);
          }
        }
      }
    }
    __syncthreads();
    if (tid < cnt && s_id[tid] >= 0) {
      float* row = d_out + (int64_t)s_id[tid] * kGrads;
#pragma unroll
      for (int k = 0; k < kGrads; ++k) {
        const float val = s_d[k * n + tid];
        if (val != 0.0f) atomicAdd(&row[k], val);
      }
    }
    // also the barrier before the next batch overwrites shared memory
    if (__syncthreads_count(!done) == 0) break;
  }
}

}  // namespace

extern "C" {

// Every pointer is a device pointer to a contiguous array:
// means2d f32[n_gauss*2], conics/colors f32[n_gauss*3], opacities f32[n_gauss],
// gauss_ids i32[n_entries], tile_lo/tile_hi/slot_px0/slot_py0 i32[n_slots],
// c_total/g_colors f32[n_slots*P*3], final_t/g_t f32[n_slots*P] with
// P = tile_w*tile_h, a multiple of 32; d_out f32[n_gauss*9], zeroed by the
// caller. Returns cudaGetLastError() after the launch (0 = success).
int gts_rasterize_bwd(const void* means2d, const void* conics,
                      const void* colors, const void* opacities,
                      const void* gauss_ids, int64_t n_entries,
                      int32_t n_gauss, const void* tile_lo,
                      const void* tile_hi, const void* slot_px0,
                      const void* slot_py0, int n_slots, int tile_w,
                      int tile_h, int max_per_tile, const void* c_total,
                      const void* final_t, const void* g_colors,
                      const void* g_t, void* d_out, void* stream) {
  const int p = tile_w * tile_h;
  if (tile_w < 1 || tile_h < 1 || p > kMaxPixels || p % 32 != 0 ||
      n_slots < 0 || max_per_tile < 0 || n_gauss < 0 || n_entries < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_slots == 0) return (int)cudaSuccess;
  const size_t smem =
      (size_t)(kFields + kGrads) * p * sizeof(float) + (size_t)p * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rasterize_bwd_kernel<<<n_slots, p, smem, (cudaStream_t)stream>>>(
      (const float*)means2d, (const float*)conics, (const float*)colors,
      (const float*)opacities, (const int32_t*)gauss_ids, n_entries, n_gauss,
      (const int32_t*)tile_lo, (const int32_t*)tile_hi,
      (const int32_t*)slot_px0, (const int32_t*)slot_py0, tile_w,
      max_per_tile, (const float*)c_total, (const float*)final_t,
      (const float*)g_colors, (const float*)g_t, (float*)d_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
