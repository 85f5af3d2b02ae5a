// What the forward blend (K1, rasterize_fwd.cu) and its backward (K2,
// rasterize_bwd.cu) must decide alike: the stop rule's constants, the
// shape of a warp's pixel patch, and the conservative reject of an entry
// whose footprint misses a patch. K2 re-walks K1's exact f32 operations to
// find where each pixel stopped, so both kernels take these from here.

#pragma once

#include <math_constants.h>

namespace gts_blend {

constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr int kMaxPixels = 1024;

// The half extents (rx, ry) of the region where an entry can blend, for
// a patch reject. A pixel blends only where o exp(power) >= 1/255, i.e.
// where q = a dx^2 + 2b dx dy + c dy^2 <= L = 2 ln(255 o): an ellipse with
// half extents sqrt(L c / det) and sqrt(L a / det). L is widened by 5% and
// 0.01 px is added, so the reject stays conservative under f32 rounding.
// o < 1/255 (or a NaN o) never blends, as exp(power) <= 1: -inf. A nearly
// degenerate conic is never rejected: +inf. Nor is a NaN mean or conic:
// every comparison with a NaN extent or mean is false.
__device__ __forceinline__ void blend_extent(float a, float b, float c,
                                             float o, float* rx, float* ry) {
  *rx = *ry = -CUDART_INF_F;
  if (o >= kAlphaMin) {
    const float det = a * c - b * b;
    if (a > 0.0f && c > 0.0f && det > 1e-3f * a * c) {
      const float l = fmaxf(2.0f * logf(255.0f * o), 0.0f) * 1.05f + 1e-3f;
      *rx = sqrtf(l * c / det) + 1e-2f;
      *ry = sqrtf(l * a / det) + 1e-2f;
    } else {
      *rx = *ry = CUDART_INF_F;
    }
  }
}

// True when the box of an entry at (mx, my) with half extents (rx, ry)
// misses the pixel box [x0, x1] x [y0, y1]: no pixel there can blend it.
__device__ __forceinline__ bool misses_box(float mx, float my, float rx,
                                           float ry, float x0, float y0,
                                           float x1, float y1) {
  return mx + rx < x0 || mx - rx > x1 || my + ry < y0 || my - ry > y1;
}

// A warp's pixel patch and the pixels each thread walks, for a slot of
// tile_w x tile_h: the first of these that tiles it. {ppt, patch_w}; the
// patch is patch_w x 32/patch_w*ppt pixels, each lane's ppt pixels
// stacked down it 32/patch_w rows apart. Every slot of a multiple of 32
// pixels finds one.
struct Shape {
  int ppt, patch_w;
};
constexpr Shape kShapes[] = {{4, 8}, {2, 8},  {1, 8}, {1, 16},
                             {1, 32}, {1, 4}, {1, 2}, {1, 1}};

inline bool pick_shape(int tile_w, int tile_h, Shape* out) {
  for (const Shape& s : kShapes) {
    if (tile_w % s.patch_w == 0 && tile_h % (32 / s.patch_w * s.ppt) == 0) {
      *out = s;
      return true;
    }
  }
  return false;
}

}  // namespace gts_blend
