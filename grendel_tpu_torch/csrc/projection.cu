// The projection layer on the card: activation, EWA projection and SH
// colour of every (camera, Gaussian) pair of a batch in one launch
// (project_fwd_kernel), and their vector-Jacobian product back to the raw
// parameters in one more (project_bwd_kernel).
//
// Replaces no TPU kernel: the JAX package leaves this layer to XLA
// (grendel_tpu/models/gaussian_model.py activated, ops/projection.py
// project_gaussians, ops/sh.py), which fuses it. The port's plain version
// (models/gaussian_model.py activated, then ops/projection.py
// project_gaussians_batched) runs it as a few hundred PyTorch elementwise
// launches a camera, each moving whole (N,) tensors through device
// memory, and autograd keeps dozens of those tensors for the backward.
//
// Bound on an H100: bytes. A Gaussian's raw parameters are 59 floats at
// SH degree 3 (K = 16 coefficients a channel); a pair's splat is 11
// floats. The forward reads the parameters and writes the splats, the
// backward reads the parameters, each pair's radius and its 9 upstream
// gradients and writes the 59 gradients once: at 7.95M slots and one
// camera 2.2 GB and 4.1 GB, 0.67 and 1.22 ms at 3.35 TB/s. The
// arithmetic, a few hundred float operations a pair, is a tenth of that
// at 67 TFLOP/s.
//
// Design:
//   * forward: one thread a (camera, slot) pair, blockIdx.y the camera.
//     The activation (exp, sigmoid, the quaternion's normalisation and
//     the SH concatenation) happens in registers. The formulas, and the
//     order of every product and sum, are the plain version's, each
//     rounded on its own (nvcc --fmad=false), with the products and sums
//     that PyTorch leaves to cuBLAS and to its reductions formed as they
//     form them (dot3, dot3_mv, sum4, sum3), so that a slot's cull and
//     radius come out as the plain version's.
//   * backward: one thread a Gaussian, looping over the B cameras. It
//     recomputes the forward's intermediates in registers (nothing but
//     the inputs and the radii is saved) and skips every pair whose
//     radius is 0: the render path gives such a pair no gradient (it is
//     in no tile list and its opacity is masked). The gradients of the
//     raw leaves are summed over the cameras in registers and written
//     once: no atomics, so the result is deterministic, and one launch
//     whatever B is.
//   * the SH rows ((K-1)*3 floats a Gaussian, 180 bytes at K = 16) go
//     through shared memory: a block's rows are one contiguous stretch,
//     copied in (and their gradients out) as 16-byte vectors, so a warp
//     touches whole lines; a thread then reads its row at a stride of
//     (K-1)*3 words, without bank conflicts where that is odd.
//   * the active SH degree (0 to 3) is a template parameter; at degree 0
//     neither kernel reads the rows beyond the DC band, and the backward
//     writes their gradients as zeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// the plain version's Python constants, rounded to float32 as PyTorch
// rounds a Python scalar for a float32 tensor
constexpr float kNearCull = static_cast<float>(0.2);
constexpr float kDilation = static_cast<float>(0.3);
constexpr float kLimit = static_cast<float>(1.3);
constexpr float kWEps = static_cast<float>(1e-7);
constexpr float kNormEps = static_cast<float>(1e-12);
constexpr float kLamFloor = static_cast<float>(0.1);

// ops/sh.py's real SH basis constants
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kC20 = static_cast<float>(1.0925484305920792);
constexpr float kC21 = static_cast<float>(-1.0925484305920792);
constexpr float kC22 = static_cast<float>(0.31539156525252005);
constexpr float kC23 = static_cast<float>(-1.0925484305920792);
constexpr float kC24 = static_cast<float>(0.5462742152960396);
constexpr float kC30 = static_cast<float>(-0.5900435899266435);
constexpr float kC31 = static_cast<float>(2.890611442640554);
constexpr float kC32 = static_cast<float>(-0.4570457994644658);
constexpr float kC33 = static_cast<float>(0.3731763325901154);
constexpr float kC34 = static_cast<float>(-0.4570457994644658);
constexpr float kC35 = static_cast<float>(1.445305721320277);
constexpr float kC36 = static_cast<float>(-0.5900435899266435);

// torch.maximum / torch.minimum / torch.clamp(min=): a NaN propagates
__host__ __device__ inline float t_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__host__ __device__ inline float t_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// the card's float32 products as PyTorch forms them, found bit-equal on
// an H100 over 2^18 random rows: a coordinate of (N,3) x (3,3)^T (a GEMM
// kernel, fused multiply-adds along k) ...
__host__ __device__ inline float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

// ... and (N,3) x (3,) (a GEMV kernel: two terms fused, the third added)
__host__ __device__ inline float dot3_mv(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  return fmaf(a1, b1, a0 * b0) + a2 * b2;
}

// torch.sum over a last axis of 4, and of 3, as PyTorch's reduction on
// the card adds them (bit-equal on an H100 likewise): lanes strided by a
// power of two, then a shuffle tree
__host__ __device__ inline float sum4(float a0, float a1, float a2,
                                      float a3) {
  return (a0 + a2) + (a1 + a3);
}

__host__ __device__ inline float sum3(float a0, float a1, float a2) {
  return (a0 + a2) + a1;
}

// one Gaussian's activated parameters
struct Gauss {
  float m[3];    // mean
  float e[3];    // exp(scales_raw)
  float s[3];    // e * scale_modifier
  float q[4];    // raw quaternion [w, x, y, z]
  float qn[4];   // q / nq
  float nq;      // sqrt(sum q^2) + 1e-12
  float r[9];    // rotation matrix of qn, row-major
  float sig;     // sigmoid(opacities_raw)
};

__host__ __device__ inline void activate(const float* m, const float* sr,
                                         const float* q, float o_raw,
                                         float mod, Gauss& g) {
  for (int k = 0; k < 3; ++k) {
    g.m[k] = m[k];
    g.e[k] = expf(sr[k]);
    g.s[k] = g.e[k] * mod;
  }
  for (int k = 0; k < 4; ++k) g.q[k] = q[k];
  g.nq = sqrtf(sum4(q[0] * q[0], q[1] * q[1], q[2] * q[2], q[3] * q[3]))
         + kNormEps;
  for (int k = 0; k < 4; ++k) g.qn[k] = q[k] / g.nq;
  const float w = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
  g.r[0] = 1.0f - 2.0f * (y * y + z * z);
  g.r[1] = 2.0f * (x * y - w * z);
  g.r[2] = 2.0f * (x * z + w * y);
  g.r[3] = 2.0f * (x * y + w * z);
  g.r[4] = 1.0f - 2.0f * (x * x + z * z);
  g.r[5] = 2.0f * (y * z - w * x);
  g.r[6] = 2.0f * (x * z - w * y);
  g.r[7] = 2.0f * (y * z + w * x);
  g.r[8] = 1.0f - 2.0f * (x * x + y * y);
  g.sig = 1.0f / (1.0f + expf(-o_raw));
}

// one camera: the first three rows of the view matrix, the projection,
// the centre and the plain version's focal lengths and tangent limits
struct Cam {
  float w[12];
  float p[16];
  float c[3];
  float fx, fy, limx, limy;
};

__host__ __device__ inline void load_cam(const float* view,
                                         const float* proj,
                                         const float* pos,
                                         const float* tanfov, int img_h,
                                         int img_w, Cam& cam) {
  for (int k = 0; k < 12; ++k) cam.w[k] = view[k];
  for (int k = 0; k < 16; ++k) cam.p[k] = proj[k];
  for (int k = 0; k < 3; ++k) cam.c[k] = pos[k];
  // img_w / (2.0 * tanfovx) is reciprocal(2 tanfovx) * img_w in PyTorch
  cam.fx = (1.0f / (2.0f * tanfov[0])) * static_cast<float>(img_w);
  cam.fy = (1.0f / (2.0f * tanfov[1])) * static_cast<float>(img_h);
  cam.limx = kLimit * tanfov[0];
  cam.limy = kLimit * tanfov[1];
}

// a pair's forward intermediates
struct Geo {
  float pv[3];            // view-space point
  float ph0, ph1, rw;     // projected x, y and 1 / (w + 1e-7)
  float mx, my;           // pixel mean
  float z;                // depth where in front, else 1
  float txz, tyz;         // view x / z, y / z
  float ctx, cty;         // the same clamped to the Jacobian's limits
  float iz, iz2;
  float j00, j02, j11, j12;
  float u[3][3];          // u[j] = W (column j of R)
  float v00, v01, v02, v11, v12, v22;
  float c00, c01, c11;    // 2D covariance, dilated
  float inv_det;
  float radius;
  bool visible;
};

__host__ __device__ inline void project_pair(const Gauss& g, const Cam& cam,
                                             bool alive, int img_h,
                                             int img_w, Geo& o) {
  const float* w = cam.w;
  const float* p = cam.p;
  const float* m = g.m;
  // view transform and frustum cull
  for (int i = 0; i < 3; ++i)
    o.pv[i] = dot3(m[0], m[1], m[2], w[4 * i], w[4 * i + 1], w[4 * i + 2])
              + w[4 * i + 3];
  const float depth = o.pv[2];
  const bool in_front = depth > kNearCull;
  // screen-space mean via the full projection
  o.ph0 = dot3(m[0], m[1], m[2], p[0], p[1], p[2]) + p[3];
  o.ph1 = dot3(m[0], m[1], m[2], p[4], p[5], p[6]) + p[7];
  const float wh = dot3_mv(m[0], m[1], m[2], p[12], p[13], p[14]) + p[15];
  o.rw = 1.0f / (wh + kWEps);
  const float ndc0 = o.ph0 * o.rw;
  const float ndc1 = o.ph1 * o.rw;
  o.mx = ((ndc0 + 1.0f) * static_cast<float>(img_w) - 1.0f) * 0.5f;
  o.my = ((ndc1 + 1.0f) * static_cast<float>(img_h) - 1.0f) * 0.5f;
  // 2D covariance via the EWA Jacobian
  o.z = in_front ? depth : 1.0f;
  o.txz = o.pv[0] / o.z;
  o.tyz = o.pv[1] / o.z;
  o.ctx = t_min(t_max(o.txz, -cam.limx), cam.limx);
  o.cty = t_min(t_max(o.tyz, -cam.limy), cam.limy);
  const float tx = o.ctx * o.z;
  const float ty = o.cty * o.z;
  o.iz = 1.0f / o.z;
  o.iz2 = o.iz * o.iz;
  o.j00 = cam.fx * o.iz;
  o.j02 = (-cam.fx * tx) * o.iz2;
  o.j11 = cam.fy * o.iz;
  o.j12 = (-cam.fy * ty) * o.iz2;
  // V = W R S S^T R^T W^T = sum_j s_j^2 u_j u_j^T
  o.v00 = o.v01 = o.v02 = o.v11 = o.v12 = o.v22 = 0.0f;
  for (int j = 0; j < 3; ++j) {
    const float r0 = g.r[j], r1 = g.r[3 + j], r2 = g.r[6 + j];
    for (int i = 0; i < 3; ++i)
      o.u[j][i] = (w[4 * i] * r0 + w[4 * i + 1] * r1) + w[4 * i + 2] * r2;
    const float sj = g.s[j] * g.s[j];
    const float a = sj * o.u[j][0], b = sj * o.u[j][1], c = sj * o.u[j][2];
    o.v00 = o.v00 + a * o.u[j][0];
    o.v01 = o.v01 + a * o.u[j][1];
    o.v02 = o.v02 + a * o.u[j][2];
    o.v11 = o.v11 + b * o.u[j][1];
    o.v12 = o.v12 + b * o.u[j][2];
    o.v22 = o.v22 + c * o.u[j][2];
  }
  const float j00 = o.j00, j02 = o.j02, j11 = o.j11, j12 = o.j12;
  const float c00 = j00 * (j00 * o.v00 + j02 * o.v02)
                    + j02 * (j00 * o.v02 + j02 * o.v22);
  const float c01 = j00 * (j11 * o.v01 + j12 * o.v02)
                    + j02 * (j11 * o.v12 + j12 * o.v22);
  const float c11 = j11 * (j11 * o.v11 + j12 * o.v12)
                    + j12 * (j11 * o.v12 + j12 * o.v22);
  o.c00 = c00 + kDilation;
  o.c01 = c01;
  o.c11 = c11 + kDilation;
  const float det = o.c00 * o.c11 - o.c01 * o.c01;
  const bool det_ok = det > 0.0f;
  const float safe_det = det_ok ? det : 1.0f;
  o.inv_det = 1.0f / safe_det;
  // 3-sigma radius from the larger eigenvalue
  const float mid = 0.5f * (o.c00 + o.c11);
  const float lam1 = mid + sqrtf(t_max(mid * mid - safe_det, kLamFloor));
  o.radius = ceilf(3.0f * sqrtf(lam1));
  const bool on_screen = (o.mx + o.radius > 0.0f)
                         && (o.mx - o.radius < static_cast<float>(img_w))
                         && (o.my + o.radius > 0.0f)
                         && (o.my - o.radius < static_cast<float>(img_h));
  o.visible = in_front && det_ok && on_screen && alive;
}

// the unit view direction camera -> point, with the norm's pieces
struct Dir {
  float d[3];   // point - camera
  float len;    // sqrt(sum d^2)
  float n;      // len + 1e-12
  float x, y, z;
};

__host__ __device__ inline void view_dir(const float* m, const float* c,
                                         Dir& v) {
  for (int k = 0; k < 3; ++k) v.d[k] = m[k] - c[k];
  v.len = sqrtf(sum3(v.d[0] * v.d[0], v.d[1] * v.d[1], v.d[2] * v.d[2]));
  v.n = v.len + kNormEps;
  v.x = v.d[0] / v.n;
  v.y = v.d[1] / v.n;
  v.z = v.d[2] / v.n;
}

// coefficient k (0 = DC) of channel ch: the DC band and the rest's row
__host__ __device__ inline float coef(const float* dc, const float* rest,
                                      int k, int ch) {
  return k == 0 ? dc[ch] : rest[(k - 1) * 3 + ch];
}

// ops/sh.py eval_sh of one channel, before the +0.5 shift, term by term
// in the plain version's order
template <int DEG>
__host__ __device__ inline float eval_sh(const float* dc, const float* rest,
                                         int ch, float x, float y,
                                         float z) {
  float r = kC0 * dc[ch];
  if constexpr (DEG >= 1) {
    r = r - (kC1 * y) * coef(dc, rest, 1, ch);
    r = r + (kC1 * z) * coef(dc, rest, 2, ch);
    r = r - (kC1 * x) * coef(dc, rest, 3, ch);
  }
  if constexpr (DEG >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    r = r + (kC20 * xy) * coef(dc, rest, 4, ch);
    r = r + (kC21 * yz) * coef(dc, rest, 5, ch);
    r = r + (kC22 * ((2.0f * zz - xx) - yy)) * coef(dc, rest, 6, ch);
    r = r + (kC23 * xz) * coef(dc, rest, 7, ch);
    r = r + (kC24 * (xx - yy)) * coef(dc, rest, 8, ch);
    if constexpr (DEG >= 3) {
      r = r + ((kC30 * y) * (3.0f * xx - yy)) * coef(dc, rest, 9, ch);
      r = r + ((kC31 * xy) * z) * coef(dc, rest, 10, ch);
      r = r + ((kC32 * y) * ((4.0f * zz - xx) - yy))
              * coef(dc, rest, 11, ch);
      r = r + ((kC33 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy))
              * coef(dc, rest, 12, ch);
      r = r + ((kC34 * x) * ((4.0f * zz - xx) - yy))
              * coef(dc, rest, 13, ch);
      r = r + ((kC35 * z) * (xx - yy)) * coef(dc, rest, 14, ch);
      r = r + ((kC36 * x) * (xx - 3.0f * yy)) * coef(dc, rest, 15, ch);
    }
  }
  return r;
}

// the SH basis functions of degree <= DEG at a direction, and their
// derivatives by x, y and z
template <int DEG>
__host__ __device__ inline void sh_basis(float x, float y, float z,
                                         float* b, float* bx, float* by,
                                         float* bz) {
  b[0] = kC0;
  bx[0] = by[0] = bz[0] = 0.0f;
  if constexpr (DEG >= 1) {
    b[1] = -kC1 * y; bx[1] = 0.0f;     by[1] = -kC1;    bz[1] = 0.0f;
    b[2] = kC1 * z;  bx[2] = 0.0f;     by[2] = 0.0f;    bz[2] = kC1;
    b[3] = -kC1 * x; bx[3] = -kC1;     by[3] = 0.0f;    bz[3] = 0.0f;
  }
  if constexpr (DEG >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    b[4] = kC20 * x * y;
    bx[4] = kC20 * y; by[4] = kC20 * x; bz[4] = 0.0f;
    b[5] = kC21 * y * z;
    bx[5] = 0.0f; by[5] = kC21 * z; bz[5] = kC21 * y;
    b[6] = kC22 * (2.0f * zz - xx - yy);
    bx[6] = -2.0f * kC22 * x; by[6] = -2.0f * kC22 * y;
    bz[6] = 4.0f * kC22 * z;
    b[7] = kC23 * x * z;
    bx[7] = kC23 * z; by[7] = 0.0f; bz[7] = kC23 * x;
    b[8] = kC24 * (xx - yy);
    bx[8] = 2.0f * kC24 * x; by[8] = -2.0f * kC24 * y; bz[8] = 0.0f;
    if constexpr (DEG >= 3) {
      b[9] = kC30 * y * (3.0f * xx - yy);
      bx[9] = 6.0f * kC30 * x * y;
      by[9] = 3.0f * kC30 * (xx - yy);
      bz[9] = 0.0f;
      b[10] = kC31 * x * y * z;
      bx[10] = kC31 * y * z; by[10] = kC31 * x * z; bz[10] = kC31 * x * y;
      b[11] = kC32 * y * (4.0f * zz - xx - yy);
      bx[11] = -2.0f * kC32 * x * y;
      by[11] = kC32 * (4.0f * zz - xx - 3.0f * yy);
      bz[11] = 8.0f * kC32 * y * z;
      b[12] = kC33 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      bx[12] = -6.0f * kC33 * x * z;
      by[12] = -6.0f * kC33 * y * z;
      bz[12] = kC33 * (6.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = kC34 * x * (4.0f * zz - xx - yy);
      bx[13] = kC34 * (4.0f * zz - 3.0f * xx - yy);
      by[13] = -2.0f * kC34 * x * y;
      bz[13] = 8.0f * kC34 * x * z;
      b[14] = kC35 * z * (xx - yy);
      bx[14] = 2.0f * kC35 * x * z; by[14] = -2.0f * kC35 * y * z;
      bz[14] = kC35 * (xx - yy);
      b[15] = kC36 * x * (xx - 3.0f * yy);
      bx[15] = 3.0f * kC36 * (xx - yy);
      by[15] = -6.0f * kC36 * x * y;
      bz[15] = 0.0f;
    }
  }
}

// gradients of one Gaussian's activated values, summed over its cameras
struct Grad {
  float m[3];    // mean
  float s[3];    // e * scale_modifier
  float r[9];    // rotation entries
  float sig;     // opacity after the sigmoid
  float dc[3];   // SH DC band
};

// one visible pair's vector-Jacobian product, added to acc (and to the
// SH rest's gradient row grest); gm, gcon, gcol and go are the pair's
// upstream gradients of means2d, conics, colors and opacities
template <int DEG>
__host__ __device__ inline void pair_vjp(const Gauss& g, const Cam& cam,
                                         const Geo& o, const float* dc,
                                         const float* rest, const float* gm,
                                         const float* gcon,
                                         const float* gcol, float go,
                                         int img_h, int img_w, Grad& acc,
                                         float* grest) {
  acc.sig += go;

  // SH colour: clamp(eval + 0.5, min=0) passes the gradient where >= 0
  constexpr int kBases = (DEG + 1) * (DEG + 1);
  Dir v;
  view_dir(g.m, cam.c, v);
  float gch[3];
  for (int ch = 0; ch < 3; ++ch) {
    const float pre = eval_sh<DEG>(dc, rest, ch, v.x, v.y, v.z) + 0.5f;
    gch[ch] = pre >= 0.0f ? gcol[ch] : 0.0f;
  }
  float b[kBases], bx[kBases], by[kBases], bz[kBases];
  sh_basis<DEG>(v.x, v.y, v.z, b, bx, by, bz);
  float gdx = 0.0f, gdy = 0.0f, gdz = 0.0f;
  for (int ch = 0; ch < 3; ++ch) acc.dc[ch] += b[0] * gch[ch];
  for (int k = 1; k < kBases; ++k) {
    float gk = 0.0f;
    for (int ch = 0; ch < 3; ++ch) {
      grest[(k - 1) * 3 + ch] += b[k] * gch[ch];
      gk += rest[(k - 1) * 3 + ch] * gch[ch];
    }
    gdx += gk * bx[k];
    gdy += gk * by[k];
    gdz += gk * bz[k];
  }
  if constexpr (DEG >= 1) {
    // dir = d / (|d| + 1e-12)
    const float dot = gdx * v.d[0] + gdy * v.d[1] + gdz * v.d[2];
    const float f = v.len > 0.0f ? dot / (v.n * v.n * v.len) : 0.0f;
    acc.m[0] += gdx / v.n - v.d[0] * f;
    acc.m[1] += gdy / v.n - v.d[1] * f;
    acc.m[2] += gdz / v.n - v.d[2] * f;
  }

  // means2d = ((p_hom[:2] * rw + 1) * size - 1) / 2
  const float gn0 = gm[0] * 0.5f * static_cast<float>(img_w);
  const float gn1 = gm[1] * 0.5f * static_cast<float>(img_h);
  const float gph0 = gn0 * o.rw;
  const float gph1 = gn1 * o.rw;
  const float grw = gn0 * o.ph0 + gn1 * o.ph1;
  const float gwh = -grw * o.rw * o.rw;

  // conic = (c11, -c01, c00) / det
  float gc00 = gcon[2] * o.inv_det;
  float gc01 = -gcon[1] * o.inv_det;
  float gc11 = gcon[0] * o.inv_det;
  const float ginv = gcon[0] * o.c11 - gcon[1] * o.c01 + gcon[2] * o.c00;
  const float gdet = -ginv * o.inv_det * o.inv_det;
  gc00 += gdet * o.c11;
  gc11 += gdet * o.c00;
  gc01 -= 2.0f * gdet * o.c01;

  // c = J V J^T with J = [[j00, 0, j02], [0, j11, j12]]
  const float j00 = o.j00, j02 = o.j02, j11 = o.j11, j12 = o.j12;
  const float gv00 = gc00 * j00 * j00;
  const float gv01 = gc01 * j00 * j11;
  const float gv02 = gc00 * 2.0f * j00 * j02 + gc01 * j00 * j12;
  const float gv11 = gc11 * j11 * j11;
  const float gv12 = gc01 * j02 * j11 + gc11 * 2.0f * j11 * j12;
  const float gv22 = gc00 * j02 * j02 + gc01 * j02 * j12 + gc11 * j12 * j12;
  const float gj00 = gc00 * 2.0f * (j00 * o.v00 + j02 * o.v02)
                     + gc01 * (j11 * o.v01 + j12 * o.v02);
  const float gj02 = gc00 * 2.0f * (j00 * o.v02 + j02 * o.v22)
                     + gc01 * (j11 * o.v12 + j12 * o.v22);
  const float gj11 = gc11 * 2.0f * (j11 * o.v11 + j12 * o.v12)
                     + gc01 * (j00 * o.v01 + j02 * o.v12);
  const float gj12 = gc11 * 2.0f * (j11 * o.v12 + j12 * o.v22)
                     + gc01 * (j00 * o.v02 + j02 * o.v22);

  // J of iz = 1 / z and t = clamp(t / z, -lim, lim) * z
  const float tx = o.ctx * o.z, ty = o.cty * o.z;
  const float giz = gj00 * cam.fx + gj11 * cam.fy
                    + (gj02 * (-cam.fx * tx) + gj12 * (-cam.fy * ty))
                      * 2.0f * o.iz;
  const float gtx = gj02 * (-cam.fx) * o.iz2;
  const float gty = gj12 * (-cam.fy) * o.iz2;
  float gz = -giz * o.iz2 + gtx * o.ctx + gty * o.cty;
  float gpv0 = 0.0f, gpv1 = 0.0f;
  if (o.txz > -cam.limx && o.txz < cam.limx) {
    const float gt = gtx * o.z;
    gpv0 = gt / o.z;
    gz -= gt * o.txz / o.z;
  }
  if (o.tyz > -cam.limy && o.tyz < cam.limy) {
    const float gt = gty * o.z;
    gpv1 = gt / o.z;
    gz -= gt * o.tyz / o.z;
  }
  const float gpv[3] = {gpv0, gpv1, gz};

  // p_view = W m + t; p_hom = P m + p
  const float* w = cam.w;
  const float* p = cam.p;
  for (int k = 0; k < 3; ++k)
    acc.m[k] += w[k] * gpv[0] + w[4 + k] * gpv[1] + w[8 + k] * gpv[2]
                + p[k] * gph0 + p[4 + k] * gph1 + p[12 + k] * gwh;

  // V = sum_j s_j^2 u_j u_j^T, u_j = W R[:, j]
  for (int j = 0; j < 3; ++j) {
    const float u0 = o.u[j][0], u1 = o.u[j][1], u2 = o.u[j][2];
    const float sj = g.s[j] * g.s[j];
    const float gs2 = gv00 * u0 * u0 + gv01 * u0 * u1 + gv02 * u0 * u2
                      + gv11 * u1 * u1 + gv12 * u1 * u2 + gv22 * u2 * u2;
    acc.s[j] += 2.0f * g.s[j] * gs2;
    const float gu0 = sj * (2.0f * gv00 * u0 + gv01 * u1 + gv02 * u2);
    const float gu1 = sj * (gv01 * u0 + 2.0f * gv11 * u1 + gv12 * u2);
    const float gu2 = sj * (gv02 * u0 + gv12 * u1 + 2.0f * gv22 * u2);
    for (int k = 0; k < 3; ++k)
      acc.r[3 * k + j] += w[k] * gu0 + w[4 + k] * gu1 + w[8 + k] * gu2;
  }
}

// the camera-independent end of the backward: the gradients of the raw
// scales, quaternion and opacity from those of the activated values
__host__ __device__ inline void finish_vjp(const Gauss& g, const Grad& acc,
                                           float mod, float* d_scales_raw,
                                           float* d_quats,
                                           float* d_opacity_raw) {
  // s = exp(raw) * mod
  for (int k = 0; k < 3; ++k) d_scales_raw[k] = acc.s[k] * mod * g.e[k];
  // rotation entries of the normalised quaternion
  const float w = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
  const float* gr = acc.r;
  const float gw = 2.0f * (-z * gr[1] + y * gr[2] + z * gr[3] - x * gr[5]
                           - y * gr[6] + x * gr[7]);
  const float gx = 2.0f * (y * gr[1] + z * gr[2] + y * gr[3]
                           - 2.0f * x * gr[4] - w * gr[5] + z * gr[6]
                           + w * gr[7] - 2.0f * x * gr[8]);
  const float gy = 2.0f * (-2.0f * y * gr[0] + x * gr[1] + w * gr[2]
                           + x * gr[3] + z * gr[5] - w * gr[6] + z * gr[7]
                           - 2.0f * y * gr[8]);
  const float gz = 2.0f * (-2.0f * z * gr[0] - w * gr[1] + x * gr[2]
                           + w * gr[3] - 2.0f * z * gr[4] + y * gr[5]
                           + x * gr[6] + y * gr[7]);
  // qn = q / (|q| + 1e-12)
  const float len = g.nq - kNormEps;
  const float dot = gw * g.q[0] + gx * g.q[1] + gy * g.q[2] + gz * g.q[3];
  const float f = len > 0.0f ? dot / (g.nq * g.nq * len) : 0.0f;
  d_quats[0] = gw / g.nq - g.q[0] * f;
  d_quats[1] = gx / g.nq - g.q[1] * f;
  d_quats[2] = gy / g.nq - g.q[2] * f;
  d_quats[3] = gz / g.nq - g.q[3] * f;
  *d_opacity_raw = acc.sig * (1.0f - g.sig) * g.sig;
}

// copy `count` floats between device memory and shared memory, 16 bytes a
// thread where both ends allow (a block's stretch of SH rows starts
// 16-byte aligned), the ragged end one float a thread
__device__ inline void copy_rows(const float* __restrict__ src, int count,
                                 float* __restrict__ dst) {
  const int n4 = count >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int k = threadIdx.x; k < n4; k += kThreads) d4[k] = s4[k];
  for (int k = 4 * n4 + threadIdx.x; k < count; k += kThreads)
    dst[k] = src[k];
}

template <int DEG>
__global__ void __launch_bounds__(kThreads) project_fwd_kernel(
    const float* __restrict__ means3d, const float* __restrict__ scales_raw,
    const float* __restrict__ quats, const float* __restrict__ opacities_raw,
    const float* __restrict__ sh_dc, const float* __restrict__ sh_rest,
    const uint8_t* __restrict__ alive, const float* __restrict__ viewmat,
    const float* __restrict__ full_proj, const float* __restrict__ campos,
    const float* __restrict__ tanfov, int64_t n, int k_rest, int img_h,
    int img_w, float mod, float* __restrict__ means2d,
    float* __restrict__ conics, float* __restrict__ colors,
    float* __restrict__ opacities, float* __restrict__ depths,
    int* __restrict__ radii) {
  extern __shared__ float4 smem4[];
  float* rest_s = reinterpret_cast<float*>(smem4);
  const int nrest = 3 * k_rest;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows = n - base < kThreads ? static_cast<int>(n - base)
                                       : kThreads;
  if constexpr (DEG > 0) {
    copy_rows(sh_rest + base * nrest, rows * nrest, rest_s);
    __syncthreads();
  }
  const int t = threadIdx.x;
  const int64_t i = base + t;
  if (t >= rows) return;
  const int b = blockIdx.y;
  Gauss g;
  activate(means3d + 3 * i, scales_raw + 3 * i, quats + 4 * i,
           opacities_raw[i], mod, g);
  Cam cam;
  load_cam(viewmat + 16 * b, full_proj + 16 * b, campos + 3 * b,
           tanfov + 2 * b, img_h, img_w, cam);
  Geo o;
  project_pair(g, cam, alive[i] != 0, img_h, img_w, o);
  Dir v;
  view_dir(g.m, cam.c, v);
  const float* dc = sh_dc + 3 * i;
  const float* rest = rest_s + t * nrest;

  const int64_t out = static_cast<int64_t>(b) * n + i;
  reinterpret_cast<float2*>(means2d)[out] = make_float2(o.mx, o.my);
  conics[3 * out + 0] = o.c11 * o.inv_det;
  conics[3 * out + 1] = -o.c01 * o.inv_det;
  conics[3 * out + 2] = o.c00 * o.inv_det;
  for (int ch = 0; ch < 3; ++ch)
    colors[3 * out + ch] =
        t_max(eval_sh<DEG>(dc, rest, ch, v.x, v.y, v.z) + 0.5f, 0.0f);
  opacities[out] = o.visible ? g.sig : 0.0f;
  depths[out] = o.visible ? o.pv[2] : INFINITY;
  radii[out] = o.visible ? static_cast<int>(o.radius) : 0;
}

template <int DEG>
__global__ void __launch_bounds__(kThreads) project_bwd_kernel(
    const float* __restrict__ means3d, const float* __restrict__ scales_raw,
    const float* __restrict__ quats, const float* __restrict__ opacities_raw,
    const float* __restrict__ sh_dc, const float* __restrict__ sh_rest,
    const float* __restrict__ viewmat, const float* __restrict__ full_proj,
    const float* __restrict__ campos, const float* __restrict__ tanfov,
    const int* __restrict__ radii, const float* __restrict__ g_means2d,
    const float* __restrict__ g_conics, const float* __restrict__ g_colors,
    const float* __restrict__ g_opacities, int64_t n, int n_cams,
    int k_rest, int img_h, int img_w, float mod,
    float* __restrict__ d_means3d, float* __restrict__ d_scales_raw,
    float* __restrict__ d_quats, float* __restrict__ d_opacities_raw,
    float* __restrict__ d_sh_dc, float* __restrict__ d_sh_rest) {
  extern __shared__ float4 smem4[];
  const int nrest = 3 * k_rest;
  float* rest_s = reinterpret_cast<float*>(smem4);
  float* grad_s = rest_s + kThreads * nrest;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows = n - base < kThreads ? static_cast<int>(n - base)
                                       : kThreads;
  if constexpr (DEG > 0) {
    copy_rows(sh_rest + base * nrest, rows * nrest, rest_s);
    for (int k = threadIdx.x; k < rows * nrest; k += kThreads)
      grad_s[k] = 0.0f;
    __syncthreads();
  }
  const int t = threadIdx.x;
  const int64_t i = base + t;
  if (t < rows) {
    Gauss g;
    activate(means3d + 3 * i, scales_raw + 3 * i, quats + 4 * i,
             opacities_raw[i], mod, g);
    const float* dc = sh_dc + 3 * i;
    const float* rest = rest_s + t * nrest;
    float* grest = grad_s + t * nrest;
    Grad acc = {};
    for (int b = 0; b < n_cams; ++b) {
      const int64_t pair = static_cast<int64_t>(b) * n + i;
      if (radii[pair] == 0) continue;
      Cam cam;
      load_cam(viewmat + 16 * b, full_proj + 16 * b, campos + 3 * b,
               tanfov + 2 * b, img_h, img_w, cam);
      Geo o;
      project_pair(g, cam, true, img_h, img_w, o);
      float gm[2] = {0.0f, 0.0f}, gcon[3] = {0.0f, 0.0f, 0.0f};
      float gcol[3] = {0.0f, 0.0f, 0.0f};
      if (g_means2d) {
        const float2 v = reinterpret_cast<const float2*>(g_means2d)[pair];
        gm[0] = v.x;
        gm[1] = v.y;
      }
      if (g_conics)
        for (int k = 0; k < 3; ++k) gcon[k] = g_conics[3 * pair + k];
      if (g_colors)
        for (int k = 0; k < 3; ++k) gcol[k] = g_colors[3 * pair + k];
      const float go = g_opacities ? g_opacities[pair] : 0.0f;
      pair_vjp<DEG>(g, cam, o, dc, rest, gm, gcon, gcol, go, img_h, img_w,
                    acc, grest);
    }
    for (int k = 0; k < 3; ++k) {
      d_means3d[3 * i + k] = acc.m[k];
      d_sh_dc[3 * i + k] = acc.dc[k];
    }
    finish_vjp(g, acc, mod, d_scales_raw + 3 * i, d_quats + 4 * i,
               d_opacities_raw + i);
  }
  // the block's rows of the SH rest's gradient, zeros past degree DEG
  float* out = d_sh_rest + base * nrest;
  if constexpr (DEG > 0) {
    __syncthreads();
    copy_rows(grad_s, rows * nrest, out);
  } else {
    for (int k = threadIdx.x; k < rows * nrest; k += kThreads) out[k] = 0.0f;
  }
}

int blocks_of(int64_t n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

template <int DEG>
int launch_fwd(const float* means3d, const float* scales_raw,
               const float* quats, const float* opacities_raw,
               const float* sh_dc, const float* sh_rest,
               const uint8_t* alive, const float* viewmat,
               const float* full_proj, const float* campos,
               const float* tanfov, int64_t n, int n_cams, int k_rest,
               int img_h, int img_w, float mod, float* means2d,
               float* conics, float* colors, float* opacities,
               float* depths, int* radii, cudaStream_t stream) {
  const size_t smem = DEG > 0 ? sizeof(float) * kThreads * 3 * k_rest : 0;
  dim3 grid(blocks_of(n), n_cams);
  project_fwd_kernel<DEG><<<grid, kThreads, smem, stream>>>(
      means3d, scales_raw, quats, opacities_raw, sh_dc, sh_rest, alive,
      viewmat, full_proj, campos, tanfov, n, k_rest, img_h, img_w, mod,
      means2d, conics, colors, opacities, depths, radii);
  return static_cast<int>(cudaGetLastError());
}

template <int DEG>
int launch_bwd(const float* means3d, const float* scales_raw,
               const float* quats, const float* opacities_raw,
               const float* sh_dc, const float* sh_rest,
               const float* viewmat, const float* full_proj,
               const float* campos, const float* tanfov, const int* radii,
               const float* g_means2d, const float* g_conics,
               const float* g_colors, const float* g_opacities, int64_t n,
               int n_cams, int k_rest, int img_h, int img_w, float mod,
               float* d_means3d, float* d_scales_raw, float* d_quats,
               float* d_opacities_raw, float* d_sh_dc, float* d_sh_rest,
               cudaStream_t stream) {
  const size_t smem =
      DEG > 0 ? 2 * sizeof(float) * kThreads * 3 * k_rest : 0;
  project_bwd_kernel<DEG><<<blocks_of(n), kThreads, smem, stream>>>(
      means3d, scales_raw, quats, opacities_raw, sh_dc, sh_rest, viewmat,
      full_proj, campos, tanfov, radii, g_means2d, g_conics, g_colors,
      g_opacities, n, n_cams, k_rest, img_h, img_w, mod, d_means3d,
      d_scales_raw, d_quats, d_opacities_raw, d_sh_dc, d_sh_rest);
  return static_cast<int>(cudaGetLastError());
}

// the SH degree and the stored coefficient count a launch takes: degree
// 0-3 within K = k_rest + 1 <= 16 coefficients a channel
bool bad_shape(int64_t n, int n_cams, int k_rest, int sh_degree) {
  return n < 0 || n_cams < 0 || n_cams > 65535 || k_rest < 0 || k_rest > 15
         || sh_degree < 0 || sh_degree > 3
         || (sh_degree + 1) * (sh_degree + 1) > k_rest + 1;
}

}  // namespace

extern "C" {

// The forward: raw leaves means3d (N,3), scales_raw (N,3), quats (N,4),
// opacities_raw (N,), sh_dc (N,1,3), sh_rest (N,k_rest,3) (16-byte
// aligned) and alive (N,) bool; the B = n_cams cameras' viewmat (B,4,4),
// full_proj (B,4,4), campos (B,3) and tanfov (B,2); out the (B,N) splats:
// means2d (B,N,2), conics (B,N,3), colors (B,N,3), opacities (B,N),
// depths (B,N) and radii (B,N) int32. One launch. Returns its cudaError_t
// (cudaErrorInvalidValue for a degree or K it does not take).
int gts_project_fwd(const float* means3d, const float* scales_raw,
                    const float* quats, const float* opacities_raw,
                    const float* sh_dc, const float* sh_rest,
                    const void* alive, const float* viewmat,
                    const float* full_proj, const float* campos,
                    const float* tanfov, int64_t n, int n_cams, int k_rest,
                    int img_h, int img_w, int sh_degree,
                    float scale_modifier, float* means2d, float* conics,
                    float* colors, float* opacities, float* depths,
                    int* radii, void* stream) {
  if (bad_shape(n, n_cams, k_rest, sh_degree))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || n_cams == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const uint8_t*>(alive);
  switch (sh_degree) {
#define GTS_FWD(D)                                                         \
  case D:                                                                  \
    return launch_fwd<D>(means3d, scales_raw, quats, opacities_raw, sh_dc, \
                         sh_rest, a, viewmat, full_proj, campos, tanfov, n,\
                         n_cams, k_rest, img_h, img_w, scale_modifier,     \
                         means2d, conics, colors, opacities, depths, radii,\
                         s);
    GTS_FWD(0)
    GTS_FWD(1)
    GTS_FWD(2)
    GTS_FWD(3)
#undef GTS_FWD
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: the forward's inputs (less alive) and its radii (B,N);
// the upstream gradients of means2d (B,N,2), conics (B,N,3), colors
// (B,N,3) and opacities (B,N), each NULL where it is zero; out the
// gradients of the raw leaves, each written once: d_means3d (N,3),
// d_scales_raw (N,3), d_quats (N,4), d_opacities_raw (N,), d_sh_dc
// (N,1,3) and d_sh_rest (N,k_rest,3) (16-byte aligned). A pair whose
// radius is 0 adds nothing. One launch. Returns its cudaError_t.
int gts_project_bwd(const float* means3d, const float* scales_raw,
                    const float* quats, const float* opacities_raw,
                    const float* sh_dc, const float* sh_rest,
                    const float* viewmat, const float* full_proj,
                    const float* campos, const float* tanfov,
                    const int* radii, const float* g_means2d,
                    const float* g_conics, const float* g_colors,
                    const float* g_opacities, int64_t n, int n_cams,
                    int k_rest, int img_h, int img_w, int sh_degree,
                    float scale_modifier, float* d_means3d,
                    float* d_scales_raw, float* d_quats,
                    float* d_opacities_raw, float* d_sh_dc,
                    float* d_sh_rest, void* stream) {
  if (bad_shape(n, n_cams, k_rest, sh_degree))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (sh_degree) {
#define GTS_BWD(D)                                                          \
  case D:                                                                   \
    return launch_bwd<D>(means3d, scales_raw, quats, opacities_raw, sh_dc,  \
                         sh_rest, viewmat, full_proj, campos, tanfov, radii,\
                         g_means2d, g_conics, g_colors, g_opacities, n,     \
                         n_cams, k_rest, img_h, img_w, scale_modifier,      \
                         d_means3d, d_scales_raw, d_quats, d_opacities_raw, \
                         d_sh_dc, d_sh_rest, s);
    GTS_BWD(0)
    GTS_BWD(1)
    GTS_BWD(2)
    GTS_BWD(3)
#undef GTS_BWD
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
