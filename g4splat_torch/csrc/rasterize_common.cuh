// What the forward (rasterize_fwd.cu, B1) and backward (rasterize_bwd.cu, B2)
// surfel kernels share: the reference's constants, the per-splat table's row
// layout, the low-pass centre recomputed from T, and the reach box outside
// which an entry has no pixel with alpha >= 1/255.
//
// Both kernels read entry i of a tile's range as row gauss_id[i] of the
// per-splat table (P, ROW_F) float32: T's rows Tu, Tv, Tw (0-8), opacity (9,
// 0 for a culled splat), rgb (10-12), the view-space normal (13-15).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int NWARP = NPIX / 32;
constexpr int ROW_F = 16;
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float CUTOFF_SQ = 9.0f;
constexpr float BOX_MARGIN = 1.0f;   // pixels around an entry's reach box
constexpr float BIG = 3.0e38f;

// One table row as four 16-byte loads.
struct Row {
  float4 a, b, c, d;   // (Tu0 Tu1 Tu2 Tv0) (Tv1 Tv2 Tw0 Tw1) (Tw2 opa r g) (b nx ny nz)
};

__device__ __forceinline__ Row load_row(const float4* __restrict__ table, int g) {
  const float4* r = table + static_cast<size_t>(g) * (ROW_F / 4);
  return Row{r[0], r[1], r[2], r[3]};
}

// The low-pass centre from the dual conic (forward.cu:119-147); (0, 0) where
// the conic is degenerate, as in the plain version.
__device__ __forceinline__ float2 conic_centre(const Row& r) {
  const float Tu0 = r.a.x, Tu1 = r.a.y, Tu2 = r.a.z;
  const float Tv0 = r.a.w, Tv1 = r.b.x, Tv2 = r.b.y;
  const float Tw0 = r.b.z, Tw1 = r.b.w, Tw2 = r.c.x;
  const float cdist = CUTOFF_SQ * (Tw0 * Tw0 + Tw1 * Tw1) - Tw2 * Tw2;
  const bool cok = fabsf(cdist) > 1e-12f;
  const float cinv = 1.0f / (cok ? cdist : 1.0f);
  return make_float2(cok ? (CUTOFF_SQ * (Tu0 * Tw0 + Tu1 * Tw1) - Tu2 * Tw2) * cinv : 0.f,
                     cok ? (CUTOFF_SQ * (Tv0 * Tw0 + Tv1 * Tw1) - Tv2 * Tw2) * cinv : 0.f);
}

// The screen box (x0, x1, y0, y1) outside which an entry reaches no pixel
// (rasterize_cuda_bwd.reach_boxes is its plain version). alpha >= 1/255
// needs rho = min(rho3d, rho2d) <= R = 2 ln(opa * 255). rho2d <= R within
// sqrt(R / 2) of the low-pass centre; rho3d <= R inside the image of the disk
// |(u, v)|^2 <= R, which its tangent lines bound (the dual conic
// M diag(R, R, -1) M^T, as the reference's AABB) when the disk lies on one
// side of the camera plane, R (Tw0^2 + Tw1^2) < Tw2^2; else the box is
// unbounded. In double, with R widened by 0.1 % + 1e-3 and the box by
// BOX_MARGIN pixels, so that fp32 rounding in rho stays inside.
__device__ float4 reach_box(float Tu0, float Tu1, float Tu2, float Tv0, float Tv1, float Tv2,
                            float Tw0, float Tw1, float Tw2, float cx, float cy, float opa) {
  if (!(opa >= ALPHA_EPS)) return make_float4(BIG, -BIG, BIG, -BIG);
  double R = 2.0 * log(static_cast<double>(opa) / static_cast<double>(ALPHA_EPS));
  R = fmax(R, 0.0) * 1.001 + 1e-3;
  const double u0 = Tu0, u1 = Tu1, u2 = Tu2, v0 = Tv0, v1 = Tv1, v2 = Tv2;
  const double w0 = Tw0, w1 = Tw1, w2 = Tw2;
  const double a = R * (w0 * w0 + w1 * w1);
  const double dist = a - w2 * w2;
  if (!(dist < -1e-6 * (a + w2 * w2))) return make_float4(-BIG, BIG, -BIG, BIG);
  const double X = (R * (u0 * w0 + u1 * w1) - u2 * w2) / dist;
  const double Y = (R * (v0 * w0 + v1 * w1) - v2 * w2) / dist;
  const double hx = sqrt(fmax(X * X - (R * (u0 * u0 + u1 * u1) - u2 * u2) / dist, 0.0));
  const double hy = sqrt(fmax(Y * Y - (R * (v0 * v0 + v1 * v1) - v2 * v2) / dist, 0.0));
  const double r2 = sqrt(R / FILTER_INV_SQUARE);
  return make_float4(static_cast<float>(fmin(cx - r2, X - hx) - BOX_MARGIN),
                     static_cast<float>(fmax(cx + r2, X + hx) + BOX_MARGIN),
                     static_cast<float>(fmin(cy - r2, Y - hy) - BOX_MARGIN),
                     static_cast<float>(fmax(cy + r2, Y + hy) + BOX_MARGIN));
}

// Whether box b meets a warp's 16 x 2 pixels, the row pair from (wx, wy).
__device__ __forceinline__ bool box_meets_warp(float4 b, float wx, float wy) {
  return b.x <= wx + (TILE - 1) && b.y >= wx && b.z <= wy + 1.f && b.w >= wy;
}

}  // namespace
