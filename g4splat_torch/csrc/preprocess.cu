// Splat preprocess for NVIDIA Hopper (sm_90a), forward and backward.
//
// Replaces no TPU kernel: the JAX package's preprocess is XLA ops
// (g4splat_tpu/ops/rasterize_common.py:121). It replaces the port's torch
// chain (g4splat_torch/ops/rasterize_common.py::preprocess and its SH colour)
// and that chain's autograd: ~100 elementwise, cat and reduction passes over
// (P, .) tensors at the 2.4M slots of training. The plain version of both
// kernels is g4splat_torch/ops/preprocess_cuda.py (forward_plain,
// backward_plain). As the reference's FORWARD::preprocess (forward.cu:151-253)
// and BACKWARD::preprocess (backward.cu:587-643):
//   forward: one thread per slot reads xyz, the activated scaling and
//     opacity, the raw quaternion, the SH coefficients of the active degree
//     (or the override colour) and the centre offset, and writes T = world2pix
//     . S (rows Tu, Tv, Tw), the low-pass centre, the camera-facing view
//     normal, the colour, the radius, the view depth and valid;
//   backward: one thread per slot recomputes the chain from the same inputs
//     and turns the cotangents of T, the centre, the colour and the normal
//     into the gradients of xyz, scaling, the raw quaternion, the SH
//     coefficients (zero above the active degree) or the colour, and the
//     centre offset (the centre's cotangent where valid). The centre's
//     cotangent also reaches T through the dual conic.
//
// The forward's geometry (quaternion to T, p_view, the normal's flip, the
// conic, extent, radius, tile rectangle, valid) is written in the plain
// version's order of operations with explicitly rounded intrinsics, which
// nvcc never contracts into fused multiply-adds, as torch rounds each
// elementwise op; clamp and maximum propagate NaN as torch's do. So radius
// and valid, which decide binning, agree with the plain version on the card.
// The SH colour and the backward use ordinary fp32 arithmetic, which nvcc
// may contract into fused multiply-adds; their square roots, reciprocal
// square roots and divisions are IEEE-rounded (__fsqrt_rn, __frsqrt_rn,
// '/' without --use_fast_math).
//
// What bounds it: bytes. The forward reads 240 B a slot and writes 77; the
// backward reads ~297 and writes ~236 (preprocess_cuda.FWD_BYTES_PER_SLOT,
// BWD_BYTES_PER_SLOT); the arithmetic (a few hundred flops a slot) stays in
// registers. The camera (w2c and world2pix, 28 floats) is staged in shared
// memory once per block.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int FWD_BLOCK = 256;
constexpr int BWD_BLOCK = 128;   // its shared f_rest rows: 23 KB a block
// Eight backward blocks an SM (64 registers a thread, 185 KB of shared rows):
// 0.79 ms at the training shape against 0.91 at the 80 registers ptxas
// chooses alone, which fit six blocks (H100, 2.4M slots).
constexpr int BWD_MIN_BLOCKS = 8;
constexpr int TILE = 16;
constexpr float CUTOFF_SQ = 9.0f;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float NEAR_TEST = 0.2f;
constexpr float EPS_SQ = 1e-24f;

constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f, C2_1 = -1.0925484305920792f,
                C2_2 = 0.31539156525252005f, C2_3 = -1.0925484305920792f,
                C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f,
                C3_2 = -0.4570457994644658f, C3_3 = 0.3731763325901154f,
                C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// r[0] a + r[1] b + r[2] c, rounded left to right.
__device__ __forceinline__ float dot3(const float* r, float a, float b, float c) {
  return add(add(mul(r[0], a), mul(r[1], b)), mul(r[2], c));
}

// torch.clamp(v, min=lo) and torch.maximum on the card: NaN propagates.
__device__ __forceinline__ float nan_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// rasterize_common.float_to_int32: nan_to_num, clamp, truncate.
__device__ __forceinline__ int float_to_int32(float x) {
  x = isnan(x) ? 0.f : x;
  return static_cast<int>(fminf(fmaxf(x, -2147483520.0f), 2147483520.0f));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// The camera in shared memory: w2c's rotation Rw and translation tw, the
// (3, 4) world2pix M.
struct Cam {
  float Rw[3][3], tw[3], M[3][4];
};

__device__ __forceinline__ void load_cam(const float* w2c, const float* M, Cam& c) {
  const int t = threadIdx.x;
  if (t < 12) {
    const int r = t / 4, k = t % 4;
    if (k < 3) c.Rw[r][k] = w2c[t];
    else c.tw[r] = w2c[t];
    c.M[r][k] = M[t];
  }
  __syncthreads();
}

// The chain up to T, p_view and the normal's flip, as preprocess_cuda._geometry.
struct Geo {
  float q[4];       // unit quaternion w x y z
  float qn;         // sqrt(|q|^2 + eps^2)
  float R[3][3];
  float s0, s1;     // scaling . scale_modifier
  float T[3][3];    // rows Tu, Tv, Tw
  float pv[3];
  float nv[3];      // R_w2c . R[:, 2]
  bool facing;      // p_view . nv < 0: the normal is kept, else flipped
};

__device__ __forceinline__ void geometry(const Cam& c, float x, float y, float z,
                                         const float* scl, const float* rot, float mod, Geo& g) {
  g.s0 = mul(scl[0], mod);
  g.s1 = mul(scl[1], mod);
  const float qw = rot[0], qx = rot[1], qy = rot[2], qz = rot[3];
  g.qn = __fsqrt_rn(add(add(add(add(mul(qw, qw), mul(qx, qx)), mul(qy, qy)), mul(qz, qz)),
                        EPS_SQ));
  const float w = __fdiv_rn(qw, g.qn), a = __fdiv_rn(qx, g.qn), b = __fdiv_rn(qy, g.qn),
              d = __fdiv_rn(qz, g.qn);
  g.q[0] = w; g.q[1] = a; g.q[2] = b; g.q[3] = d;
  g.R[0][0] = sub(1.f, mul(2.f, add(mul(b, b), mul(d, d))));
  g.R[0][1] = mul(2.f, sub(mul(a, b), mul(w, d)));
  g.R[0][2] = mul(2.f, add(mul(a, d), mul(w, b)));
  g.R[1][0] = mul(2.f, add(mul(a, b), mul(w, d)));
  g.R[1][1] = sub(1.f, mul(2.f, add(mul(a, a), mul(d, d))));
  g.R[1][2] = mul(2.f, sub(mul(b, d), mul(w, a)));
  g.R[2][0] = mul(2.f, sub(mul(a, d), mul(w, b)));
  g.R[2][1] = mul(2.f, add(mul(b, d), mul(w, a)));
  g.R[2][2] = sub(1.f, mul(2.f, add(mul(a, a), mul(b, b))));
  const float u0 = mul(g.R[0][0], g.s0), u1 = mul(g.R[1][0], g.s0), u2 = mul(g.R[2][0], g.s0);
  const float v0 = mul(g.R[0][1], g.s1), v1 = mul(g.R[1][1], g.s1), v2 = mul(g.R[2][1], g.s1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g.T[i][0] = dot3(c.M[i], u0, u1, u2);
    g.T[i][1] = dot3(c.M[i], v0, v1, v2);
    g.T[i][2] = add(dot3(c.M[i], x, y, z), c.M[i][3]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.pv[j] = add(dot3(c.Rw[j], x, y, z), c.tw[j]);
    g.nv[j] = dot3(c.Rw[j], g.R[0][2], g.R[1][2], g.R[2][2]);
  }
  g.facing = add(add(mul(g.pv[0], g.nv[0]), mul(g.pv[1], g.nv[1])), mul(g.pv[2], g.nv[2])) < 0.f;
}

// The dual conic's factors f = (9, 9, -1) / dist as (fu, fu, fw); inv =
// 1 / dist (1 / 1 where the conic is degenerate).
struct Conic {
  bool ok;
  float inv, fu, fw;
};

__device__ __forceinline__ Conic conic(const Geo& g) {
  const float* Tw = g.T[2];
  const float dist = sub(add(mul(mul(Tw[0], Tw[0]), CUTOFF_SQ), mul(mul(Tw[1], Tw[1]), CUTOFF_SQ)),
                         mul(Tw[2], Tw[2]));
  Conic k;
  k.ok = fabsf(dist) > 1e-12f;
  k.inv = __fdiv_rn(1.f, k.ok ? dist : 1.f);
  k.fu = mul(k.inv, CUTOFF_SQ);
  k.fw = -k.inv;
  return k;
}

// (f0 a0 b0 + f1 a1 b1) + f2 a2 b2, each product (f a) b, as the plain version.
__device__ __forceinline__ float fsum(const Conic& k, const float* a, const float* b) {
  return add(add(mul(mul(k.fu, a[0]), b[0]), mul(mul(k.fu, a[1]), b[1])),
             mul(mul(k.fw, a[2]), b[2]));
}

// The camera centre -R_w2c^T t_w2c.
__device__ __forceinline__ void camera_centre(const Cam& c, float* o) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    o[k] = -(c.Rw[0][k] * c.tw[0] + c.Rw[1][k] * c.tw[1] + c.Rw[2][k] * c.tw[2]);
}

// The SH basis at unit direction (x, y, z), first nb terms.
__device__ __forceinline__ void sh_basis(int degree, float x, float y, float z, float* B) {
  B[0] = C0;
  if (degree < 1) return;
  B[1] = -C1 * y; B[2] = C1 * z; B[3] = -C1 * x;
  if (degree < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z;
  B[4] = C2_0 * x * y; B[5] = C2_1 * y * z; B[6] = C2_2 * (2.f * zz - xx - yy);
  B[7] = C2_3 * x * z; B[8] = C2_4 * (xx - yy);
  if (degree < 3) return;
  B[9] = C3_0 * y * (3.f * xx - yy);
  B[10] = C3_1 * x * y * z;
  B[11] = C3_2 * y * (4.f * zz - xx - yy);
  B[12] = C3_3 * z * (2.f * zz - 3.f * xx - 3.f * yy);
  B[13] = C3_4 * x * (4.f * zz - xx - yy);
  B[14] = C3_5 * z * (xx - yy);
  B[15] = C3_6 * x * (xx - 3.f * yy);
}

// The SH basis's derivative by the direction, dotted with per-band weights
// W[b] (b < nb): sum_b W[b] dB[b]/d(x, y, z).
__device__ __forceinline__ void sh_basis_vjp(int degree, float x, float y, float z,
                                             const float* W, float* g) {
  g[0] = g[1] = g[2] = 0.f;
  if (degree < 1) return;
  g[0] += -C1 * W[3];
  g[1] += -C1 * W[1];
  g[2] += C1 * W[2];
  if (degree < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z;
  g[0] += C2_0 * y * W[4] - 2.f * C2_2 * x * W[6] + C2_3 * z * W[7] + 2.f * C2_4 * x * W[8];
  g[1] += C2_0 * x * W[4] + C2_1 * z * W[5] - 2.f * C2_2 * y * W[6] - 2.f * C2_4 * y * W[8];
  g[2] += C2_1 * y * W[5] + 4.f * C2_2 * z * W[6] + C2_3 * x * W[7];
  if (degree < 3) return;
  g[0] += C3_0 * 6.f * x * y * W[9] + C3_1 * y * z * W[10] - 2.f * C3_2 * x * y * W[11]
          - 6.f * C3_3 * x * z * W[12] + C3_4 * (4.f * zz - 3.f * xx - yy) * W[13]
          + 2.f * C3_5 * x * z * W[14] + C3_6 * 3.f * (xx - yy) * W[15];
  g[1] += C3_0 * 3.f * (xx - yy) * W[9] + C3_1 * x * z * W[10]
          + C3_2 * (4.f * zz - xx - 3.f * yy) * W[11] - 6.f * C3_3 * y * z * W[12]
          - 2.f * C3_4 * x * y * W[13] - 2.f * C3_5 * y * z * W[14] - 6.f * C3_6 * x * y * W[15];
  g[2] += C3_1 * x * y * W[10] + 8.f * C3_2 * y * z * W[11]
          + C3_3 * (6.f * zz - 3.f * xx - 3.f * yy) * W[12] + 8.f * C3_4 * x * z * W[13]
          + C3_5 * (xx - yy) * W[14];
}

constexpr int MAX_REST = 15;     // SH bands beyond the DC term at degree 3

// The backward's rows [row0, row0 + n) of a (P, K, 3) SH array, the first
// `cols` floats of each, between device and shared memory (row stride 3
// MAX_REST there): consecutive threads on consecutive floats, so that each
// warp's access is one contiguous run, where one thread per row would stride
// by 3 K floats (the forward reads its rows directly: staging them slowed it).
__device__ __forceinline__ void rest_in(float* sm, const float* g, size_t row0, int n, int K,
                                        int cols) {
  const int k3 = 3 * K;
  for (int e = threadIdx.x; e < n * k3; e += blockDim.x) {
    const int r = e / k3, c = e - r * k3;
    if (c < cols) sm[r * 3 * MAX_REST + c] = g[row0 * k3 + e];
  }
}

// Back out: every float of the rows, zero past the first `cols` of each.
__device__ __forceinline__ void rest_out(float* g, const float* sm, size_t row0, int n, int K,
                                         int cols) {
  const int k3 = 3 * K;
  for (int e = threadIdx.x; e < n * k3; e += blockDim.x) {
    const int r = e / k3, c = e - r * k3;
    g[row0 * k3 + e] = c < cols ? sm[r * 3 * MAX_REST + c] : 0.f;
  }
}

struct FwdArgs {
  const float* xyz;       // (P, 3)
  const float* scaling;   // (P, 2) activated
  const float* rot;       // (P, 4) raw wxyz
  const float* opacity;   // (P,) activated
  const float* f_dc;      // (P, 1, 3)
  const float* f_rest;    // (P, K, 3), K <= MAX_REST
  const float* colors;    // (P, 3) or null
  const float* offset;    // (P, 2) or null
  const float* w2c;       // (4, 4)
  const float* M;         // (3, 4) world2pix
  int P, K, degree;
  float mod;
  int gx, gy;
  float* T;               // (P, 3, 3)
  float* center;          // (P, 2)
  float* normal;          // (P, 3)
  float* rgb;             // (P, 3)
  float* radius;          // (P,)
  float* depth;           // (P,)
  bool* valid;            // (P,)
};

__global__ void __launch_bounds__(FWD_BLOCK) preprocess_fwd_kernel(const FwdArgs a) {
  __shared__ Cam cam;
  load_cam(a.w2c, a.M, cam);
  const int i = blockIdx.x * FWD_BLOCK + threadIdx.x;
  if (i >= a.P) return;
  const size_t i3 = static_cast<size_t>(i) * 3;
  const float x = a.xyz[i3], y = a.xyz[i3 + 1], z = a.xyz[i3 + 2];
  Geo g;
  geometry(cam, x, y, z, a.scaling + static_cast<size_t>(i) * 2,
           a.rot + static_cast<size_t>(i) * 4, a.mod, g);
  const Conic k = conic(g);
  float cx = fsum(k, g.T[0], g.T[2]);
  float cy = fsum(k, g.T[1], g.T[2]);
  if (a.offset) {
    cx = add(cx, a.offset[static_cast<size_t>(i) * 2]);
    cy = add(cy, a.offset[static_cast<size_t>(i) * 2 + 1]);
  }
  const float hx = sub(mul(cx, cx), fsum(k, g.T[0], g.T[0]));
  const float hy = sub(mul(cy, cy), fsum(k, g.T[1], g.T[1]));
  const float r = ceilf(nan_max(__fsqrt_rn(nan_clamp_min(hx, 1e-4f)),
                                __fsqrt_rn(nan_clamp_min(hy, 1e-4f))));
  const float inv_tile = 1.0f / TILE;
  const int rmin_x = clampi(float_to_int32(mul(sub(cx, r), inv_tile)), 0, a.gx);
  const int rmin_y = clampi(float_to_int32(mul(sub(cy, r), inv_tile)), 0, a.gy);
  const int rmax_x =
      clampi(float_to_int32(mul(sub(add(add(cx, r), float(TILE)), 1.f), inv_tile)), 0, a.gx);
  const int rmax_y =
      clampi(float_to_int32(mul(sub(add(add(cy, r), float(TILE)), 1.f), inv_tile)), 0, a.gy);
  const bool nonempty = (rmax_x - rmin_x) * (rmax_y - rmin_y) > 0;
  const bool valid = g.pv[2] >= NEAR_TEST && k.ok && nonempty && a.opacity[i] >= ALPHA_EPS;

  float col[3];
  if (a.colors) {
#pragma unroll
    for (int c = 0; c < 3; ++c) col[c] = a.colors[i3 + c];
  } else {
    float o[3];
    camera_centre(cam, o);
    const float vx = x - o[0], vy = y - o[1], vz = z - o[2];
    const float rn = __frsqrt_rn(vx * vx + vy * vy + vz * vz + EPS_SQ);
    float B[16];
    sh_basis(a.degree, vx * rn, vy * rn, vz * rn, B);
    const int nb = (a.degree + 1) * (a.degree + 1);
    const float* rest = a.f_rest + static_cast<size_t>(i) * a.K * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) col[c] = B[0] * a.f_dc[i3 + c];
#pragma unroll
    for (int b = 1; b < 16; ++b) {
      if (b < nb) {
#pragma unroll
        for (int c = 0; c < 3; ++c) col[c] += B[b] * rest[(b - 1) * 3 + c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) col[c] = nan_clamp_min(col[c] + 0.5f, 0.f);
  }

  float* T = a.T + static_cast<size_t>(i) * 9;
#pragma unroll
  for (int r_ = 0; r_ < 3; ++r_) {
#pragma unroll
    for (int c = 0; c < 3; ++c) T[r_ * 3 + c] = g.T[r_][c];
  }
  a.center[static_cast<size_t>(i) * 2] = valid ? cx : 0.f;
  a.center[static_cast<size_t>(i) * 2 + 1] = valid ? cy : 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.normal[i3 + c] = g.facing ? g.nv[c] : -g.nv[c];
    a.rgb[i3 + c] = col[c];
  }
  a.radius[i] = valid ? r : 0.f;
  a.depth[i] = g.pv[2];
  a.valid[i] = valid;
}

struct BwdArgs {
  const float* xyz;
  const float* scaling;
  const float* rot;
  const float* f_dc;
  const float* f_rest;
  const float* colors;        // or null: the SH colour
  const bool* valid;
  const float* w2c;
  const float* M;
  const float* gT;            // rows of 9 at stride sT
  const float* gc;            // rows of 2 at stride sc
  const float* grgb;          // rows of 3 at stride srgb
  const float* gn;            // rows of 3 at stride sn
  int sT, sc, srgb, sn;
  int P, K, degree;
  float mod;
  float* d_xyz;               // (P, 3)
  float* d_scaling;           // (P, 2)
  float* d_rot;               // (P, 4)
  float* d_fdc;               // (P, 1, 3), written without colors
  float* d_frest;             // (P, K, 3), written without colors
  float* d_colors;            // (P, 3), written with colors
  float* d_offset;            // (P, 2) or null
};

__global__ void __launch_bounds__(BWD_BLOCK, BWD_MIN_BLOCKS)
    preprocess_bwd_kernel(const BwdArgs a) {
  __shared__ Cam cam;
  __shared__ float rest_sm[BWD_BLOCK * 3 * MAX_REST];   // f_rest in, d_frest out
  load_cam(a.w2c, a.M, cam);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * BWD_BLOCK;
  const int n = min(BWD_BLOCK, a.P - static_cast<int>(row0));
  const int nb = (a.degree + 1) * (a.degree + 1);
  if (!a.colors) {
    rest_in(rest_sm, a.f_rest, row0, n, a.K, 3 * (nb - 1));
    __syncthreads();
  }
  if (static_cast<int>(threadIdx.x) < n) {
    const int i = static_cast<int>(row0) + threadIdx.x;
    const size_t i3 = static_cast<size_t>(i) * 3;
    const float x = a.xyz[i3], y = a.xyz[i3 + 1], z = a.xyz[i3 + 2];
    Geo g;
    geometry(cam, x, y, z, a.scaling + static_cast<size_t>(i) * 2,
             a.rot + static_cast<size_t>(i) * 4, a.mod, g);
    const Conic k = conic(g);
    float gT[3][3];
    const float* gTp = a.gT + static_cast<size_t>(i) * a.sT;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) gT[r][c] = gTp[r * 3 + c];
    }
    // The centre: a constant 0 on culled slots; else through the dual conic.
    const bool valid = a.valid[i];
    const float gcx = valid ? a.gc[static_cast<size_t>(i) * a.sc] : 0.f;
    const float gcy = valid ? a.gc[static_cast<size_t>(i) * a.sc + 1] : 0.f;
    if (a.d_offset) {
      a.d_offset[static_cast<size_t>(i) * 2] = gcx;
      a.d_offset[static_cast<size_t>(i) * 2 + 1] = gcy;
    }
    if (valid) {
      const float f[3] = {k.fu, k.fu, k.fw};
      const float tmp[3] = {CUTOFF_SQ, CUTOFF_SQ, -1.f};
      float av[3], gdist = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        av[c] = gcx * g.T[0][c] + gcy * g.T[1][c];
        gdist += av[c] * g.T[2][c] * f[c];
      }
      gdist = -gdist * k.inv;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        gT[0][c] += gcx * f[c] * g.T[2][c];
        gT[1][c] += gcy * f[c] * g.T[2][c];
        gT[2][c] += f[c] * av[c] + 2.f * gdist * tmp[c] * g.T[2][c];
      }
    }
    // T = M S: S's columns (s0 R[:, 0], 0), (s1 R[:, 1], 0), (xyz, 1).
    float gS[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        gS[j][c] = cam.M[0][j] * gT[0][c] + cam.M[1][j] * gT[1][c] + cam.M[2][j] * gT[2][c];
    }
    float gx = gS[0][2], gy = gS[1][2], gz = gS[2][2];
    const float gs0 = gS[0][0] * g.R[0][0] + gS[1][0] * g.R[1][0] + gS[2][0] * g.R[2][0];
    const float gs1 = gS[0][1] * g.R[0][1] + gS[1][1] * g.R[1][1] + gS[2][1] * g.R[2][1];
    a.d_scaling[static_cast<size_t>(i) * 2] = gs0 * a.mod;
    a.d_scaling[static_cast<size_t>(i) * 2 + 1] = gs1 * a.mod;
    float gnv[3];
    const float* gnp = a.gn + static_cast<size_t>(i) * a.sn;
#pragma unroll
    for (int j = 0; j < 3; ++j) gnv[j] = g.facing ? gnp[j] : -gnp[j];
    float gR[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gR[j][0] = gS[j][0] * g.s0;
      gR[j][1] = gS[j][1] * g.s1;
      gR[j][2] = cam.Rw[0][j] * gnv[0] + cam.Rw[1][j] * gnv[1] + cam.Rw[2][j] * gnv[2];
    }
    // The rotation matrix of the unit quaternion, then normalize's backward.
    const float w = g.q[0], qx = g.q[1], qy = g.q[2], qz = g.q[3];
    const float gw = 2.f * (-qz * gR[0][1] + qy * gR[0][2] + qz * gR[1][0] - qx * gR[1][2]
                            - qy * gR[2][0] + qx * gR[2][1]);
    const float gqx = 2.f * (qy * gR[0][1] + qz * gR[0][2] + qy * gR[1][0] - 2.f * qx * gR[1][1]
                             - w * gR[1][2] + qz * gR[2][0] + w * gR[2][1] - 2.f * qx * gR[2][2]);
    const float gqy = 2.f * (-2.f * qy * gR[0][0] + qx * gR[0][1] + w * gR[0][2] + qx * gR[1][0]
                             + qz * gR[1][2] - w * gR[2][0] + qz * gR[2][1] - 2.f * qy * gR[2][2]);
    const float gqz = 2.f * (-2.f * qz * gR[0][0] - w * gR[0][1] + qx * gR[0][2] + w * gR[1][0]
                             - 2.f * qz * gR[1][1] + qy * gR[1][2] + qx * gR[2][0] + qy * gR[2][1]);
    const float proj = gw * w + gqx * qx + gqy * qy + gqz * qz;
    const float4 dq = make_float4((gw - proj * w) / g.qn, (gqx - proj * qx) / g.qn,
                                  (gqy - proj * qy) / g.qn, (gqz - proj * qz) / g.qn);
    reinterpret_cast<float4*>(a.d_rot)[i] = dq;

    const float* grgb = a.grgb + static_cast<size_t>(i) * a.srgb;
    if (a.colors) {
#pragma unroll
      for (int c = 0; c < 3; ++c) a.d_colors[i3 + c] = grgb[c];
    } else {
      float o[3];
      camera_centre(cam, o);
      const float vx = x - o[0], vy = y - o[1], vz = z - o[2];
      const float rn = __frsqrt_rn(vx * vx + vy * vy + vz * vz + EPS_SQ);
      const float dx = vx * rn, dy = vy * rn, dz = vz * rn;
      float B[16];
      sh_basis(a.degree, dx, dy, dz, B);
      float* rest = rest_sm + threadIdx.x * 3 * MAX_REST;
      float ev[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) ev[c] = B[0] * a.f_dc[i3 + c];
#pragma unroll
      for (int b = 1; b < 16; ++b) {
        if (b < nb) {
#pragma unroll
          for (int c = 0; c < 3; ++c) ev[c] += B[b] * rest[(b - 1) * 3 + c];
        }
      }
      float gev[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        gev[c] = ev[c] + 0.5f >= 0.f ? grgb[c] : 0.f;
        a.d_fdc[i3 + c] = B[0] * gev[c];
      }
      // W[b] = sum_c coefficient . g_eval; the row's coefficients are then
      // overwritten in place by their gradients, which rest_out stores.
      float W[16];
      W[0] = 0.f;
#pragma unroll
      for (int b = 1; b < 16; ++b) {
        W[b] = 0.f;
        if (b < nb) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            W[b] += rest[(b - 1) * 3 + c] * gev[c];
            rest[(b - 1) * 3 + c] = B[b] * gev[c];
          }
        }
      }
      float gd[3];
      sh_basis_vjp(a.degree, dx, dy, dz, W, gd);
      const float proj_d = gd[0] * dx + gd[1] * dy + gd[2] * dz;
      gx += rn * (gd[0] - proj_d * dx);
      gy += rn * (gd[1] - proj_d * dy);
      gz += rn * (gd[2] - proj_d * dz);
    }
    a.d_xyz[i3] = gx;
    a.d_xyz[i3 + 1] = gy;
    a.d_xyz[i3 + 2] = gz;
  }
  if (!a.colors) {
    __syncthreads();
    rest_out(a.d_frest, rest_sm, row0, n, a.K, 3 * (nb - 1));
  }
}

}  // namespace

extern "C" int g4_preprocess_fwd(const float* xyz, const float* scaling, const float* rot,
                                 const float* opacity, const float* f_dc, const float* f_rest,
                                 const float* colors, const float* offset, const float* w2c,
                                 const float* M, int P, int K, int degree, float mod, int gx,
                                 int gy, float* T, float* center, float* normal, float* rgb,
                                 float* radius, float* depth, bool* valid, void* stream) {
  if (P <= 0) return 0;
  if (K > MAX_REST || degree < 0 || degree > 3) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{xyz, scaling, rot, opacity, f_dc, f_rest, colors, offset, w2c, M, P, K,
                  degree, mod, gx, gy, T, center, normal, rgb, radius, depth, valid};
  preprocess_fwd_kernel<<<(P + FWD_BLOCK - 1) / FWD_BLOCK, FWD_BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int g4_preprocess_bwd(const float* xyz, const float* scaling, const float* rot,
                                 const float* f_dc, const float* f_rest, const float* colors,
                                 const bool* valid, const float* w2c, const float* M,
                                 const float* gT, int sT, const float* gc, int sc,
                                 const float* grgb, int srgb, const float* gn, int sn, int P,
                                 int K, int degree, float mod, float* d_xyz, float* d_scaling,
                                 float* d_rot, float* d_fdc, float* d_frest, float* d_colors,
                                 float* d_offset, void* stream) {
  if (P <= 0) return 0;
  if (K > MAX_REST || degree < 0 || degree > 3) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{xyz, scaling, rot, f_dc, f_rest, colors, valid, w2c, M, gT, gc, grgb, gn,
                  sT, sc, srgb, sn, P, K, degree, mod, d_xyz, d_scaling, d_rot, d_fdc, d_frest,
                  d_colors, d_offset};
  preprocess_bwd_kernel<<<(P + BWD_BLOCK - 1) / BWD_BLOCK, BWD_BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
