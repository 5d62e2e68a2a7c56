// Tile binning for NVIDIA Hopper (sm_90a).
//
// Replaces the torch passes of the port's plain binning
// (g4splat_torch/ops/rasterize_tiled.py::bin_splats_plain and _ellipse_keep),
// the counterpart of g4splat_tpu/ops/rasterize_tiled.py::bin_splats. The chain
// is the reference's duplicateWithKeys / identifyTileRanges
// (rasterizer_impl.cu:198-342):
//   1. count: one thread per splat computes its tile rect, walks its
//      min(rw * rh, cap) candidate slots in row-major order (tx = rmin_x +
//      slot % rw, ty = rmin_y + slot / rw) and runs the tile-level ellipse
//      test on each in registers; it writes the kept count, and the block adds
//      the slots cut by the cap into n_dropped with one atomicAdd;
//   2. (host) the inclusive prefix sum of the counts and one read of the total;
//   3. emit: the same walk again, writing kept slot k of splat i at
//      offset[i] + k: the key (tile << 32) | depth bits and the splat id, so
//      that the entries stand in the plain version's row-major order;
//   4. (host) torch.sort of the keys, stable;
//   5. ranges: entry i's splat id and tile from the sorted keys, and each
//      tile's [start, start + count) by binary search (searchsorted's
//      insertion point, so an empty tile starts where its tiles would).
//
// Keep decisions are bit-identical to the plain version run on the card: the
// test is written in the plain version's order of operations with explicitly
// rounded intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), which nvcc
// never contracts into fused multiply-adds, as torch rounds each elementwise
// op; minimum and clamp propagate NaN as torch's do; tau (2 ln(opa / ALPHA_EPS)
// + 0.05) comes in from the caller, computed by torch.
//
// What bounds it: each splat's ~61 bytes (T, centre, radius, opacity, tau,
// depth, valid) read in both passes, 12 bytes per entry written, and the
// sort's passes over the keys and their indices. The test's arithmetic (~9
// quadratic evaluations of ~14 operations per candidate) stays in registers.

#include <cstdint>

#include "rasterize_common.cuh"

namespace {

constexpr int BLOCK = 256;

struct Inputs {
  const float* T;             // (P, 3, 3) rows Tu, Tv, Tw, strides t_sp, t_si, t_sj
  const float* center;        // (P, 2)
  const float* radius;        // (P,)
  const float* opacity;       // (P,)
  const float* tau;           // (P,) read only with the ellipse test
  const float* depth;         // (P,) stride d_sp
  const unsigned char* valid; // (P,) bool
  int t_sp, t_si, t_sj, d_sp;
  int P, gx, gy, cap;
};

// torch.minimum and torch.clamp(v, lo, hi) on the card: NaN propagates.
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// rasterize_common.float_to_int32: nan_to_num, clamp, truncate.
__device__ __forceinline__ int float_to_int32(float x) {
  x = isnan(x) ? 0.f : x;
  return static_cast<int>(fminf(fmaxf(x, -2147483520.0f), 2147483520.0f));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// q(x, y) = Hxx x x + 2 (Hxy x y + Gx x + Gy y) + Hyy y y + K, rounded as the
// plain version's torch ops are, left to right.
struct Quad {
  float Hxx, Hxy, Hyy, Gx, Gy, K, xi, yi;
  bool pd;
};

__device__ __forceinline__ float quad(const Quad& c, float x, float y) {
  const float lin = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(c.Hxy, x), y), __fmul_rn(c.Gx, x)),
                              __fmul_rn(c.Gy, y));
  float s = __fadd_rn(__fmul_rn(__fmul_rn(c.Hxx, x), x), __fmul_rn(2.0f, lin));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(c.Hyy, y), y));
  return __fadd_rn(s, c.K);
}

// (a b + c d) - t (e f), as `(a * b + c * d) - t * (e * f)` in torch.
__device__ __forceinline__ float coef(float a, float b, float c, float d, float t, float e,
                                      float f) {
  return __fsub_rn(__fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d)), __fmul_rn(t, __fmul_rn(e, f)));
}

__device__ Quad make_quad(const Inputs& in, int i, float t) {
  const float* Tp = in.T + static_cast<size_t>(i) * in.t_sp;
  const float* Tv = Tp + in.t_si;
  const float* Tw = Tv + in.t_si;
  const int sj = in.t_sj;
  const float Tu0 = Tp[0], Tu1 = Tp[sj], Tu2 = Tp[2 * sj];
  const float Tv0 = Tv[0], Tv1 = Tv[sj], Tv2 = Tv[2 * sj];
  const float Tw0 = Tw[0], Tw1 = Tw[sj], Tw2 = Tw[2 * sj];
  float v[9] = {
      __fsub_rn(__fmul_rn(Tw2, Tv1), __fmul_rn(Tw1, Tv2)),   // A0
      __fsub_rn(__fmul_rn(Tu2, Tw1), __fmul_rn(Tu1, Tw2)),   // B0
      __fsub_rn(__fmul_rn(Tu1, Tv2), __fmul_rn(Tu2, Tv1)),   // C0
      __fsub_rn(__fmul_rn(Tw0, Tv2), __fmul_rn(Tw2, Tv0)),   // A1
      __fsub_rn(__fmul_rn(Tu0, Tw2), __fmul_rn(Tu2, Tw0)),   // B1
      __fsub_rn(__fmul_rn(Tu2, Tv0), __fmul_rn(Tu0, Tv2)),   // C1
      __fsub_rn(__fmul_rn(Tw1, Tv0), __fmul_rn(Tw0, Tv1)),   // A2
      __fsub_rn(__fmul_rn(Tu1, Tw0), __fmul_rn(Tu0, Tw1)),   // B2
      __fsub_rn(__fmul_rn(Tu0, Tv1), __fmul_rn(Tu1, Tv0)),   // C2
  };
  // m = clamp(max |v|, min=1e-30), NaN if any v is.
  float m = 0.f;
  for (int k = 0; k < 9; ++k) m = isnan(m) ? m : (isnan(v[k]) ? v[k] : fmaxf(m, fabsf(v[k])));
  m = isnan(m) ? m : fmaxf(m, 1e-30f);
  for (int k = 0; k < 9; ++k) v[k] = __fdiv_rn(v[k], m);
  const float A0 = v[0], B0 = v[1], C0 = v[2], A1 = v[3], B1 = v[4], C1 = v[5];
  const float A2 = v[6], B2 = v[7], C2 = v[8];
  Quad c;
  c.Hxx = coef(A0, A0, A1, A1, t, A2, A2);
  c.Hxy = coef(A0, B0, A1, B1, t, A2, B2);
  c.Hyy = coef(B0, B0, B1, B1, t, B2, B2);
  c.Gx = coef(A0, C0, A1, C1, t, A2, C2);
  c.Gy = coef(B0, C0, B1, C1, t, B2, C2);
  c.K = coef(C0, C0, C1, C1, t, C2, C2);
  const float det = __fsub_rn(__fmul_rn(c.Hxx, c.Hyy), __fmul_rn(c.Hxy, c.Hxy));
  c.pd = c.Hxx > 0.f && det > 0.f;
  const float sdet = c.pd ? det : 1.f;
  c.xi = __fdiv_rn(__fsub_rn(__fmul_rn(c.Hxy, c.Gy), __fmul_rn(c.Hyy, c.Gx)), sdet);
  c.yi = __fdiv_rn(__fsub_rn(__fmul_rn(c.Hxy, c.Gx), __fmul_rn(c.Hxx, c.Gy)), sdet);
  return c;
}

// _ellipse_keep for the tile whose pixel rect starts at (x0, y0).
__device__ bool keep_tile(const Quad& c, float x0, float y0, float cx, float cy, float t) {
  const float x1 = __fadd_rn(x0, static_cast<float>(TILE - 1));
  const float y1 = __fadd_rn(y0, static_cast<float>(TILE - 1));
  const float dx = __fsub_rn(nan_clamp(cx, x0, x1), cx);
  const float dy = __fsub_rn(nan_clamp(cy, y0, y1), cy);
  if (__fmul_rn(FILTER_INV_SQUARE, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))) <= t)
    return true;   // keep2d decides alone
  float qmin = nan_min(nan_min(quad(c, x0, y0), quad(c, x0, y1)),
                       nan_min(quad(c, x1, y0), quad(c, x1, y1)));
  if (c.Hyy > 0.f) {
    const float xe[2] = {x0, x1};
    for (int k = 0; k < 2; ++k) {
      const float ye = nan_clamp(__fdiv_rn(-__fadd_rn(__fmul_rn(c.Hxy, xe[k]), c.Gy), c.Hyy),
                                 y0, y1);
      qmin = nan_min(qmin, quad(c, xe[k], ye));
    }
  }
  if (c.Hxx > 0.f) {
    const float ye[2] = {y0, y1};
    for (int k = 0; k < 2; ++k) {
      const float xe = nan_clamp(__fdiv_rn(-__fadd_rn(__fmul_rn(c.Hxy, ye[k]), c.Gx), c.Hxx),
                                 x0, x1);
      qmin = nan_min(qmin, quad(c, xe, ye[k]));
    }
  }
  if (c.pd) qmin = nan_min(qmin, quad(c, nan_clamp(c.xi, x0, x1), nan_clamp(c.yi, y0, y1)));
  return qmin <= 0.f;
}

// Walk splat i's candidate slots; with EMIT, write its kept entries at keys[k]
// and ids[k]. Returns the kept count; *dropped gets the slots past the cap.
template <bool PRUNE, bool EMIT>
__device__ int bin_splat(const Inputs& in, int i, int* dropped, long long* keys, int* ids) {
  *dropped = 0;
  if (!in.valid[i]) return 0;
  const float cx = in.center[2 * i], cy = in.center[2 * i + 1], r = in.radius[i];
  const float inv_tile = 1.0f / TILE;
  const int rx0 = clampi(float_to_int32(__fmul_rn(__fsub_rn(cx, r), inv_tile)), 0, in.gx);
  const int ry0 = clampi(float_to_int32(__fmul_rn(__fsub_rn(cy, r), inv_tile)), 0, in.gy);
  const float tf = static_cast<float>(TILE);   // (c + r + TILE - 1) / TILE, left to right
  const int rx1 = clampi(
      float_to_int32(__fmul_rn(__fsub_rn(__fadd_rn(__fadd_rn(cx, r), tf), 1.0f), inv_tile)), 0,
      in.gx);
  const int ry1 = clampi(
      float_to_int32(__fmul_rn(__fsub_rn(__fadd_rn(__fadd_rn(cy, r), tf), 1.0f), inv_tile)), 0,
      in.gy);
  const int rw = rx1 - rx0;
  const int n_all = rw * (ry1 - ry0);
  const int n = min(n_all, in.cap);
  *dropped = n_all - n;
  if (n <= 0) return 0;
  Quad c;
  float t = 0.f;
  if (PRUNE) {
    if (!(in.opacity[i] >= ALPHA_EPS)) return 0;   // _ellipse_keep's opacity test
    t = in.tau[i];
    c = make_quad(in, i, t);
  }
  long long dbits = 0;   // the depth's bits, sign-extended as torch's int32 -> int64
  if (EMIT) dbits = __float_as_int(in.depth[static_cast<size_t>(i) * in.d_sp]);
  int kept = 0;
  for (int s = 0; s < n; ++s) {
    const int tx = rx0 + s % rw, ty = ry0 + s / rw;
    if (PRUNE && !keep_tile(c, static_cast<float>(tx * TILE), static_cast<float>(ty * TILE),
                            cx, cy, t))
      continue;
    if (EMIT) {
      keys[kept] = (static_cast<long long>(ty * in.gx + tx) << 32) | dbits;
      ids[kept] = i;
    }
    ++kept;
  }
  return kept;
}

template <bool PRUNE>
__global__ void __launch_bounds__(BLOCK) count_kernel(Inputs in, int* __restrict__ counts,
                                                       int* __restrict__ n_dropped) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  int dropped = 0;
  if (i < in.P) counts[i] = bin_splat<PRUNE, false>(in, i, &dropped, nullptr, nullptr);
  for (int o = 16; o > 0; o >>= 1) dropped += __shfl_xor_sync(0xffffffffu, dropped, o);
  __shared__ int part[BLOCK / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = dropped;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < BLOCK / 32; ++w) sum += part[w];
    if (sum) atomicAdd(n_dropped, sum);
  }
}

template <bool PRUNE>
__global__ void __launch_bounds__(BLOCK) emit_kernel(Inputs in, const long long* __restrict__ incl,
                                                      long long* __restrict__ keys,
                                                      int* __restrict__ ids) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= in.P) return;
  const long long base = i ? incl[i - 1] : 0;
  if (incl[i] == base) return;
  int dropped;
  bin_splat<PRUNE, true>(in, i, &dropped, keys + base, ids + base);
}

// First index of the sorted keys whose tile (key >> 32) is >= t (upper: > t).
__device__ __forceinline__ int tile_bound(const long long* __restrict__ keys, int E, int t,
                                          bool upper) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int tm = static_cast<int>(keys[mid] >> 32);
    if (upper ? tm <= t : tm < t) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(BLOCK) ranges_kernel(
    const long long* __restrict__ keys, const long long* __restrict__ perm,
    const int* __restrict__ ids, int E, int n_tiles, int* __restrict__ gauss_id,
    int* __restrict__ tile_id, int* __restrict__ tile_start, int* __restrict__ tile_count) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < E) {
    gauss_id[i] = ids[perm[i]];
    tile_id[i] = static_cast<int>(keys[i] >> 32);
  }
  if (i < n_tiles) {
    const int start = tile_bound(keys, E, i, false);
    tile_start[i] = start;
    tile_count[i] = tile_bound(keys, E, i, true) - start;
  }
}

Inputs make_inputs(const float* T, const float* center, const float* radius,
                   const float* opacity, const float* tau, const float* depth,
                   const unsigned char* valid, const int* strides, int P, int gx, int gy,
                   int cap) {
  return Inputs{T, center, radius, opacity, tau, depth, valid,
                strides[0], strides[1], strides[2], strides[3], P, gx, gy, cap};
}

}  // namespace

// Pass 1: counts[i] (int32) the kept candidates of splat i; the slots cut by
// the cap are added into *n_dropped (zeroed by the caller). strides (a host
// array): T's three element strides and depth's. tau is not read when prune
// is 0. Returns a CUDA error (0 on success).
extern "C" int g4_bin_count(const float* T, const float* center, const float* radius,
                            const float* opacity, const float* tau, const float* depth,
                            const unsigned char* valid, const int* strides, int P, int gx,
                            int gy, int cap, int prune, int* counts, int* n_dropped,
                            void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Inputs in = make_inputs(T, center, radius, opacity, tau, depth, valid, strides, P, gx,
                                gy, cap);
  const int blocks = (P + BLOCK - 1) / BLOCK;
  if (prune) count_kernel<true><<<blocks, BLOCK, 0, s>>>(in, counts, n_dropped);
  else count_kernel<false><<<blocks, BLOCK, 0, s>>>(in, counts, n_dropped);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: splat i's kept entries at [incl[i-1], incl[i]) of keys (int64,
// (tile << 32) | depth bits) and ids (int32), in slot order.
extern "C" int g4_bin_emit(const float* T, const float* center, const float* radius,
                           const float* opacity, const float* tau, const float* depth,
                           const unsigned char* valid, const int* strides, int P, int gx,
                           int gy, int cap, int prune, const long long* incl, long long* keys,
                           int* ids, void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Inputs in = make_inputs(T, center, radius, opacity, tau, depth, valid, strides, P, gx,
                                gy, cap);
  const int blocks = (P + BLOCK - 1) / BLOCK;
  if (prune) emit_kernel<true><<<blocks, BLOCK, 0, s>>>(in, incl, keys, ids);
  else emit_kernel<false><<<blocks, BLOCK, 0, s>>>(in, incl, keys, ids);
  return static_cast<int>(cudaGetLastError());
}

// After the sort: gauss_id[i] = ids[perm[i]], tile_id[i] = keys[i] >> 32, and
// each tile's start and count in the sorted keys.
extern "C" int g4_bin_ranges(const long long* keys, const long long* perm, const int* ids,
                             int E, int n_tiles, int* gauss_id, int* tile_id, int* tile_start,
                             int* tile_count, void* stream) {
  const int n = max(E, n_tiles);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ranges_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, s>>>(keys, perm, ids, E, n_tiles, gauss_id,
                                                          tile_id, tile_start, tile_count);
  return static_cast<int>(cudaGetLastError());
}
