// Forward surfel compositing for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel g4splat_tpu/ops/rasterize_pallas.py::_render_kernel
// (body _render_one_tile); semantics are those of the reference renderCUDA
// (diff-surfel-rasterization forward.cu:258-443) and of the port's plain
// version, rasterize_cuda.rasterize_entries_plain (the dense oracle's
// compositing, walked in chunks).
//
// Design: one 256-thread block per 16x16 tile, one thread per pixel. The
// tile's depth-sorted entry range is staged through shared memory in batches
// of 256; each thread loads one 64-byte entry row and computes its per-entry
// terms once (T's rows, the low-pass centre recomputed from T, opacity, rgb,
// normal). Every pixel then walks the batch from registers with shared-memory
// broadcasts, compositing front to back until its transmittance would fall
// below 1e-4. The block leaves the loop once __syncthreads_count says every
// pixel is done. Results go straight into the (H, W, 13) float map and the
// (H, W) int32 n_contrib map. fp32 throughout.
//
// The ray-splat intersection is the reference's cross-product form
// (p = (x Tw - Tu) x (y Tw - Tv), forward.cu:352-366), with k and l rounded
// as the plain version rounds them (__fmul_rn/__fsub_rn: no contraction).
// The TPU kernel's bilinear form (p_i = x A_i + y B_i + C_i) cancels terms of
// size |T|^2 x at large pixel coordinates; B2 must decide rho3d <= rho2d as
// the plain version does, and that form moved whole pixels to the other
// branch.
//
// What bounds it: per (pixel, entry) pair walked it does ~47 fp32 operations
// (k, l and their cross product, one reciprocal, the two rho terms, an exp,
// alpha) plus the composite update for contributors, against 64 bytes per
// entry a tile must read (those up to where its last pixel saturates) and 56
// bytes written per pixel. The arithmetic on the pairs walked binds, at 2.4M
// splats as at 200k. The design spends nothing per pair on memory: entry
// terms are computed once per tile and read as broadcasts, and the per-pixel
// early stop plus the block-wide vote skip pairs behind saturated pixels, so
// saturated tiles never read most of their entries.
//
// nvcc contracts the remaining products and sums into fused multiply-adds,
// which round once where the plain version rounds twice: alpha >= 1/255 and
// the T crossings can decide differently at isolated pixels, so comparisons
// grade those pixels by their share of the image.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int OUT_C = 13;  // rgb(3) normal(3) depth_acc alpha dist median final_T M1 M2
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float CUTOFF_SQ = 9.0f;

// p = k x l with k = x Tw - Tu, l = y Tw - Tv for entry j of the staged batch.
template <int N>
__device__ __forceinline__ void ray_splat(float px, float py, const float (&s_T)[9][N],
                                          int j, float& p0, float& p1, float& p2) {
  const float k0 = __fsub_rn(__fmul_rn(px, s_T[6][j]), s_T[0][j]);
  const float k1 = __fsub_rn(__fmul_rn(px, s_T[7][j]), s_T[1][j]);
  const float k2 = __fsub_rn(__fmul_rn(px, s_T[8][j]), s_T[2][j]);
  const float l0 = __fsub_rn(__fmul_rn(py, s_T[6][j]), s_T[3][j]);
  const float l1 = __fsub_rn(__fmul_rn(py, s_T[7][j]), s_T[4][j]);
  const float l2 = __fsub_rn(__fmul_rn(py, s_T[8][j]), s_T[5][j]);
  p0 = k1 * l2 - k2 * l1;
  p1 = k2 * l0 - k0 * l2;
  p2 = k0 * l1 - k1 * l0;
}

template <bool WANT_AUX, bool WANT_DIST>
__global__ void __launch_bounds__(NPIX)
rasterize_fwd_kernel(const float4* __restrict__ entries,   // (E, 16) f32 rows
                     const int* __restrict__ tile_start,   // (n_tiles,)
                     const int* __restrict__ tile_count,   // (n_tiles,)
                     const float* __restrict__ bg,         // (3,)
                     int width, int height, float znear, float zfar,
                     float* __restrict__ out,              // (H, W, OUT_C)
                     int* __restrict__ n_contrib_out)      // (H, W)
{
  // Per-entry terms of the current batch (broadcast reads: no bank conflicts).
  __shared__ float s_T[9][NPIX];       // Tu0 Tu1 Tu2 Tv0 Tv1 Tv2 Tw0 Tw1 Tw2
  __shared__ float s_cx[NPIX], s_cy[NPIX], s_opa[NPIX];
  __shared__ float s_rgb[3][NPIX];
  __shared__ float s_nrm[3][NPIX];

  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int x = blockIdx.x * TILE + threadIdx.x % TILE;
  const int y = blockIdx.y * TILE + threadIdx.x / TILE;
  const bool inside = x < width && y < height;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const float m_scale = zfar / (zfar - znear);

  float T = 1.0f;
  float cr = 0.f, cg = 0.f, cb = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  float depth_acc = 0.f, median = 0.f, dist = 0.f, M1 = 0.f, M2 = 0.f;
  int last = 0;
  bool done = !inside;

  for (int base = 0; base < count; base += NPIX) {
    // Barrier and vote in one: all reads of the previous batch are finished.
    if (__syncthreads_count(done) == NPIX) break;
    const int k = base + threadIdx.x;
    if (k < count) {
      const float4* e = entries + static_cast<size_t>(start + k) * 4;
      const float4 a = e[0], b = e[1], c = e[2], d = e[3];
      const float Tu0 = a.x, Tu1 = a.y, Tu2 = a.z;
      const float Tv0 = a.w, Tv1 = b.x, Tv2 = b.y;
      const float Tw0 = b.z, Tw1 = b.w, Tw2 = c.x;
      s_T[0][threadIdx.x] = Tu0;
      s_T[1][threadIdx.x] = Tu1;
      s_T[2][threadIdx.x] = Tu2;
      s_T[3][threadIdx.x] = Tv0;
      s_T[4][threadIdx.x] = Tv1;
      s_T[5][threadIdx.x] = Tv2;
      s_T[6][threadIdx.x] = Tw0;
      s_T[7][threadIdx.x] = Tw1;
      s_T[8][threadIdx.x] = Tw2;
      // Low-pass centre from the dual conic (forward.cu:119-147).
      const float cdist = CUTOFF_SQ * (Tw0 * Tw0 + Tw1 * Tw1) - Tw2 * Tw2;
      const bool cok = fabsf(cdist) > 1e-12f;
      const float cinv = 1.0f / (cok ? cdist : 1.0f);
      s_cx[threadIdx.x] = cok ? (CUTOFF_SQ * (Tu0 * Tw0 + Tu1 * Tw1) - Tu2 * Tw2) * cinv : 0.f;
      s_cy[threadIdx.x] = cok ? (CUTOFF_SQ * (Tv0 * Tw0 + Tv1 * Tw1) - Tv2 * Tw2) * cinv : 0.f;
      s_opa[threadIdx.x] = c.y;
      s_rgb[0][threadIdx.x] = c.z;
      s_rgb[1][threadIdx.x] = c.w;
      s_rgb[2][threadIdx.x] = d.x;
      s_nrm[0][threadIdx.x] = d.y;
      s_nrm[1][threadIdx.x] = d.z;
      s_nrm[2][threadIdx.x] = d.w;
    }
    __syncthreads();
    if (done) continue;
    const int n = min(NPIX, count - base);
    for (int j = 0; j < n; ++j) {
      float p0, p1, p2;
      ray_splat(px, py, s_T, j, p0, p1, p2);
      if (!(fabsf(p2) >= 1e-20f)) continue;
      // No clamp on su/sv: an overflow drives rho3d to inf, which loses the
      // min against rho2d.
      const float inv = 1.0f / p2;
      const float su = p0 * inv;
      const float sv = p1 * inv;
      const float rho3d = su * su + sv * sv;
      const float dx = s_cx[j] - px;
      const float dy = s_cy[j] - py;
      const float rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
      const bool use3d = rho3d <= rho2d;
      const float rho = use3d ? rho3d : rho2d;
      const float z = use3d ? su * s_T[6][j] + sv * s_T[7][j] + s_T[8][j] : s_T[8][j];
      const float alpha = fminf(ALPHA_CLAMP, s_opa[j] * expf(-0.5f * rho));
      if (!(z >= znear) || !(alpha >= ALPHA_EPS)) continue;
      const float T_next = T * (1.0f - alpha);
      // Inclusive T below 1e-4: this entry and everything behind it is skipped.
      if (T_next < T_EPS) { done = true; break; }
      const float w = alpha * T;
      cr += w * s_rgb[0][j];
      cg += w * s_rgb[1][j];
      cb += w * s_rgb[2][j];
      nx += w * s_nrm[0][j];
      ny += w * s_nrm[1][j];
      nz += w * s_nrm[2][j];
      depth_acc += w * z;
      if (WANT_AUX && WANT_DIST) {
        // 2DGS distortion with exclusive running moments (forward.cu:392-400).
        const float m = m_scale * (1.0f - znear / fmaxf(z, 1e-8f));
        dist += (m * m * (1.0f - T) + M2 - 2.0f * m * M1) * w;
        M1 += m * w;
        M2 += m * m * w;
      }
      if (T > 0.5f) median = z;          // last contributor with incoming T > 0.5
      if (WANT_AUX) last = base + j + 1;  // 1-based position in the tile's range
      T = T_next;
    }
  }

  if (!inside) return;
  const size_t pix = static_cast<size_t>(y) * width + x;
  float* o = out + pix * OUT_C;
  o[0] = cr + T * bg[0];
  o[1] = cg + T * bg[1];
  o[2] = cb + T * bg[2];
  o[3] = nx;
  o[4] = ny;
  o[5] = nz;
  o[6] = depth_acc;
  o[7] = 1.0f - T;
  o[8] = dist;
  o[9] = median;
  o[10] = T;
  o[11] = M1;
  o[12] = M2;
  n_contrib_out[pix] = last;
}

template <bool A, bool D>
void launch(const float* entries, const int* tile_start, const int* tile_count,
            const float* bg, int width, int height, float znear, float zfar,
            float* out, int* n_contrib, cudaStream_t stream) {
  const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
  rasterize_fwd_kernel<A, D><<<grid, NPIX, 0, stream>>>(
      reinterpret_cast<const float4*>(entries), tile_start, tile_count, bg,
      width, height, znear, zfar, out, n_contrib);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int g4_rasterize_fwd(const float* entries, const int* tile_start,
                                const int* tile_count, const float* bg,
                                int width, int height, float znear, float zfar,
                                int want_aux, int want_dist,
                                float* out, int* n_contrib, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width > 0 && height > 0) {
    if (want_aux && want_dist)
      launch<true, true>(entries, tile_start, tile_count, bg, width, height, znear, zfar, out, n_contrib, s);
    else if (want_aux)
      launch<true, false>(entries, tile_start, tile_count, bg, width, height, znear, zfar, out, n_contrib, s);
    else
      launch<false, false>(entries, tile_start, tile_count, bg, width, height, znear, zfar, out, n_contrib, s);
  }
  return static_cast<int>(cudaGetLastError());
}
