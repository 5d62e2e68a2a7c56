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
// of 256. Entry i of the range is row gauss_id[i] of the per-splat table
// (rasterize_common.cuh): no per-entry rows are gathered before the kernel.
// Each thread stages one entry: its row, the low-pass centre recomputed from
// T, as 16-byte records a warp reads as broadcasts, and its reach box (in
// double: outside it the entry has no pixel with alpha >= 1/255). For each
// of the 8 warps (16 x 2 pixels each) the block ballots which staged entries'
// boxes meet the warp's pixels, so a warp walks only those entries, taken in
// order from its bit words; the others cannot change its pixels (alpha below
// 1/255 leaves T, n_contrib and every map as they are). Each pixel composites
// front to back until its transmittance would fall below 1e-4. The block
// leaves the loop once __syncthreads_count says every pixel is done. Results
// go straight into the (H, W, 13) float map and the (H, W) int32 n_contrib
// map. fp32 throughout, but for the reach box.
//
// The ray-splat intersection is the reference's cross-product form
// (p = (x Tw - Tu) x (y Tw - Tv), forward.cu:352-366), with k and l rounded
// as the plain version rounds them (__fmul_rn/__fsub_rn: no contraction).
// The TPU kernel's bilinear form (p_i = x A_i + y B_i + C_i) cancels terms of
// size |T|^2 x at large pixel coordinates; B2 must decide rho3d <= rho2d as
// the plain version does, and that form moved whole pixels to the other
// branch.
//
// What bounds it: per (pixel, entry) pair walked it does 46 fp32 operations
// (k and l 12, their cross product 9, the |p2| test, one reciprocal, su/sv 2,
// rho3d 3, dx/dy 2, rho2d 4, the branch 2, z 4, the exp and its argument 2,
// alpha 2: OPS_PER_PAIR, 44, in rasterize_cuda.py; then the z and alpha
// tests 2) plus the composite update for contributors, against 64 bytes per
// entry a tile must read
// (those up to where its last pixel saturates) and 56 bytes written per
// pixel. The arithmetic on the pairs walked binds, at 2.4M splats as at 200k.
// The design spends nothing per pair on memory, and skips the pairs whose
// entry cannot reach a warp's pixels.
//
// nvcc contracts the remaining products and sums into fused multiply-adds,
// which round once where the plain version rounds twice: alpha >= 1/255 and
// the T crossings can decide differently at isolated pixels, so comparisons
// grade those pixels by their share of the image.

#include <cuda_runtime.h>

#include "rasterize_common.cuh"

namespace {

constexpr int OUT_C = 13;  // rgb(3) normal(3) depth_acc alpha dist median final_T M1 M2
constexpr int NWORD = NPIX / 32;   // bit words per warp and batch

// One batch of NPIX entries staged in shared memory.
struct Stage {
  float4 geo[NPIX][3];        // (Tu0 Tu1 Tu2 Tv0) (Tv1 Tv2 Tw0 Tw1) (Tw2 cx cy opa)
  float4 col[NPIX][2];        // (r g b nx) (ny nz - -)
  unsigned bits[NWARP][NWORD];  // bit j of word s: entry 32 s + j reaches the warp
};

// Thread t stages entry base + t of the tile's range (nothing past `count`);
// its warp then ballots, for every warp of the block, which of its 32
// entries' reach boxes meet that warp's 16 x 2 pixels. The caller syncs.
__device__ __forceinline__ void stage_batch(Stage& s, const float4* __restrict__ table,
                                            const int* __restrict__ gauss_id, int start,
                                            int base, int count, float tx, float ty) {
  const int t = threadIdx.x;
  float4 box = make_float4(BIG, -BIG, BIG, -BIG);
  if (base + t < count) {
    const Row r = load_row(table, gauss_id[start + base + t]);
    const float2 c = conic_centre(r);
    s.geo[t][0] = r.a;
    s.geo[t][1] = r.b;
    s.geo[t][2] = make_float4(r.c.x, c.x, c.y, r.c.y);
    s.col[t][0] = make_float4(r.c.z, r.c.w, r.d.x, r.d.y);
    s.col[t][1] = make_float4(r.d.z, r.d.w, 0.f, 0.f);
    box = reach_box(r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w, r.c.x, c.x, c.y,
                    r.c.y);
  }
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    const unsigned word = __ballot_sync(0xffffffffu, box_meets_warp(box, tx, ty + 2.f * w));
    if ((t & 31) == 0) s.bits[w][t >> 5] = word;
  }
}

template <bool WANT_AUX, bool WANT_DIST>
__global__ void __launch_bounds__(NPIX)
rasterize_fwd_kernel(const float4* __restrict__ table,     // (P, 16) f32 rows
                     const int* __restrict__ gauss_id,     // (E,) row of each entry
                     const int* __restrict__ tile_start,   // (n_tiles,)
                     const int* __restrict__ tile_count,   // (n_tiles,)
                     const float* __restrict__ bg,         // (3,)
                     int width, int height, float znear, float zfar,
                     float* __restrict__ out,              // (H, W, OUT_C)
                     int* __restrict__ n_contrib_out)      // (H, W)
{
  __shared__ Stage s;

  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int x = blockIdx.x * TILE + threadIdx.x % TILE;
  const int y = blockIdx.y * TILE + threadIdx.x / TILE;
  const int warp = threadIdx.x >> 5;
  const bool inside = x < width && y < height;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const float tx = static_cast<float>(blockIdx.x * TILE);
  const float ty = static_cast<float>(blockIdx.y * TILE);
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
    stage_batch(s, table, gauss_id, start, base, count, tx, ty);
    __syncthreads();
    if (done) continue;
    for (int w = 0; w < NWORD; ++w) {
      unsigned word = s.bits[warp][w];
      while (word) {
        const int j = w * 32 + __ffs(word) - 1;
        word &= word - 1;
        const float4 g0 = s.geo[j][0], g1 = s.geo[j][1], g2 = s.geo[j][2];
        const float Tw0 = g1.z, Tw1 = g1.w, Tw2 = g2.x;
        const float k0 = __fsub_rn(__fmul_rn(px, Tw0), g0.x);
        const float k1 = __fsub_rn(__fmul_rn(px, Tw1), g0.y);
        const float k2 = __fsub_rn(__fmul_rn(px, Tw2), g0.z);
        const float l0 = __fsub_rn(__fmul_rn(py, Tw0), g0.w);
        const float l1 = __fsub_rn(__fmul_rn(py, Tw1), g1.x);
        const float l2 = __fsub_rn(__fmul_rn(py, Tw2), g1.y);
        const float p0 = k1 * l2 - k2 * l1;
        const float p1 = k2 * l0 - k0 * l2;
        const float p2 = k0 * l1 - k1 * l0;
        if (!(fabsf(p2) >= 1e-20f)) continue;
        // No clamp on su/sv: an overflow drives rho3d to inf, which loses the
        // min against rho2d.
        const float inv = 1.0f / p2;
        const float su = p0 * inv;
        const float sv = p1 * inv;
        const float rho3d = su * su + sv * sv;
        const float dx = g2.y - px;
        const float dy = g2.z - py;
        const float rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
        const bool use3d = rho3d <= rho2d;
        const float rho = use3d ? rho3d : rho2d;
        const float z = use3d ? su * Tw0 + sv * Tw1 + Tw2 : Tw2;
        const float alpha = fminf(ALPHA_CLAMP, g2.w * expf(-0.5f * rho));
        if (!(z >= znear) || !(alpha >= ALPHA_EPS)) continue;
        const float T_next = T * (1.0f - alpha);
        // Inclusive T below 1e-4: this entry and everything behind it is skipped.
        if (T_next < T_EPS) { done = true; break; }
        const float wgt = alpha * T;
        const float4 c0 = s.col[j][0], c1 = s.col[j][1];
        cr += wgt * c0.x;
        cg += wgt * c0.y;
        cb += wgt * c0.z;
        nx += wgt * c0.w;
        ny += wgt * c1.x;
        nz += wgt * c1.y;
        depth_acc += wgt * z;
        if (WANT_AUX && WANT_DIST) {
          // 2DGS distortion with exclusive running moments (forward.cu:392-400).
          const float m = m_scale * (1.0f - znear / fmaxf(z, 1e-8f));
          dist += (m * m * (1.0f - T) + M2 - 2.0f * m * M1) * wgt;
          M1 += m * wgt;
          M2 += m * m * wgt;
        }
        if (T > 0.5f) median = z;          // last contributor with incoming T > 0.5
        if (WANT_AUX) last = base + j + 1;  // 1-based position in the tile's range
        T = T_next;
      }
      if (done) break;
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
void launch(const float* table, const int* gauss_id, const int* tile_start,
            const int* tile_count, const float* bg, int width, int height, float znear,
            float zfar, float* out, int* n_contrib, cudaStream_t stream) {
  const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
  rasterize_fwd_kernel<A, D><<<grid, NPIX, 0, stream>>>(
      reinterpret_cast<const float4*>(table), gauss_id, tile_start, tile_count, bg,
      width, height, znear, zfar, out, n_contrib);
}

template <typename K>
cudaError_t kernel_info(K kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, NPIX, 0);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int g4_rasterize_fwd(const float* table, const int* gauss_id,
                                const int* tile_start, const int* tile_count, const float* bg,
                                int width, int height, float znear, float zfar,
                                int want_aux, int want_dist,
                                float* out, int* n_contrib, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width > 0 && height > 0) {
    if (want_aux && want_dist)
      launch<true, true>(table, gauss_id, tile_start, tile_count, bg, width, height, znear,
                         zfar, out, n_contrib, s);
    else if (want_aux)
      launch<true, false>(table, gauss_id, tile_start, tile_count, bg, width, height, znear,
                          zfar, out, n_contrib, s);
    else
      launch<false, false>(table, gauss_id, tile_start, tile_count, bg, width, height, znear,
                           zfar, out, n_contrib, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel of the mode (want_aux, want_dist): registers, local (spill)
// bytes, static shared bytes and resident blocks per SM into out[0..3], then
// the device's SM count into out[4]. Returns a CUDA error (0 on success).
extern "C" int g4_rasterize_fwd_info(int want_aux, int want_dist, int* out) {
  cudaError_t e = want_aux && want_dist ? kernel_info(rasterize_fwd_kernel<true, true>, out)
                  : want_aux            ? kernel_info(rasterize_fwd_kernel<true, false>, out)
                                        : kernel_info(rasterize_fwd_kernel<false, false>, out);
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&out[4], cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}
