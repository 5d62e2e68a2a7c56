// Backward surfel compositing for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel g4splat_tpu/ops/rasterize_pallas_bwd.py::_bwd_kernel
// (body _bwd_one_tile, geometry VJP _chunk_geom_bwd) together with the
// entry->splat reduction that followed it (rasterize_pallas.py::_entry_to_splat).
// Semantics are those of the reference BACKWARD::render (diff-surfel-rasterization
// backward.cu:144-585) and of the port's plain version,
// rasterize_cuda_bwd.rasterize_backward_plain.
//
// Per pixel, walking its contributors back to front from the saved final_T:
//   T_k      = T_{k+1} / (1 - a_k)                       (unwound by division)
//   u_k      = c_k.gC + n_k.gN + z_k gD
//              + g_dist (m_k^2 A_k + M2_k - 2 m_k M1_k + m_k^2 S_w - 2 m_k S_mw)
//   dL/da_k  = T_k u_k + (-S_wu - gT_end T_end + g_dist S_wm2T) / max(1 - a_k, 1e-3)
//   dL/dm_k  = g_dist w_k (2 m_k A_k - 2 M1_k + 2 m_k S_w - 2 S_mw)
//   dL/dz_k  = w_k gD + dL/dm_k dm/dz (+ g_med at the median contributor)
// with S_* the sums over the contributors behind k, gT_end = bg.gC - gA (the
// caller folds the final_T cotangent into gA), A_k = 1 - T_k, and the prefix
// moments M1_k/M2_k recovered as the saved totals minus the suffix sums. The
// early-stop set is rebuilt from n_contrib; the median depth's gradient goes
// to the last contributor whose incoming T exceeds 0.5, found once per pixel
// (the first such entry of the back-to-front walk). d_center comes only from
// the 2D low-pass branch (backward.cu:431-432); densify reads it.
//
// Design: one 256-thread block per 16x16 tile, one thread per pixel. The block
// walks the tile's range back to front from its deepest n_contrib, staging
// BATCH entries at a time into shared memory (T's rows and the low-pass centre
// computed once). Each thread carries its T and the five suffix sums in
// registers and skips entries past its own n_contrib. It recomputes the
// intersection exactly as the forward kernel does (the reference's
// cross-product form, p = k x l with k = x Tw - Tu, l = y Tw - Tv), so both
// kernels decide a contributor and the rho3d <= rho2d branch alike, and takes
// the geometry VJP in the same form (dk = l x dp, dl = dp x k; dTu = -dk,
// dTv = -dl, dTw = x dk + y dl plus z's direct terms). Each entry's 18
// per-pixel gradients are reduced over the warp with shuffles (skipped when no
// lane of the warp contributes) into shared memory; after the batch the block
// sums the eight warps and adds each of the entry's 18 gradients with one
// atomicAdd into the (P, 18) per-splat buffer at gauss_id. fp32 throughout.
//
// What bounds it: per (pixel, entry) pair walked up to the pixel's n_contrib
// it does ~OPS_PER_PAIR_BWD fp32 operations (the alpha recompute), and per
// contributor ~OPS_PER_CONTRIB_BWD more (the compositing calculus, the
// geometry VJP and its share of the 18-value reduction over pixels), against
// the entries a tile walks (64 B each, plus their ids), the cotangent and aux
// maps read once, and the gradient rows read-modified-written. The arithmetic
// on the pairs binds. The design spends no device memory per pair: per-pixel
// state stays in registers, per-entry terms in shared memory, and the
// per-entry reduction leaves only 18 atomics per entry that any pixel touched.
//
// Atomics add in a different order on every run, so the gradients are not
// bit-stable. nvcc contracts multiply-adds outside the intersection's k and l.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int NWARP = NPIX / 32;
constexpr int BATCH = 32;    // entries staged per round
constexpr int GRAD_F = 18;   // dT(9) d_center(2) d_opacity d_rgb(3) d_normal(3)
constexpr int COT_C = 12;    // gC(3) gN(3) gD gA' g_dist g_med pad(2)
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float CUTOFF_SQ = 9.0f;

template <bool WANT_DIST>
__global__ void __launch_bounds__(NPIX)
rasterize_bwd_kernel(const float4* __restrict__ entries,   // (E, 16) f32 rows
                     const int* __restrict__ gauss_id,     // (E,)
                     const int* __restrict__ tile_start,   // (n_tiles,)
                     const int* __restrict__ tile_count,   // (n_tiles,)
                     const float4* __restrict__ aux,       // (H, W) final_T n_contrib M1 M2
                     const float* __restrict__ cot,        // (H, W, COT_C)
                     const float* __restrict__ bg,         // (3,)
                     int width, int height, float znear, float zfar,
                     float* __restrict__ grad)             // (P, GRAD_F), accumulated
{
  __shared__ float s_T[9][BATCH];       // Tu0 Tu1 Tu2 Tv0 Tv1 Tv2 Tw0 Tw1 Tw2
  __shared__ float s_cx[BATCH], s_cy[BATCH], s_opa[BATCH];
  __shared__ float s_rgb[3][BATCH], s_nrm[3][BATCH];
  __shared__ int s_gid[BATCH];
  __shared__ float s_part[NWARP][BATCH][GRAD_F];
  __shared__ int s_last;

  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = blockIdx.x * TILE + threadIdx.x % TILE;
  const int y = blockIdx.y * TILE + threadIdx.x / TILE;
  const bool inside = x < width && y < height;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const float m_scale = zfar / (zfar - znear);

  float T_end = 1.f, M1_tot = 0.f, M2_tot = 0.f;
  int nc = 0;
  float gC0 = 0.f, gC1 = 0.f, gC2 = 0.f, gN0 = 0.f, gN1 = 0.f, gN2 = 0.f;
  float gD = 0.f, gA = 0.f, gdist = 0.f, gmed = 0.f;
  if (inside) {
    const size_t pix = static_cast<size_t>(y) * width + x;
    const float4 a = aux[pix];
    T_end = a.x;
    nc = static_cast<int>(a.y);
    M1_tot = a.z;
    M2_tot = a.w;
    const float* c = cot + pix * COT_C;
    gC0 = c[0]; gC1 = c[1]; gC2 = c[2];
    gN0 = c[3]; gN1 = c[4]; gN2 = c[5];
    gD = c[6]; gA = c[7]; gdist = c[8]; gmed = c[9];
  }
  const float t_end_term = (bg[0] * gC0 + bg[1] * gC1 + bg[2] * gC2 - gA) * T_end;

  if (threadIdx.x == 0) s_last = 0;
  __syncthreads();
  if (nc > 0) atomicMax(&s_last, nc);
  __syncthreads();
  const int last = min(s_last, count);

  float T = T_end;
  float S_wu = 0.f, S_w = 0.f, S_mw = 0.f, S_m2w = 0.f, S_wm2T = 0.f;
  bool med_done = false;

  for (int hi = last; hi > 0; hi -= BATCH) {
    const int lo = max(hi - BATCH, 0);
    const int n = hi - lo;
    if (threadIdx.x < n) {
      const int e = start + lo + threadIdx.x;
      const float4* row = entries + static_cast<size_t>(e) * 4;
      const float4 a = row[0], b = row[1], c = row[2], d = row[3];
      const float Tu0 = a.x, Tu1 = a.y, Tu2 = a.z;
      const float Tv0 = a.w, Tv1 = b.x, Tv2 = b.y;
      const float Tw0 = b.z, Tw1 = b.w, Tw2 = c.x;
      const int j = threadIdx.x;
      s_T[0][j] = Tu0; s_T[1][j] = Tu1; s_T[2][j] = Tu2;
      s_T[3][j] = Tv0; s_T[4][j] = Tv1; s_T[5][j] = Tv2;
      s_T[6][j] = Tw0; s_T[7][j] = Tw1; s_T[8][j] = Tw2;
      // Low-pass centre from the dual conic, as in the forward kernel.
      const float cdist = CUTOFF_SQ * (Tw0 * Tw0 + Tw1 * Tw1) - Tw2 * Tw2;
      const bool cok = fabsf(cdist) > 1e-12f;
      const float cinv = 1.0f / (cok ? cdist : 1.0f);
      s_cx[j] = cok ? (CUTOFF_SQ * (Tu0 * Tw0 + Tu1 * Tw1) - Tu2 * Tw2) * cinv : 0.f;
      s_cy[j] = cok ? (CUTOFF_SQ * (Tv0 * Tw0 + Tv1 * Tw1) - Tv2 * Tw2) * cinv : 0.f;
      s_opa[j] = c.y;
      s_rgb[0][j] = c.z; s_rgb[1][j] = c.w; s_rgb[2][j] = d.x;
      s_nrm[0][j] = d.y; s_nrm[1][j] = d.z; s_nrm[2][j] = d.w;
      s_gid[j] = gauss_id[e];
    }
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {
      float v[GRAD_F];
#pragma unroll
      for (int i = 0; i < GRAD_F; ++i) v[i] = 0.f;
      bool contrib = false;
      if (lo + j < nc) {
        // The forward kernel's intersection, written as there.
        const float Tw0 = s_T[6][j], Tw1 = s_T[7][j], Tw2 = s_T[8][j];
        const float k0 = __fsub_rn(__fmul_rn(px, Tw0), s_T[0][j]);
        const float k1 = __fsub_rn(__fmul_rn(px, Tw1), s_T[1][j]);
        const float k2 = __fsub_rn(__fmul_rn(px, Tw2), s_T[2][j]);
        const float l0 = __fsub_rn(__fmul_rn(py, Tw0), s_T[3][j]);
        const float l1 = __fsub_rn(__fmul_rn(py, Tw1), s_T[4][j]);
        const float l2 = __fsub_rn(__fmul_rn(py, Tw2), s_T[5][j]);
        const float p0 = k1 * l2 - k2 * l1;
        const float p1 = k2 * l0 - k0 * l2;
        const float p2 = k0 * l1 - k1 * l0;
        if (fabsf(p2) >= 1e-20f) {
          const float inv = 1.0f / p2;
          const float su = p0 * inv;
          const float sv = p1 * inv;
          const float rho3d = su * su + sv * sv;
          const float dx = s_cx[j] - px;
          const float dy = s_cy[j] - py;
          const float rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
          const bool use3d = rho3d <= rho2d;
          const float rho = use3d ? rho3d : rho2d;
          const float z = use3d ? su * Tw0 + sv * Tw1 + Tw2 : Tw2;
          const float eterm = expf(-0.5f * rho);
          const float a_raw = s_opa[j] * eterm;
          const float alpha = fminf(ALPHA_CLAMP, a_raw);
          if (z >= znear && alpha >= ALPHA_EPS) {
            contrib = true;
            const float one_m = 1.0f - alpha;
            const float T_k = T / one_m;
            const float w = alpha * T_k;
            float u = s_rgb[0][j] * gC0 + s_rgb[1][j] * gC1 + s_rgb[2][j] * gC2
                    + s_nrm[0][j] * gN0 + s_nrm[1][j] * gN1 + s_nrm[2][j] * gN2 + z * gD;
            float num = -S_wu - t_end_term;
            float dL_dz = w * gD;
            float mw = 0.f, m2w = 0.f, m = 0.f;
            if (WANT_DIST) {
              m = m_scale * (1.0f - znear / fmaxf(z, 1e-8f));
              mw = m * w;
              m2w = m * m * w;
              const float M1_k = M1_tot - (S_mw + mw);
              const float M2_k = M2_tot - (S_m2w + m2w);
              const float A_k = 1.0f - T_k;
              u += gdist * (m * m * A_k + M2_k - 2.0f * m * M1_k
                            + m * m * S_w - 2.0f * m * S_mw);
              num += gdist * S_wm2T;
              const float dL_dm = gdist * w * (2.0f * m * A_k - 2.0f * M1_k
                                               + 2.0f * m * S_w - 2.0f * S_mw);
              const float zc = fmaxf(z, 1e-8f);
              dL_dz += dL_dm * (zfar * znear / ((zfar - znear) * zc * zc));
            }
            const float dL_da = T_k * u + num / fmaxf(one_m, 1e-3f);
            if (!med_done && T_k > 0.5f) {
              dL_dz += gmed;
              med_done = true;
            }
            // Suffix sums for the entries in front of this one.
            S_wu += w * u;
            if (WANT_DIST) {
              S_w += w;
              S_mw += mw;
              S_m2w += m2w;
              S_wm2T += w * m * m * T_k;
            }
            T = T_k;

            // Geometry VJP (_chunk_geom_bwd): alpha = min(0.99, opa exp(-rho/2)),
            // rho = min(rho3d, rho2d), z = use3d ? su Tw0 + sv Tw1 + Tw2 : Tw2.
            // A contributor on the 3D branch has rho3d <= 2 ln(255) and so a
            // small su, sv: no clamp is needed on this path.
            const float gE = a_raw <= ALPHA_CLAMP ? dL_da : 0.f;
            const float d_rho = -0.5f * gE * a_raw;
            if (use3d) {
              const float d_su = dL_dz * Tw0 + 2.0f * su * d_rho;
              const float d_sv = dL_dz * Tw1 + 2.0f * sv * d_rho;
              const float dp0 = d_su * inv;
              const float dp1 = d_sv * inv;
              const float dp2 = -inv * (d_su * su + d_sv * sv);
              // dk = l x dp, dl = dp x k.
              const float dk0 = l1 * dp2 - l2 * dp1;
              const float dk1 = l2 * dp0 - l0 * dp2;
              const float dk2 = l0 * dp1 - l1 * dp0;
              const float dl0 = dp1 * k2 - dp2 * k1;
              const float dl1 = dp2 * k0 - dp0 * k2;
              const float dl2 = dp0 * k1 - dp1 * k0;
              v[0] = -dk0; v[1] = -dk1; v[2] = -dk2;
              v[3] = -dl0; v[4] = -dl1; v[5] = -dl2;
              v[6] = px * dk0 + py * dl0 + dL_dz * su;
              v[7] = px * dk1 + py * dl1 + dL_dz * sv;
              v[8] = px * dk2 + py * dl2 + dL_dz;
            } else {
              const float c2 = 2.0f * FILTER_INV_SQUARE * d_rho;
              v[8] = dL_dz;
              v[9] = c2 * dx;
              v[10] = c2 * dy;
            }
            v[11] = gE * eterm;
            v[12] = w * gC0; v[13] = w * gC1; v[14] = w * gC2;
            v[15] = w * gN0; v[16] = w * gN1; v[17] = w * gN2;
          }
        }
      }
      float mine = 0.f;
      if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
        for (int i = 0; i < GRAD_F; ++i) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
        }
#pragma unroll
        for (int i = 0; i < GRAD_F; ++i)
          if (lane == i) mine = v[i];
      }
      if (lane < GRAD_F) s_part[warp][j][lane] = mine;
    }
    __syncthreads();

    for (int t = threadIdx.x; t < n * GRAD_F; t += NPIX) {
      const int j = t / GRAD_F, o = t % GRAD_F;
      float g = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) g += s_part[w][j][o];
      if (g != 0.f)
        atomicAdd(grad + static_cast<size_t>(s_gid[j]) * GRAD_F + o, g);
    }
    __syncthreads();   // the next round restages the shared entry terms
  }
}

template <bool D>
void launch(const float* entries, const int* gauss_id, const int* tile_start,
            const int* tile_count, const float* aux, const float* cot, const float* bg,
            int width, int height, float znear, float zfar, float* grad,
            cudaStream_t stream) {
  const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
  rasterize_bwd_kernel<D><<<grid, NPIX, 0, stream>>>(
      reinterpret_cast<const float4*>(entries), gauss_id, tile_start, tile_count,
      reinterpret_cast<const float4*>(aux), cot, bg, width, height, znear, zfar, grad);
}

}  // namespace

// Adds into `grad` (the caller zeroes it). Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int g4_rasterize_bwd(const float* entries, const int* gauss_id,
                                const int* tile_start, const int* tile_count,
                                const float* aux, const float* cot, const float* bg,
                                int width, int height, float znear, float zfar,
                                int want_dist, float* grad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width > 0 && height > 0) {
    if (want_dist)
      launch<true>(entries, gauss_id, tile_start, tile_count, aux, cot, bg, width, height, znear, zfar, grad, s);
    else
      launch<false>(entries, gauss_id, tile_start, tile_count, aux, cot, bg, width, height, znear, zfar, grad, s);
  }
  return static_cast<int>(cudaGetLastError());
}
