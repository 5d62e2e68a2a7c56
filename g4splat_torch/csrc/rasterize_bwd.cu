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
// Design: one block of 256 threads, one per pixel, walks a whole tile back to
// front over the first `walk` entries of its range, walk = min(deepest
// n_contrib in the tile, tile count). Entry i's row is row gauss_id[i] of the
// per-splat table (rasterize_common.cuh), the row its gradients go to. Three
// launches on the caller's stream, no host sync:
//   1. tile_walk: one block per tile, its walk;
//   2. tile_order: one block; the tiles that walk any entry, longest walk
//      first (a counting sort over NBUCKET lengths), and the tile counter;
//   3. walk: a persistent grid (SMs x resident blocks) whose blocks take the
//      next tile of that order from an atomic counter, so the deepest tiles
//      start first and the short ones fill the end of the grid.
//
// Per entry the walk recomputes the intersection exactly as the forward
// kernel does (the reference's cross-product form, p = k x l with
// k = x Tw - Tu, l = y Tw - Tv), so both kernels decide a contributor and the
// rho3d <= rho2d branch alike, and takes the geometry VJP in the same form
// (dk = l x dp, dl = dp x k; dTu = -dk, dTv = -dl, dTw = x dk + y dl plus z's
// direct terms). Each entry's 18 per-pixel gradients are reduced over the warp
// by a fold in 20 shuffles (warp_fold; skipped when no lane of the warp
// contributes) into shared memory; after a batch of BATCH entries the block
// sums the eight warps and adds each of the entry's 18 gradients with one
// atomicAdd into the (P, 18) per-splat buffer at gauss_id. fp32 throughout,
// but for the reach box: staging computes, in double, a screen box outside
// which the entry has no pixel with alpha >= 1/255 (reach_box), and a warp
// whose 16 x 2 pixels miss it skips the entry whole. Staged entries are read
// as 16-byte broadcasts.
//
// What bounds it: per (pixel, entry) pair walked up to the pixel's n_contrib
// ~OPS_PER_PAIR_BWD fp32 operations (the alpha recompute), and per contributor
// ~OPS_PER_CONTRIB_BWD more (the compositing calculus, the geometry VJP and its
// share of the 18-value reduction over pixels), against the entries a tile
// walks (64 B each, plus their ids), the cotangent and aux maps read once and
// the gradient rows read-modified-written. The arithmetic binds.
//
// Atomics add in a different order on every run, so the gradients are not
// bit-stable. nvcc contracts multiply-adds outside the intersection's k and l.

#include <cuda_runtime.h>

#include <algorithm>

#include "rasterize_common.cuh"

namespace {

constexpr int BATCH = 32;    // entries staged per round
constexpr int GRAD_F = 18;   // dT(9) d_center(2) d_opacity d_rgb(3) d_normal(3)
constexpr int COT_C = 12;    // gC(3) gN(3) gD gA' g_dist g_med pad(2)
constexpr int ORDER_THREADS = 1024;
constexpr int NBUCKET = 32;  // walk lengths the tile order tells apart

// The work list, laid out in the caller's int scratch (2 n_tiles + 2 ints).
struct Work {
  int* walk;       // (n_tiles,) entries each tile walks
  int* order;      // (n_tiles,) the tiles that walk any entry, longest first
  int* counters;   // (2,)       next tile of the order; tiles in the order
};

Work work_layout(int* iscratch, int n_tiles) {
  return Work{iscratch, iscratch + n_tiles, iscratch + 2 * n_tiles};
}

// One batch of entries staged in shared memory, each read by a warp as a
// few 16-byte broadcasts.
struct Stage {
  float4 geo[BATCH][3];    // (Tu0 Tu1 Tu2 Tv0) (Tv1 Tv2 Tw0 Tw1) (Tw2 cx cy opa)
  float4 col[BATCH][2];    // (r g b nx) (ny nz - -)
  float4 box[BATCH];       // reach box (x0 x1 y0 y1)
  int gid[BATCH];
};

// Threads 0..n-1 stage entries e0..e0+n-1, rows gauss_id[e] of the table
// (the caller syncs after).
__device__ __forceinline__ void stage_entries(Stage& s, const float4* __restrict__ table,
                                              const int* __restrict__ gauss_id, int e0, int n) {
  if (threadIdx.x < n) {
    const int j = threadIdx.x;
    const int g = gauss_id[e0 + j];
    const Row r = load_row(table, g);
    const float2 c = conic_centre(r);
    s.geo[j][0] = r.a;
    s.geo[j][1] = r.b;
    s.geo[j][2] = make_float4(r.c.x, c.x, c.y, r.c.y);
    s.col[j][0] = make_float4(r.c.z, r.c.w, r.d.x, r.d.y);
    s.col[j][1] = make_float4(r.d.z, r.d.w, 0.f, 0.f);
    s.box[j] = reach_box(r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w, r.c.x,
                         c.x, c.y, r.c.y);
    s.gid[j] = g;
  }
}

// The ray-surfel intersection of staged entry j at pixel (px, py), as the
// forward kernel computes it.
struct Hit {
  float k0, k1, k2, l0, l1, l2;
  float inv, su, sv, dx, dy, z, eterm, a_raw, alpha, Tw0, Tw1;
  bool use3d;
};

__device__ __forceinline__ bool intersect(const Stage& s, int j, float px, float py,
                                          float znear, Hit& h) {
  const float4 g0 = s.geo[j][0], g1 = s.geo[j][1], g2 = s.geo[j][2];
  const float Tw0 = g1.z, Tw1 = g1.w, Tw2 = g2.x;
  h.Tw0 = Tw0;
  h.Tw1 = Tw1;
  // The forward kernel's intersection, written as there.
  h.k0 = __fsub_rn(__fmul_rn(px, Tw0), g0.x);
  h.k1 = __fsub_rn(__fmul_rn(px, Tw1), g0.y);
  h.k2 = __fsub_rn(__fmul_rn(px, Tw2), g0.z);
  h.l0 = __fsub_rn(__fmul_rn(py, Tw0), g0.w);
  h.l1 = __fsub_rn(__fmul_rn(py, Tw1), g1.x);
  h.l2 = __fsub_rn(__fmul_rn(py, Tw2), g1.y);
  const float p0 = h.k1 * h.l2 - h.k2 * h.l1;
  const float p1 = h.k2 * h.l0 - h.k0 * h.l2;
  const float p2 = h.k0 * h.l1 - h.k1 * h.l0;
  if (!(fabsf(p2) >= 1e-20f)) return false;
  h.inv = 1.0f / p2;
  h.su = p0 * h.inv;
  h.sv = p1 * h.inv;
  const float rho3d = h.su * h.su + h.sv * h.sv;
  h.dx = g2.y - px;
  h.dy = g2.z - py;
  const float rho2d = FILTER_INV_SQUARE * (h.dx * h.dx + h.dy * h.dy);
  h.use3d = rho3d <= rho2d;
  const float rho = h.use3d ? rho3d : rho2d;
  h.z = h.use3d ? h.su * Tw0 + h.sv * Tw1 + Tw2 : Tw2;
  h.eterm = expf(-0.5f * rho);
  h.a_raw = g2.w * h.eterm;
  h.alpha = fminf(ALPHA_CLAMP, h.a_raw);
  return h.z >= znear && h.alpha >= ALPHA_EPS;
}

// 1. walk[tile] = min(max n_contrib over the tile's pixels, tile count).
__global__ void __launch_bounds__(NPIX)
tile_walk_kernel(const float4* __restrict__ aux, const int* __restrict__ tile_count,
                 int width, int height, int gx, int* __restrict__ walk) {
  __shared__ int s_max;
  const int tile = blockIdx.x;
  const int x = (tile % gx) * TILE + threadIdx.x % TILE;
  const int y = (tile / gx) * TILE + threadIdx.x / TILE;
  if (threadIdx.x == 0) s_max = 0;
  __syncthreads();
  if (x < width && y < height) {
    const int nc = static_cast<int>(aux[static_cast<size_t>(y) * width + x].y);
    if (nc > 0) atomicMax(&s_max, nc);
  }
  __syncthreads();
  if (threadIdx.x == 0) walk[tile] = min(s_max, tile_count[tile]);
}

// 2. One block: the tiles with walk > 0 in the order the walk takes them,
// longest first by NBUCKET buckets of (walk - 1) * NBUCKET / longest walk
// (a counting sort; the order within a bucket varies from run to run), the
// count of them in counters[1] and the next-tile counter zeroed.
__global__ void __launch_bounds__(ORDER_THREADS)
tile_order_kernel(int n_tiles, Work w) {
  __shared__ int s_max, s_bucket[NBUCKET];
  const int per = (n_tiles + ORDER_THREADS - 1) / ORDER_THREADS;
  const int t0 = threadIdx.x * per;
  const int t1 = min(t0 + per, n_tiles);
  if (threadIdx.x == 0) s_max = 1;
  if (threadIdx.x < NBUCKET) s_bucket[threadIdx.x] = 0;
  __syncthreads();
  int longest = 0;
  for (int t = t0; t < t1; ++t) longest = max(longest, w.walk[t]);
  atomicMax(&s_max, longest);
  __syncthreads();
  const int max_len = s_max;
  const auto bucket = [&](int t) {
    return &s_bucket[static_cast<int>(static_cast<long long>(w.walk[t] - 1) * NBUCKET / max_len)];
  };
  for (int t = t0; t < t1; ++t)
    if (w.walk[t] > 0) atomicAdd(bucket(t), 1);
  __syncthreads();
  if (threadIdx.x == 0) {    // bucket starts, longest bucket first
    int next = 0;
    for (int b = NBUCKET - 1; b >= 0; --b) {
      const int n = s_bucket[b];
      s_bucket[b] = next;
      next += n;
    }
    w.counters[0] = 0;
    w.counters[1] = next;
  }
  __syncthreads();
  for (int t = t0; t < t1; ++t)
    if (w.walk[t] > 0) w.order[atomicAdd(bucket(t), 1)] = t;
}

// One step of the warp fold: each lane holds C values (zero past the end);
// the lane with bit O set keeps the upper ceil(C/2) of them, its partner the
// lower, each adding the other's copy.
template <int C, int O>
__device__ __forceinline__ void fold_step(float (&a)[GRAD_F], bool up) {
  constexpr int H = (C + 1) / 2;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = a[i];
    const float hi = i + H < C ? a[i + H] : 0.f;
    a[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
  }
}

// Sums the GRAD_F values over the warp's lanes in 9 + 5 + 3 + 2 + 1 = 20
// shuffles (instead of GRAD_F x 5): lane warp_fold_slot(lane) ends with the
// sum of that value; the other 14 lanes end with padding.
__device__ __forceinline__ float warp_fold(float (&a)[GRAD_F], int lane) {
  fold_step<18, 16>(a, lane & 16);
  fold_step<9, 8>(a, lane & 8);
  fold_step<5, 4>(a, lane & 4);
  fold_step<3, 2>(a, lane & 2);
  fold_step<2, 1>(a, lane & 1);
  return a[0];
}

// The value warp_fold leaves in `lane`, or -1 for padding.
__device__ __forceinline__ void fold_slot_step(int lane, int bit, int h, int& slot, int& real) {
  if (lane & bit) {
    slot += h;
    real -= h;
  } else {
    real = min(real, h);
  }
}

__device__ __forceinline__ int warp_fold_slot(int lane) {
  int slot = 0, real = GRAD_F;
  fold_slot_step(lane, 16, 9, slot, real);
  fold_slot_step(lane, 8, 5, slot, real);
  fold_slot_step(lane, 4, 3, slot, real);
  fold_slot_step(lane, 2, 2, slot, real);
  fold_slot_step(lane, 1, 1, slot, real);
  return real >= 1 ? slot : -1;
}

static_assert(GRAD_F == 18, "warp_fold's steps are laid out for 18 values");

// 3. The walk: each block takes the next tile of the order until none is left.
// Three resident blocks per SM: with distortion ptxas otherwise takes ~114
// registers (2 blocks), and the cap at 80 ran 11 % faster on the H100;
// without, a cap at 64 (4 blocks) ran 4 % slower, and a bound of one block
// per SM let ptxas take 96 registers (2 blocks), 15 % slower.
template <bool WANT_DIST>
__global__ void __launch_bounds__(NPIX, 3)
walk_kernel(const float4* __restrict__ table, const int* __restrict__ gauss_id,
            const int* __restrict__ tile_start, const float4* __restrict__ aux,
            const float* __restrict__ cot, const float* __restrict__ bg,
            int width, int height, int gx, float znear, float zfar, Work w,
            float* __restrict__ grad)             // (P, GRAD_F), accumulated
{
  __shared__ Stage s;
  __shared__ float s_part[NWARP][BATCH][GRAD_F];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_items = w.counters[1];
  const int fold_slot = warp_fold_slot(lane);
  const float m_scale = zfar / (zfar - znear);

  for (;;) {
    __syncthreads();   // every thread has read s_tile and the last batch
    if (threadIdx.x == 0) {
      const int it = atomicAdd(&w.counters[0], 1);
      s_tile = it < n_items ? w.order[it] : -1;
    }
    __syncthreads();
    const int tile = s_tile;
    if (tile < 0) break;

    const int x = (tile % gx) * TILE + threadIdx.x % TILE;
    const int y = (tile / gx) * TILE + threadIdx.x / TILE;
    const float px = static_cast<float>(x), py = static_cast<float>(y);
    const float wx = static_cast<float>((tile % gx) * TILE);
    const float wy = static_cast<float>((tile / gx) * TILE + 2 * warp);
    float T_end = 1.f, M1_tot = 0.f, M2_tot = 0.f;
    float gC0 = 0.f, gC1 = 0.f, gC2 = 0.f, gN0 = 0.f, gN1 = 0.f, gN2 = 0.f;
    float gD = 0.f, gA = 0.f, gdist = 0.f, gmed = 0.f;
    int nc = 0;
    if (x < width && y < height) {
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
    const int start = tile_start[tile];

    // The state behind the tile's last walked entry.
    float T = T_end;
    float S_wu = 0.f, S_w = 0.f, S_mw = 0.f, S_m2w = 0.f, S_wm2T = 0.f;
    bool med_done = false;

    for (int hi = w.walk[tile]; hi > 0; hi -= BATCH) {
      const int lo = max(hi - BATCH, 0);
      const int n = hi - lo;
      __syncthreads();   // the previous round's atomics have read s.gid and s_part
      stage_entries(s, table, gauss_id, start + lo, n);
      __syncthreads();

      for (int j = n - 1; j >= 0; --j) {
        float mine = 0.f;
        // A warp that the entry cannot reach skips it whole (no contributor
        // is lost: the box bounds every pixel with alpha >= 1/255).
        if (box_meets_warp(s.box[j], wx, wy)) {
          float v[GRAD_F];
#pragma unroll
          for (int i = 0; i < GRAD_F; ++i) v[i] = 0.f;
          bool contrib = false;
          Hit h;
          if (lo + j < nc && intersect(s, j, px, py, znear, h)) {
            contrib = true;
            const float Tw0 = h.Tw0, Tw1 = h.Tw1;
            const float alpha = h.alpha, z = h.z;
            const float one_m = 1.0f - alpha;
            const float T_k = T / one_m;
            const float w = alpha * T_k;
            const float4 c0 = s.col[j][0], c1 = s.col[j][1];
            float u = c0.x * gC0 + c0.y * gC1 + c0.z * gC2
                    + c0.w * gN0 + c1.x * gN1 + c1.y * gN2 + z * gD;
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
            const float gE = h.a_raw <= ALPHA_CLAMP ? dL_da : 0.f;
            const float d_rho = -0.5f * gE * h.a_raw;
            if (h.use3d) {
              const float d_su = dL_dz * Tw0 + 2.0f * h.su * d_rho;
              const float d_sv = dL_dz * Tw1 + 2.0f * h.sv * d_rho;
              const float dp0 = d_su * h.inv;
              const float dp1 = d_sv * h.inv;
              const float dp2 = -h.inv * (d_su * h.su + d_sv * h.sv);
              // dk = l x dp, dl = dp x k.
              const float dk0 = h.l1 * dp2 - h.l2 * dp1;
              const float dk1 = h.l2 * dp0 - h.l0 * dp2;
              const float dk2 = h.l0 * dp1 - h.l1 * dp0;
              const float dl0 = dp1 * h.k2 - dp2 * h.k1;
              const float dl1 = dp2 * h.k0 - dp0 * h.k2;
              const float dl2 = dp0 * h.k1 - dp1 * h.k0;
              v[0] = -dk0; v[1] = -dk1; v[2] = -dk2;
              v[3] = -dl0; v[4] = -dl1; v[5] = -dl2;
              v[6] = px * dk0 + py * dl0 + dL_dz * h.su;
              v[7] = px * dk1 + py * dl1 + dL_dz * h.sv;
              v[8] = px * dk2 + py * dl2 + dL_dz;
            } else {
              const float c2 = 2.0f * FILTER_INV_SQUARE * d_rho;
              v[8] = dL_dz;
              v[9] = c2 * h.dx;
              v[10] = c2 * h.dy;
            }
            v[11] = gE * h.eterm;
            v[12] = w * gC0; v[13] = w * gC1; v[14] = w * gC2;
            v[15] = w * gN0; v[16] = w * gN1; v[17] = w * gN2;
          }
          if (__any_sync(0xffffffffu, contrib)) mine = warp_fold(v, lane);
        }
        if (fold_slot >= 0) s_part[warp][j][fold_slot] = mine;
      }
      __syncthreads();

      for (int t = threadIdx.x; t < n * GRAD_F; t += NPIX) {
        const int j = t / GRAD_F, o = t % GRAD_F;
        float g = 0.f;
#pragma unroll
        for (int q = 0; q < NWARP; ++q) g += s_part[q][j][o];
        if (g != 0.f)
          atomicAdd(grad + static_cast<size_t>(s.gid[j]) * GRAD_F + o, g);
      }
    }
  }
}

// Blocks of the persistent grid: SMs x resident blocks, at most n_tiles.
template <typename K>
cudaError_t persistent_blocks(K kernel, int n_tiles, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NPIX, 0);
  *blocks = std::max(1, std::min(n_tiles, sms * std::max(per_sm, 1)));
  return e;
}

template <bool D>
cudaError_t launch(const float* table, const int* gauss_id, const int* tile_start,
                   const int* tile_count, const float* aux, const float* cot, const float* bg,
                   int width, int height, float znear, float zfar, int* iscratch, float* grad,
                   cudaStream_t stream) {
  const int gx = (width + TILE - 1) / TILE;
  const int n_tiles = gx * ((height + TILE - 1) / TILE);
  const Work w = work_layout(iscratch, n_tiles);
  const float4* a4 = reinterpret_cast<const float4*>(aux);
  int blocks = 1;
  cudaError_t e = persistent_blocks(walk_kernel<D>, n_tiles, &blocks);
  if (e != cudaSuccess) return e;
  tile_walk_kernel<<<n_tiles, NPIX, 0, stream>>>(a4, tile_count, width, height, gx, w.walk);
  tile_order_kernel<<<1, ORDER_THREADS, 0, stream>>>(n_tiles, w);
  walk_kernel<D><<<blocks, NPIX, 0, stream>>>(reinterpret_cast<const float4*>(table), gauss_id,
                                              tile_start, a4, cot, bg, width, height, gx, znear,
                                              zfar, w, grad);
  return cudaGetLastError();
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

// The backward. iscratch holds 2 n_tiles + 2 ints (the work list: tile walks,
// tile order, counters), which it leaves filled in. Adds into `grad` (the
// caller zeroes it). Returns the first CUDA error (0 on success).
extern "C" int g4_rasterize_bwd(const float* table, const int* gauss_id,
                                const int* tile_start, const int* tile_count,
                                const float* aux, const float* cot, const float* bg,
                                int width, int height, float znear, float zfar,
                                int want_dist, int* iscratch, float* grad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 0 || height <= 0) return 0;
  return static_cast<int>(want_dist
      ? launch<true>(table, gauss_id, tile_start, tile_count, aux, cot, bg, width, height,
                     znear, zfar, iscratch, grad, s)
      : launch<false>(table, gauss_id, tile_start, tile_count, aux, cot, bg, width, height,
                      znear, zfar, iscratch, grad, s));
}

// The walk kernel of the mode: registers, local (spill) bytes, static shared
// bytes and resident blocks per SM into out[0..3], then the device's SM
// count into out[4]. Returns a CUDA error (0 on success).
extern "C" int g4_rasterize_bwd_info(int want_dist, int* out) {
  cudaError_t e = want_dist ? kernel_info(walk_kernel<true>, out)
                            : kernel_info(walk_kernel<false>, out);
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&out[4], cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}
