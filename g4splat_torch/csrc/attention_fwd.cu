// Kernel B3: exact non-causal attention forward, softmax(Q Kᵀ / √D) V, at
// fp32 accuracy, for (B, N, H, D) queries against (B, M, H, D) keys and
// values.
//
// Replaces g4splat_tpu/ops/attention.py::_tpu_flash (the flash-attention
// Pallas kernel that ships with JAX), the attention of the See3D MV-UNet.
//
// What bounds it on an H100: 4·B·H·N·M·D operations against
// 4·(2·B·N·H·D + 2·B·M·H·D) bytes. At the See3D self-attention shape
// (B=2, H=5, D=64, N=M=36864) that is 3.5e12 operations against 75 MB. On
// the CUDA cores (67 TFLOP/s fp32) that is ~52 ms. The tensor cores have no
// fp32 mode, so this kernel runs every product as three TF32 products (below):
// 3 × 3.5e12 at 495 TFLOP/s is ~21 ms, and that is the bound it is held to.
// One exp2 per (query, key) pair on the SFUs (16 per clock and SM) is ~3 ms.
//
// Precision: 3×TF32. Each fp32 operand x is split into hi = tf32(x) and
// lo = tf32(x − hi) (round to nearest, ties away), and each product is taken
// as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with fp32 accumulation, the small
// terms first (as CUTLASS's OpMultiplyAddFastF32). Both products, QKᵀ and PV,
// are split: one TF32 product alone puts the output ~4e-4 off fp32. The
// split keeps the result as close to a float64 reference as the fp32 plain
// version is; it does not depend on PyTorch's TF32 flags.
//
// Design for D = 64 (every See3D shape): Hopper's warpgroup products,
// `wgmma.mma_async` m64n64k8 TF32, in blocks of three warpgroups for 128
// queries of one (batch, head).
// - A producer warpgroup loads each 64-key tile of K and V into registers
//   (rows past M as zeros), splits it and writes four operand tiles (K hi,
//   K lo, Vᵀ hi, Vᵀ lo) in wgmma's K-major core-matrix layout into one of
//   two stages in shared memory, handed over by mbarriers (full / empty).
//   K and V are split after the load, never in device memory: every block
//   re-reads its head's K and V from L2, and pre-split operands would double
//   those bytes. Split on the consumers' side, the split held them 10 of
//   46 ms at ds=1 (PERF.md).
// - Two consumer warpgroups own 64 query rows each. Each keeps its q·(1/√D)
//   split into hi/lo tiles in shared memory (register room: 384 threads
//   leave 168 registers each), its output accumulator and the rows' running
//   max and sum in registers.
// - S = Q Kᵀ: A and B from shared memory, 24 products per tile.
// - O += P V: TF32 wgmma takes B only K-major, so the producer writes V
//   transposed. The sum over keys does not depend on their order, so within
//   each group of 8 keys Vᵀ holds them in the order of the S accumulator
//   (keys 2t and 2t + 1 at columns t and t + 4): P goes from the S
//   accumulator to A fragments in registers without moving between threads.
//   Each tile's P V is taken in its own accumulator and added to the running
//   output by a rounded FMA: the tensor cores add with truncation, which
//   over the 576 tiles of a 36864-key row put a running sum 1e-4 off.
// The online softmax runs on the S accumulator: row max and sum over the
// four threads of a quad by shuffles, exp2 on the SFUs. q carries fp32 1/√D
// as the plain version's does, and each probability is exp2((s − m)·log2 e):
// the difference is taken before the change of base, so near-tied scores
// round as in the plain version. The running max starts at a finite large
// negative (as the JAX `_NEG_INF`), so exp(m_old − m_new) never makes a NaN.
//
// D ∈ {16, 32, 128} keep the SIMT design of the first port (fp32 FMAs on the
// CUDA cores, one thread or thread pair per query row, 16 keys scored at a
// time). No See3D shape has them.
//
// q, k, v and out are read and written through their own strides (the
// innermost dimension must be contiguous and 16-byte aligned), so the
// wrapper makes no transposed copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -0.7f * 3.402823466e+38f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long qb, qn, qh, kb, km, kh, vb, vm, vh, ob, on, oh;
};

// ---------------------------------------------------------------------------
// Tensor-core path, D = 64: wgmma m64n64k8 TF32, one producer warpgroup and
// two consumer warpgroups.

struct Tc {
  static constexpr int D = 64;
  static constexpr int KB = 64;                    // keys per tile
  static constexpr int CONSUMERS = 2;              // consumer warpgroups, 64 rows each
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int QB = 64 * CONSUMERS;        // query rows per block
  static constexpr int STAGES = 2;
  static constexpr int OP = KB * D;                // one split operand tile (floats)
  static constexpr int QT = 64 * D;                // one warpgroup's q tile (floats)
  // Shared memory: STAGES operand stages of K hi, K lo, Vᵀ hi, Vᵀ lo; each
  // consumer's q hi and q lo; then the stages' full and empty barriers.
  static constexpr int BARS = 4 * STAGES * OP + 2 * CONSUMERS * QT;   // floats before them
  static constexpr int SMEM = BARS * 4 + 2 * STAGES * 8;
  // Operand tiles in wgmma's K-major layout without swizzle: core matrices
  // of 8 rows × 4 floats (128 bytes), those adjacent along K 128 bytes
  // apart (LBO), those adjacent along M/N a whole K extent apart (SBO). Every
  // tile here has a K extent of 64 (D for q and K, KB for Vᵀ).
  static constexpr int LBO = 128;
  static constexpr int SBO = 16 * 128;
};

// Float offset of element (row, col) in an operand tile: rows along M/N,
// columns along K.
__device__ __forceinline__ int core_offset(int row, int col) {
  return (row / 8) * (Tc::SBO / 4) + (col / 4) * (Tc::LBO / 4) + (row % 8) * 4 + col % 4;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

// x split into hi and lo, each written as four floats at offset o of its tile.
__device__ __forceinline__ void store_split(float* hi, float* lo, int o, float4 x) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor for an operand tile starting at p.
__device__ __forceinline__ uint64_t desc(const float* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(Tc::LBO >> 4) << 16) |
         (static_cast<uint64_t>(Tc::SBO >> 4) << 32);
}

// d = a·b + (acc ? d : 0) over a 64 × 64 × 8 step, A (64 × 8) from each
// thread's four registers, B (8 × 64) from shared memory.
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                      int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// The same with A from shared memory.
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d = a·b + (acc ? d : 0) at fp32 accuracy: lo·hi + hi·lo + hi·hi.
template <typename A>
__device__ __forceinline__ void wgmma3(float (&d)[32], const A& ah, const A& al,
                                       const float* bh, const float* bl, int acc) {
  wgmma(d, al, desc(bh), acc);
  wgmma(d, ah, desc(bl), 1);
  wgmma(d, ah, desc(bh), 1);
}

// 2^x on the SFU; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving an accumulator across an asynchronous
// product.
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The generic-proxy writes to shared memory before it become visible to
// the products, which read through the async proxy.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__global__ void __launch_bounds__(Tc::THREADS, 1)
attention_fwd_tc(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H, int N, int M,
                 Strides st, float q_scale) {
  constexpr int D = Tc::D, KB = Tc::KB;
  extern __shared__ __align__(1024) float smem[];
  float* const ops = smem;                                  // stage s at ops + 4·OP·s
  float* const qs = smem + 4 * Tc::STAGES * Tc::OP;         // consumer c at qs + 2·QT·c
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + Tc::BARS);
  uint64_t* const empty = full + Tc::STAGES;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int n_tiles = (M + KB - 1) / KB;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Tc::STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(full + s)),
                   "r"(128));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(empty + s)),
                   "r"(128 * Tc::CONSUMERS));
    }
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: load tile it of K and V into registers (rows past M as
    // zeros), wait until its stage is free, split it into the stage's four
    // operand tiles. K (keys × D) is already K-major for S = Q Kᵀ. V is
    // written transposed (D × keys) for O = P V, its keys renumbered within
    // each group of 8 so that logical key u is key 2u and u + 4 is key
    // 2u + 1: the order in which the S accumulator holds them.
    const float* kbase = k + b * st.kb + h * st.kh;
    const float* vbase = v + b * st.vb + h * st.vh;
    const int r = tid % 8, c = tid / 8;      // K: key 8i + r, dimensions 4c..4c+3
    const int d = tid % D, x = tid / D;      // V: dimension d, keys 8i + x + 2u
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % Tc::STAGES;
      const int m0 = it * KB;
      float4 kx[KB / 8], vx[KB / 8];
#pragma unroll
      for (int i = 0; i < KB / 8; ++i) {
        const int key = m0 + 8 * i + r;
        kx[i] = key < M ? *reinterpret_cast<const float4*>(kbase + (long long)key * st.km + 4 * c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        float w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kv = m0 + 8 * i + x + 2 * u;
          w[u] = kv < M ? vbase[(long long)kv * st.vm + d] : 0.f;
        }
        vx[i] = make_float4(w[0], w[1], w[2], w[3]);
      }
      if (it >= Tc::STAGES) mbar_wait(empty + s, (it / Tc::STAGES - 1) & 1);
      float* op = ops + s * 4 * Tc::OP;
#pragma unroll
      for (int i = 0; i < KB / 8; ++i) {
        store_split(op, op + Tc::OP, core_offset(8 * i + r, 4 * c), kx[i]);
        store_split(op + 2 * Tc::OP, op + 3 * Tc::OP, core_offset(d, 8 * i + 4 * x), vx[i]);
      }
      fence_async();
      mbar_arrive(full + s);
    }
    return;
  }

  // Consumers: warpgroup c holds query rows 64c..64c+63 of the block; its
  // warp w rows 16w + g and 16w + g + 8.
  const int cw = wg - 1;
  const int lane = tid % 32;
  const int g = lane / 4;            // fragment row group
  const int t = lane % 4;            // thread in group
  const int row0 = blockIdx.x * Tc::QB + 64 * cw;
  const int r0 = row0 + (tid / 32) * 16 + g;
  float* const qhi = qs + 2 * Tc::QT * cw;
  float* const qlo = qhi + Tc::QT;
  {   // q·(1/√D), split, as this warpgroup's A operand tiles
    const float* qp = q + b * st.qb + h * st.qh;
    const int r = tid % 8, c = tid / 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = row0 + 8 * i + r;
      float4 x = n < N ? *reinterpret_cast<const float4*>(qp + (long long)n * st.qn + 4 * c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      x = make_float4(x.x * q_scale, x.y * q_scale, x.z * q_scale, x.w * q_scale);
      store_split(qhi, qlo, core_offset(8 * i + r, 4 * c), x);
    }
    fence_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  }

  // Accumulators: element 4i + e is row g + 8(e / 2), column 8i + 2t + e % 2.
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};   // rows g, g + 8
  float l_run[2] = {0.f, 0.f};           // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % Tc::STAGES;
    const float* op = ops + s * 4 * Tc::OP;
    mbar_wait(full + s, (it / Tc::STAGES) & 1);

    // S = (q·scale) Kᵀ: keys 8i + 2t, 8i + 2t + 1 in s[4i..4i+3].
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      wgmma3(sc, desc(qhi + 64 * kk), desc(qlo + 64 * kk), op + 64 * kk,
             op + Tc::OP + 64 * kk, kk > 0);
    wgmma_commit_wait();
    pin(sc);

    const int m0 = it * KB;
    if (m0 + KB > M) {
#pragma unroll
      for (int i = 0; i < KB / 8; ++i) {
        const int key = m0 + 8 * i + 2 * t;
        if (key >= M) sc[4 * i] = sc[4 * i + 2] = NEG_INF;
        if (key + 1 >= M) sc[4 * i + 1] = sc[4 * i + 3] = NEG_INF;
      }
    }

    // Online softmax over the tile, per row.
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int i = 0; i < KB / 8; ++i) {
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = ex2((m_run[r] - mx) * LOG2E);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < KB / 8; ++i) {
        sc[4 * i + 2 * r] = ex2((sc[4 * i + 2 * r] - mx) * LOG2E);
        sc[4 * i + 2 * r + 1] = ex2((sc[4 * i + 2 * r + 1] - mx) * LOG2E);
        psum += sc[4 * i + 2 * r] + sc[4 * i + 2 * r + 1];
      }
      l_run[r] = l_run[r] * corr[r] + psum;
      m_run[r] = mx;
    }

    // P as A fragments, key group i as one k-step in the renumbered order:
    // column t is key 8i + 2t, column t + 4 key 8i + 2t + 1.
    uint32_t ph[KB / 8][4], pl[KB / 8][4];
#pragma unroll
    for (int i = 0; i < KB / 8; ++i) {
      split(sc[4 * i], ph[i][0], pl[i][0]);
      split(sc[4 * i + 2], ph[i][1], pl[i][1]);
      split(sc[4 * i + 1], ph[i][2], pl[i][2]);
      split(sc[4 * i + 3], ph[i][3], pl[i][3]);
    }

    // P V of this tile, in its own accumulator: the tensor cores add with
    // truncation, which over hundreds of tiles would bias a running sum; the
    // tile's sum joins the running output in one rounded FMA.
    float pv[32];
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < KB / 8; ++i)
      wgmma3(pv, ph[i], pl[i], op + 2 * Tc::OP + 64 * i, op + 3 * Tc::OP + 64 * i, i > 0);
    wgmma_commit_wait();
    pin(pv);
    mbar_arrive(empty + s);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = fmaf(o[i], corr[(i / 2) % 2], pv[i]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int n = r0 + 8 * r;
    if (n >= N) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* op = out + b * st.ob + (long long)n * st.on + h * st.oh + 2 * t;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<float2*>(op + 8 * i) =
          make_float2(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    }
  }
}

cudaError_t launch_tc(const float* q, const float* k, const float* v, float* out, int B, int H,
                      int N, int M, const Strides& st, float q_scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, Tc::SMEM);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + Tc::QB - 1) / Tc::QB, B * H);
  attention_fwd_tc<<<grid, Tc::THREADS, Tc::SMEM, stream>>>(q, k, v, out, H, N, M, st, q_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// SIMT path, D ∈ {16, 32, 128}: fp32 FMAs on the CUDA cores.

constexpr int SIMT_THREADS = 128;
constexpr int SUB = 16;                          // keys scored together

template <int D>
struct Simt {
  static constexpr int DH = D <= 64 ? D : 64;    // dimensions one thread owns
  static constexpr int TPR = D / DH;             // threads per query row
  static constexpr int QB = SIMT_THREADS / TPR;  // query rows per block
  static constexpr int KB = D <= 64 ? 64 : 32;   // keys per shared-memory tile
  static_assert(DH % 4 == 0 && KB % SUB == 0, "tile shapes");
};

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
attention_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int H, int N,
                      int M, Strides st, float q_scale) {
  using C = Simt<D>;
  constexpr int DH = C::DH;
  constexpr int KB = C::KB;
  constexpr int D4 = D / 4;
  __shared__ __align__(16) float ks[KB * D];
  __shared__ __align__(16) float vs[KB * D];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int n = blockIdx.x * C::QB + tid / C::TPR;
  const int d0 = (tid % C::TPR) * DH;
  const bool live = n < N;

  float qr[DH];
  float acc[DH];
  {
    const float* qp = q + b * st.qb + (long long)(live ? n : 0) * st.qn + h * st.qh + d0;
#pragma unroll
    for (int i = 0; i < DH; i += 4) {
      float4 t = live ? *reinterpret_cast<const float4*>(qp + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[i] = t.x * q_scale;
      qr[i + 1] = t.y * q_scale;
      qr[i + 2] = t.z * q_scale;
      qr[i + 3] = t.w * q_scale;
      acc[i] = acc[i + 1] = acc[i + 2] = acc[i + 3] = 0.f;
    }
  }
  float m_run = NEG_INF;
  float l_run = 0.f;
  const float* kbase = k + b * st.kb + h * st.kh;
  const float* vbase = v + b * st.vb + h * st.vh;

  for (int m0 = 0; m0 < M; m0 += KB) {
    __syncthreads();   // the previous tile is no longer read
    for (int idx = tid; idx < KB * D4; idx += SIMT_THREADS) {
      const int j = idx / D4;
      const int c = (idx % D4) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (m0 + j < M) {
        kk = *reinterpret_cast<const float4*>(kbase + (long long)(m0 + j) * st.km + c);
        vv = *reinterpret_cast<const float4*>(vbase + (long long)(m0 + j) * st.vm + c);
      }
      *reinterpret_cast<float4*>(ks + j * D + c) = kk;
      *reinterpret_cast<float4*>(vs + j * D + c) = vv;
    }
    __syncthreads();
    const int kn = min(KB, M - m0);

    for (int j0 = 0; j0 < kn; j0 += SUB) {
      float s[SUB];
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int i = 0; i < DH; i += 4) {
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) {
          const float4 kk = *reinterpret_cast<const float4*>(ks + (j0 + jj) * D + d0 + i);
          s[jj] = fmaf(qr[i], kk.x, s[jj]);
          s[jj] = fmaf(qr[i + 1], kk.y, s[jj]);
          s[jj] = fmaf(qr[i + 2], kk.z, s[jj]);
          s[jj] = fmaf(qr[i + 3], kk.w, s[jj]);
        }
      }
      if (C::TPR > 1) {   // the row's partial dot products, summed over its threads
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], 1);
      }
      float m_new = m_run;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        if (j0 + jj >= kn) s[jj] = NEG_INF;
        m_new = fmaxf(m_new, s[jj]);
      }
      const float corr = exp2f((m_run - m_new) * LOG2E);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        s[jj] = exp2f((s[jj] - m_new) * LOG2E);
        psum += s[jj];
      }
      l_run = l_run * corr + psum;
      m_run = m_new;
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
#pragma unroll
        for (int i = 0; i < DH; i += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + (j0 + jj) * D + d0 + i);
          acc[i] = fmaf(s[jj], vv.x, acc[i]);
          acc[i + 1] = fmaf(s[jj], vv.y, acc[i + 1]);
          acc[i + 2] = fmaf(s[jj], vv.z, acc[i + 2]);
          acc[i + 3] = fmaf(s[jj], vv.w, acc[i + 3]);
        }
      }
    }
  }

  if (live) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    float* op = out + b * st.ob + (long long)n * st.on + h * st.oh + d0;
#pragma unroll
    for (int i = 0; i < DH; i += 4) {
      *reinterpret_cast<float4*>(op + i) =
          make_float4(acc[i] * inv, acc[i + 1] * inv, acc[i + 2] * inv, acc[i + 3] * inv);
    }
  }
}

template <int D>
cudaError_t launch_simt(const float* q, const float* k, const float* v, float* out, int B,
                        int H, int N, int M, const Strides& st, float q_scale,
                        cudaStream_t stream) {
  using C = Simt<D>;
  dim3 grid((N + C::QB - 1) / C::QB, B * H);
  attention_fwd_simt<D><<<grid, SIMT_THREADS, 0, stream>>>(q, k, v, out, H, N, M, st,
                                                              q_scale);
  return cudaGetLastError();
}

// 1/√D rounded to fp32 once, as the plain version's q * (1 / D ** 0.5).
float q_scale_for(int D) { return static_cast<float>(1.0 / sqrt(static_cast<double>(D))); }

}  // namespace

// strides: 12 element strides, (batch, token, head) for q, k, v and out in
// that order; the head dimension is contiguous in all four.
extern "C" int g4_attention_fwd(const float* q, const float* k, const float* v, float* out,
                                int B, int H, int N, int M, int D,
                                const long long* strides, cudaStream_t stream) {
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  if (N <= 0 || M <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float qs = q_scale_for(D);
  cudaError_t err;
  switch (D) {
    case 16: err = launch_simt<16>(q, k, v, out, B, H, N, M, st, qs, stream); break;
    case 32: err = launch_simt<32>(q, k, v, out, B, H, N, M, st, qs, stream); break;
    case 64: err = launch_tc(q, k, v, out, B, H, N, M, st, qs, stream); break;
    case 128: err = launch_simt<128>(q, k, v, out, B, H, N, M, st, qs, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
