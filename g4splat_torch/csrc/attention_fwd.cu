// Kernel B3: exact non-causal attention forward, softmax(Q Kᵀ / √D) V, in
// fp32, for (B, N, H, D) queries against (B, M, H, D) keys and values.
//
// Replaces g4splat_tpu/ops/attention.py::_tpu_flash (the flash-attention
// Pallas kernel that ships with JAX), the attention of the See3D MV-UNet.
//
// What bounds it on an H100: 4·B·H·N·M·D fp32 operations against
// 4·(2·B·N·H·D + 2·B·M·H·D) bytes. At the See3D self-attention shape
// (B=2, H=5, D=64, N=M=36864) that is 3.5e12 operations against 75 MB, so
// the arithmetic binds (~52 ms at 67 TFLOP/s, 0.02 ms of HBM traffic).
//
// Design (simple and exact first; tensor cores, TMA and bf16 are later
// work): one block of 128 threads per (batch·head, block of queries). Each
// query row is owned by D/DH threads (DH = min(D, 64) dimensions each), which
// keep the row's scaled q, its D-wide accumulator, its running max and its
// running sum in registers. Keys and values are staged through shared memory
// in tiles of KB rows (32 KB at D = 64 and D = 128) and read as broadcasts;
// each thread scores SUB keys at a time, so SUB independent FMA chains hide
// the pipeline latency, then folds them into the online softmax with one
// rescale of the accumulator. q carries 1/√D as the plain version's does, and
// each probability is exp2((s − m)·log2 e): the difference is taken before
// the change of base, so near-tied scores (where fp32 rounding of the scores
// alone moves the softmax) round as in the plain version. The running max
// starts at a finite large negative (as the JAX `_NEG_INF`), so
// exp(m_old − m_new) never makes a NaN; keys past M are masked to it, queries
// past N are not written.
// q, k, v and out are read and written through their own strides (the
// innermost dimension must be contiguous and 16-byte aligned), so the
// wrapper makes no transposed copy.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int SUB = 16;                          // keys scored together
constexpr float NEG_INF = -0.7f * 3.402823466e+38f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int DH = D <= 64 ? D : 64;    // dimensions one thread owns
  static constexpr int TPR = D / DH;             // threads per query row
  static constexpr int QB = THREADS / TPR;       // query rows per block
  static constexpr int KB = D <= 64 ? 64 : 32;   // keys per shared-memory tile
  static_assert(DH % 4 == 0 && KB % SUB == 0, "tile shapes");
};

struct Strides {
  long long qb, qn, qh, kb, km, kh, vb, vm, vh, ob, on, oh;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int H,
                     int N, int M, Strides st, float q_scale) {
  using C = Cfg<D>;
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
    for (int idx = tid; idx < KB * D4; idx += THREADS) {
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
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int B,
                   int H, int N, int M, const Strides& st, cudaStream_t stream) {
  using C = Cfg<D>;
  // 1/√D rounded to fp32 once, as the plain version's q * (1 / D ** 0.5).
  const float q_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  dim3 grid((N + C::QB - 1) / C::QB, B * H);
  attention_fwd_kernel<D><<<grid, THREADS, 0, stream>>>(q, k, v, out, H, N, M, st, q_scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, token, head) for q, k, v and out in
// that order; the head dimension is contiguous in all four.
extern "C" int g4_attention_fwd(const float* q, const float* k, const float* v, float* out,
                                int B, int H, int N, int M, int D,
                                const long long* strides, cudaStream_t stream) {
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  if (N <= 0 || M <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(q, k, v, out, B, H, N, M, st, stream); break;
    case 32: err = launch<32>(q, k, v, out, B, H, N, M, st, stream); break;
    case 64: err = launch<64>(q, k, v, out, B, H, N, M, st, stream); break;
    case 128: err = launch<128>(q, k, v, out, B, H, N, M, st, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
