// Flash attention forward for sm_90a: online-softmax attention with fp32
// accumulation, writing out (in q's dtype) and the per-row logsumexp.
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:101
// (_fwd_kernel, called through _fwd_impl at :141). Layout, bounds and
// design: see flash_attention.cuh.
//
// One block per (64-row q tile, head, batch); GQA head h reads KV head
// h / (H / KV). Thread (ty, tx) owns score rows 4*ty + i and columns
// tx + 16*j of each 64 x 64 tile, and output dims tx + 16*j of its rows.
#include "flash_attention.cuh"

namespace rtfa {

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const FlashArgs a) {
  constexpr int LD = HD + 1;
  constexpr int ND = HD / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // kB x LD
  float* Ks = Qs + kB * LD;     // kB x LD
  float* Vs = Ks + kB * LD;     // kB x LD
  float* Ps = Vs + kB * LD;     // kB x (kB + 1)

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, HD>(Qs, a.q, b, h, q0, a.Sq);

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < a.Sk; k0 += kB) {
    if (!tile_visible(a, q0, k0)) continue;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    load_tile<T, HD>(Ks, a.k, b, hk, k0, a.Sk);
    load_tile<T, HD>(Vs, a.v, b, hk, k0, a.Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = keep(a, qp, k0 + tx + 16 * j);
        s[i][j] = ok[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row16_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(4 * ty + i) * (kB + 1) + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kB; ++kk) {
      float vv[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) vv[j] = Vs[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(4 * ty + i) * (kB + 1) + kk];
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= a.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const long long base = (long long)b * a.o.sb + (long long)h * a.o.sh +
                           (long long)qp * a.o.ss;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      st<T>(a.o.p, base + tx + 16 * j, acc[i][j] / lc);
    if (tx == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + qp] = m[i] + logf(lc);
  }
}

template <typename T, int HD>
cudaError_t fwd(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sq + kB - 1) / kB, a.H, a.B);
  const size_t smem = (3 * kB * (HD + 1) + kB * (kB + 1)) * sizeof(float);
  return launch<fwd_kernel<T, HD>>(grid, smem, a, st);
}

}  // namespace rtfa

// Writes a->o and a->lse from a->q, a->k, a->v. hd must be 64 or 128.
extern "C" int rt_flash_attention_fwd(const rtfa::FlashArgs* a, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (a->hd * 2 + a->bf16) {
    case 128: e = rtfa::fwd<float, 64>(*a, st); break;
    case 129: e = rtfa::fwd<__nv_bfloat16, 64>(*a, st); break;
    case 256: e = rtfa::fwd<float, 128>(*a, st); break;
    case 257: e = rtfa::fwd<__nv_bfloat16, 128>(*a, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
