// Flash attention backward for sm_90a: two kernels that recompute the score
// tiles from (q, k) and the stored logsumexp, so the (Sq, Sk) probability
// matrix never exists in device memory. With P = exp(s * scale - lse) where
// the mask keeps the pair and dS = P * (dO.V^T - delta) * scale,
//   dq_kernel:  dq = sum over key tiles of dS . K
//               (replaces src/repro/kernels/flash_attention.py:195,
//                _bwd_dq_kernel);
//   dkv_kernel: dk = sum over query tiles of dS^T . Q, dv = sum of P^T . dO
//               (replaces :228, _bwd_dkv_kernel).
// delta = rowsum(dO * O) comes in precomputed (one torch reduction, as the
// TPU path computes it with a jnp op outside its kernels, :281).
//
// The TPU kernel writes dk/dv per query head, (B, H, Sk, hd), and sums each
// GQA group afterwards (:323-325). Here one dkv block owns one (KV head, key
// tile) and loops over the G query heads of its group itself, so dk and dv
// are written once, per KV head, with no partials in device memory. Neither
// kernel needs atomics: each output element has exactly one owner block.
// Layout, bounds and design: see flash_attention.cuh.
#include "flash_attention.cuh"

namespace rtfa {

// One block per (64-row q tile, head, batch). Thread (ty, tx) owns score
// rows 4*ty + i, columns tx + 16*j, and dq dims tx + 16*j of its rows.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dq_kernel(const FlashArgs a) {
  constexpr int LD = HD + 1;
  constexpr int ND = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // kB x LD
  float* dOs = Qs + kB * LD;     // kB x LD
  float* Ks = dOs + kB * LD;     // kB x LD
  float* Vs = Ks + kB * LD;      // kB x LD
  float* dSs = Vs + kB * LD;     // kB x (kB + 1)

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, HD>(Qs, a.q, b, h, q0, a.Sq);
  load_tile<T, HD>(dOs, a.dout, b, h, q0, a.Sq);
  float lse[4], delta[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = min(q0 + 4 * ty + i, a.Sq - 1);
    const long long r = ((long long)b * a.H + h) * a.Sq + qp;
    lse[i] = a.lse[r];
    delta[i] = a.delta[r];
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < a.Sk; k0 += kB) {
    if (!tile_visible(a, q0, k0)) continue;
    __syncthreads();
    load_tile<T, HD>(Ks, a.k, b, hk, k0, a.Sk);
    load_tile<T, HD>(Vs, a.v, b, hk, k0, a.Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(4 * ty + i) * LD + d];
        ov[i] = dOs[(4 * ty + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep(a, qp, k0 + tx + 16 * j)
                            ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        dSs[(4 * ty + i) * (kB + 1) + tx + 16 * j] =
            p * (dp[i][j] - delta[i]) * a.scale;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kB; ++kk) {
      float kv[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) kv[j] = Ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(4 * ty + i) * (kB + 1) + kk];
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= a.Sq) continue;
    const long long base = (long long)b * a.dq.sb + (long long)h * a.dq.sh +
                           (long long)qp * a.dq.ss;
#pragma unroll
    for (int j = 0; j < ND; ++j) st<T>(a.dq.p, base + tx + 16 * j, acc[i][j]);
  }
}

// One block per (64-row key tile, KV head, batch), looping over the G query
// heads of the group and every visible q tile. Thread (ty, tx) owns key rows
// 4*ty + i, query columns tx + 16*j, and dk/dv dims tx + 16*j of its rows.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const FlashArgs a) {
  constexpr int LD = HD + 1;
  constexpr int ND = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // kB x LD
  float* Vs = Ks + kB * LD;      // kB x LD
  float* Qs = Vs + kB * LD;      // kB x LD
  float* dOs = Qs + kB * LD;     // kB x LD
  float* Ps = dOs + kB * LD;     // kB (keys) x (kB + 1) (queries)
  float* dSs = Ps + kB * (kB + 1);
  float* lse_s = dSs + kB * (kB + 1);  // kB
  float* delta_s = lse_s + kB;         // kB

  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.KV;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, HD>(Ks, a.k, b, hk, k0, a.Sk);
  load_tile<T, HD>(Vs, a.v, b, hk, k0, a.Sk);
  float dk[4][ND], dv[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = 0; q0 < a.Sq; q0 += kB) {
      if (!tile_visible(a, q0, k0)) continue;
      __syncthreads();
      load_tile<T, HD>(Qs, a.q, b, h, q0, a.Sq);
      load_tile<T, HD>(dOs, a.dout, b, h, q0, a.Sq);
      if (threadIdx.x < kB) {
        const int qp = min(q0 + (int)threadIdx.x, a.Sq - 1);
        const long long r = ((long long)b * a.H + h) * a.Sq + qp;
        lse_s[threadIdx.x] = a.lse[r];
        delta_s[threadIdx.x] = a.delta[r];
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(4 * ty + i) * LD + d];
          vv[i] = Vs[(4 * ty + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * LD + d];
          ov[j] = dOs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const float p = keep(a, q0 + qc, kp)
                              ? expf(s[i][j] * a.scale - lse_s[qc]) : 0.f;
          Ps[(4 * ty + i) * (kB + 1) + qc] = p;
          dSs[(4 * ty + i) * (kB + 1) + qc] =
              p * (dp[i][j] - delta_s[qc]) * a.scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < kB; ++qq) {
        float qv[ND], ov[ND];
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          qv[j] = Qs[qq * LD + tx + 16 * j];
          ov[j] = dOs[qq * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(4 * ty + i) * (kB + 1) + qq];
          const float ds = dSs[(4 * ty + i) * (kB + 1) + qq];
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            dv[i][j] = fmaf(p, ov[j], dv[i][j]);
            dk[i][j] = fmaf(ds, qv[j], dk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + 4 * ty + i;
    if (kp >= a.Sk) continue;
    const long long bk = (long long)b * a.dk.sb + (long long)hk * a.dk.sh +
                         (long long)kp * a.dk.ss;
    const long long bv = (long long)b * a.dv.sb + (long long)hk * a.dv.sh +
                         (long long)kp * a.dv.ss;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      st<T>(a.dk.p, bk + tx + 16 * j, dk[i][j]);
      st<T>(a.dv.p, bv + tx + 16 * j, dv[i][j]);
    }
  }
}

template <typename T, int HD>
cudaError_t dq(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sq + kB - 1) / kB, a.H, a.B);
  const size_t smem = (4 * kB * (HD + 1) + kB * (kB + 1)) * sizeof(float);
  return launch<dq_kernel<T, HD>>(grid, smem, a, st);
}

template <typename T, int HD>
cudaError_t dkv(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sk + kB - 1) / kB, a.KV, a.B);
  const size_t smem =
      (4 * kB * (HD + 1) + 2 * kB * (kB + 1) + 2 * kB) * sizeof(float);
  return launch<dkv_kernel<T, HD>>(grid, smem, a, st);
}

}  // namespace rtfa

// Writes a->dq from q, k, v, dout, lse, delta. hd must be 64 or 128.
extern "C" int rt_flash_attention_bwd_dq(const rtfa::FlashArgs* a,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (a->hd * 2 + a->bf16) {
    case 128: e = rtfa::dq<float, 64>(*a, st); break;
    case 129: e = rtfa::dq<__nv_bfloat16, 64>(*a, st); break;
    case 256: e = rtfa::dq<float, 128>(*a, st); break;
    case 257: e = rtfa::dq<__nv_bfloat16, 128>(*a, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Writes a->dk and a->dv (per KV head) from q, k, v, dout, lse, delta.
extern "C" int rt_flash_attention_bwd_dkv(const rtfa::FlashArgs* a,
                                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (a->hd * 2 + a->bf16) {
    case 128: e = rtfa::dkv<float, 64>(*a, st); break;
    case 129: e = rtfa::dkv<__nv_bfloat16, 64>(*a, st); break;
    case 256: e = rtfa::dkv<float, 128>(*a, st); break;
    case 257: e = rtfa::dkv<__nv_bfloat16, 128>(*a, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
