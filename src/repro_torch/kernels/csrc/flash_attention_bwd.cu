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
// are written once, per KV head, with no partials in device memory, summed
// in fp32 and rounded once. Neither kernel needs atomics: each output
// element has exactly one owner block. Two versions of each: dq_kernel and
// dkv_kernel (fp32 inputs, fp32 FMAs on the CUDA cores) and dq_tc_kernel
// and dkv_tc_kernel (bf16 inputs, tensor cores; their note is below).
// Layout, masks and edges: see flash_attention.cuh.
#include "flash_attention.cuh"

namespace rtfa {

// dq_kernel (fp32): one block per (64-row q tile, head, batch). Thread
// (ty, tx) owns score rows 4*ty + i, columns tx + 16*j, and dq dims
// tx + 16*j of its rows.
template <int HD>
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

  load_tile<HD>(Qs, a.q, b, h, q0, a.Sq);
  load_tile<HD>(dOs, a.dout, b, h, q0, a.Sq);
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
    load_tile<HD>(Ks, a.k, b, hk, k0, a.Sk);
    load_tile<HD>(Vs, a.v, b, hk, k0, a.Sk);
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
    for (int j = 0; j < ND; ++j)
      static_cast<float*>(a.dq.p)[base + tx + 16 * j] = acc[i][j];
  }
}

// dkv_kernel (fp32): one block per (64-row key tile, KV head, batch),
// looping over the G query heads of the group and every visible q tile.
// Thread (ty, tx) owns key rows 4*ty + i, query columns tx + 16*j, and
// dk/dv dims tx + 16*j of its rows.
template <int HD>
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

  load_tile<HD>(Ks, a.k, b, hk, k0, a.Sk);
  load_tile<HD>(Vs, a.v, b, hk, k0, a.Sk);
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
      load_tile<HD>(Qs, a.q, b, h, q0, a.Sq);
      load_tile<HD>(dOs, a.dout, b, h, q0, a.Sq);
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
      static_cast<float*>(a.dk.p)[bk + tx + 16 * j] = dk[i][j];
      static_cast<float*>(a.dv.p)[bv + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int HD>
cudaError_t dq(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sq + kB - 1) / kB, a.H, a.B);
  const size_t smem = (4 * kB * (HD + 1) + kB * (kB + 1)) * sizeof(float);
  return launch<dq_kernel<HD>>(grid, smem, a, st);
}

template <int HD>
cudaError_t dkv(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sk + kB - 1) / kB, a.KV, a.B);
  const size_t smem =
      (4 * kB * (HD + 1) + 2 * kB * (kB + 1) + 2 * kB) * sizeof(float);
  return launch<dkv_kernel<HD>>(grid, smem, a, st);
}

// The tensor-core backward (bf16). Both kernels recompute S and dP from
// bf16 tiles with mma.sync m16n8k16 (fp32 accumulators), form
// P = 2^(s * scale * log2 e - lse * log2 e) (ex2.approx, ~2^-22 relative;
// pairs the mask refuses are selected to 0, not given a -1e30 score and
// exponentiated: a query that sees no key has lse = -1e30, so such a score
// would give P = 1) and
// dS = P (dP - delta) scale in registers, and feed P and dS back to the
// tensor cores as A fragments packed from the accumulators, as the forward
// feeds P. P and dS are fp32; each is split into bf16 hi + lo (split_bf16)
// and both products go into one fp32 accumulator. Rounding either to one
// bf16 term breaks the card check (2e-4 + 2^-7 |ref|) in every mask kind
// (tests/test_torch_attention_bwd_tc.py emulates this arithmetic).
// Loads: cp.async 16-byte chunks into XOR-swizzled shared tiles (rows past
// the sequence end zero-filled), the streamed side through a 2-stage ring
// that prefetches the next visible tile while the current one computes, one
// barrier a tile. Tiles that tile_visible() refuses are never loaded;
// tiles that tile_full() admits skip the mask. A warp takes its 64-wide
// streamed tile as two 32-wide passes (a loop not unrolled), so the two
// score tiles of a pass take 32 registers, not 64, beside the fp32
// accumulators (64 at hd 64, 128 at hd 128 for dk/dv). That keeps the
// registers within 3 blocks an SM at hd 64 and 2 at hd 128 with no spills
// (the __launch_bounds__ minimum does not bind: builds without it take the
// same counts); 64-wide passes needed 212-218 registers at hd 64 (2 blocks
// an SM) and spilled at hd 128. tune_attention_bwd.py at the repository
// root builds and times these variants.
//
// What bounds them: at the DB step's db_concat case (B=8, H=32, S=2x512,
// hd 64) dk/dv must move 203.4 MB (0.0607 ms at 3.35 TB/s) and dq 169.9 MB
// (0.0507 ms) against 34.4 / 25.8 GFLOP over the kept pairs (0.035 / 0.026
// ms at 989 TFLOP/s): bound by bytes, within 2x of the operations, and the
// visible tiles hold more products than the kept pairs (partly masked
// tiles are computed whole; the splits add half again to dk/dv's products
// and a third to dq's). So the products run
// on the tensor cores and each tile is read from device memory about once
// per block (neighbouring blocks of one head share it through L2).

// A pass's two score products for one warp: s = A1 B1^T and dp = A2 B2^T
// over HD, for the warp's 16 rows arow0 .. + 15 of the A tiles against the
// NJ n8 tiles of rows brow0 .. + 8 NJ - 1 of the B tiles (all swizzled
// shared tiles). dkv_tc_kernel passes (K, V; Q, dO) for S^T and dP^T,
// dq_tc_kernel (Q, dO; K, V) for S and dP.
template <int HD, int NJ>
__device__ __forceinline__ void two_products(
    float (&s)[NJ][4], float (&dp)[NJ][4], const __nv_bfloat16* A1,
    const __nv_bfloat16* A2, int arow0, const __nv_bfloat16* B1,
    const __nv_bfloat16* B2, int brow0, int lane) {
  constexpr int CH = HD / 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a1[4], a2[4];  // A fragments: the warp's 16 rows
    const int arow = arow0 + (lane & 15), achunk = 2 * kk + lane / 16;
    rtmma::ldmatrix_x4(a1, rtmma::smem_addr(A1 + rtmma::swizzle<CH>(
        arow, achunk)));
    rtmma::ldmatrix_x4(a2, rtmma::smem_addr(A2 + rtmma::swizzle<CH>(
        arow, achunk)));
#pragma unroll
    for (int np = 0; np < NJ / 2; ++np) {
      uint32_t b1[4], b2[4];  // B fragments of n8 tiles 2np, 2np + 1
      const int brow = brow0 + 16 * np + (lane & 7) + (lane / 16) * 8;
      const int bchunk = 2 * kk + (lane / 8) % 2;
      rtmma::ldmatrix_x4(b1, rtmma::smem_addr(B1 + rtmma::swizzle<CH>(
          brow, bchunk)));
      rtmma::ldmatrix_x4(b2, rtmma::smem_addr(B2 + rtmma::swizzle<CH>(
          brow, bchunk)));
      rtmma::mma_bf16(s[2 * np], a1, b1[0], b1[1]);
      rtmma::mma_bf16(s[2 * np + 1], a1, b1[2], b1[3]);
      rtmma::mma_bf16(dp[2 * np], a2, b2[0], b2[1]);
      rtmma::mma_bf16(dp[2 * np + 1], a2, b2[2], b2[3]);
    }
  }
}

// dkv_tc_kernel: replaces _bwd_dkv_kernel
// (src/repro/kernels/flash_attention.py:228). One block of 4 warps per
// (64-key tile, KV head, batch); warp w owns keys k0 + 16w .. + 15 and
// their dk, dv rows in fp32 registers, written once, per KV head, after
// the loop over the G query heads of the group and every visible 64-query
// tile: no atomics, no per-head partials. The transposed orientation keeps
// every fragment in registers:
//   S^T = K Q^T and dP^T = V dO^T (K and V rows are A fragments by
//   ldmatrix; Q and dO rows are B fragments, loaded as the forward loads
//   K), then dV += P^T dO and dK += dS^T Q (P^T and dS^T packed from the
//   accumulators as A fragments; dO and Q as B by ldmatrix.trans, as the
//   forward reads V). The mask comes from the key side (key_queries: two
//   query intervals a key, computed once, since a block's keys are fixed).
// K and V are loaded once; Q, dO and the tile's 64 lse and delta values
// (fp32, by 4-byte cp.async, indices clamped to Sq - 1) go through the
// ring. Shared memory: K, V + 2 x (Q, dO) tiles + 2 x 2 x 64 floats,
// 49 KB at hd 64 and 97 KB at hd 128.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, HD == 64 ? 3 : 2)
    dkv_tc_kernel(const FlashArgs a) {
  constexpr int CH = HD / 8;               // 16-byte chunks of a row
  constexpr int ND = HD / 8;               // n8 tiles of dk, dv
  constexpr int QP = 32;                   // queries a pass
  constexpr int NJ = QP / 8;               // n8 tiles of a pass's S^T
  constexpr int TILE = kB * HD;
  static_assert(kTcThreads == 2 * kB, "one lse or delta value a thread");
  extern __shared__ uint4 tc_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* Vs = Ks + TILE;
  __nv_bfloat16* Qs = Vs + TILE;           // 2 stages
  __nv_bfloat16* dOs = Qs + 2 * TILE;      // 2 stages
  float* rows = reinterpret_cast<float*>(dOs + 2 * TILE);
  // rows + stage * 2kB: the tile's lse (kB floats), then its delta (kB)

  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int key0 = k0 + warp * 16 + lane / 4;  // and key0 + 8
  int lo1[2], hi1[2], lo2[2], hi2[2];  // the queries each key is kept by
  key_queries(a, key0, lo1[0], hi1[0], lo2[0], hi2[0]);
  key_queries(a, key0 + 8, lo1[1], hi1[1], lo2[1], hi2[1]);

  // Start the copies of query tile q0 of head h into stage st.
  auto load_queries = [&](int st, int h, int q0) {
    load_tile_async<HD>(Qs + st * TILE, a.q, b, h, q0, a.Sq);
    load_tile_async<HD>(dOs + st * TILE, a.dout, b, h, q0, a.Sq);
    const int i = threadIdx.x % kB;
    const long long r =
        ((long long)b * a.H + h) * a.Sq + min(q0 + i, a.Sq - 1);
    rtmma::cp_async_4(rtmma::smem_addr(rows + st * 2 * kB + threadIdx.x),
                      threadIdx.x < kB ? a.lse + r : a.delta + r);
  };

  // (g, q0): the query head of the group and the query tile; every head
  // sees the same tiles, the first of which is q_first
  int q_first = 0;
  while (q_first < a.Sq && !tile_visible(a, q_first, k0)) q_first += kB;
  int g = q_first < a.Sq ? 0 : G, q0 = q_first;
  if (g < G) {  // else no query sees these keys: dk = dv = 0
    load_tile_async<HD>(Ks, a.k, b, hk, k0, a.Sk);
    load_tile_async<HD>(Vs, a.v, b, hk, k0, a.Sk);
    load_queries(0, hk * G, q0);
  }
  rtmma::cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  const float scale2 = a.scale * kLog2e;

  for (int stage = 0; g < G; stage ^= 1) {
    rtmma::cp_async_wait<0>();
    // this stage (and K, V) is in shared memory for every thread, and every
    // warp is done with the other stage: prefetch the next pair into it
    __syncthreads();
    int gn = g, qn = q0 + kB;
    while (qn < a.Sq && !tile_visible(a, qn, k0)) qn += kB;
    if (qn >= a.Sq) {
      ++gn;
      qn = q_first;
    }
    if (gn < G) load_queries(stage ^ 1, hk * G + gn, qn);
    rtmma::cp_async_commit();
    const __nv_bfloat16* Qt = Qs + stage * TILE;
    const __nv_bfloat16* dOt = dOs + stage * TILE;
    const float* lse = rows + stage * 2 * kB;
    const float* delta = lse + kB;
    const bool full = tile_full(a, q0, k0);

#pragma unroll 1
    for (int qb = 0; qb < kB; qb += QP) {
      // S^T, dP^T: n8 tile j holds queries q0 + qb + 8j .. + 7
      float s[NJ][4], dp[NJ][4];
      two_products<HD>(s, dp, Ks, Vs, warp * 16, Qt, dOt, qb, lane);

      // element e of s[j]: key key0 + 8 (e / 2), query column
      // c = qb + 8j + 2t + e % 2 of the tile; s becomes P^T, dp dS^T
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = qb + 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse + c);
        const float2 d2 = *reinterpret_cast<const float2*>(delta + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2, qp = q0 + c + e % 2;
          const float l = e % 2 ? l2.y : l2.x, dl = e % 2 ? d2.y : d2.x;
          float p = rtmma::exp2_approx(s[j][e] * scale2 - l * kLog2e);
          if (!full && !((qp >= lo1[i] && qp < hi1[i]) ||
                         (qp >= lo2[i] && qp < hi2[i])))
            p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl) * a.scale;
        }
      }

      // dV += P^T dO, dK += dS^T Q over the pass's k16 steps of queries
#pragma unroll
      for (int kk = 0; kk < QP / 16; ++kk) {
        uint32_t phi[4], plo[4], shi[4], slo[4];
        rtmma::split_a_frag(s[2 * kk], s[2 * kk + 1], phi, plo);
        rtmma::split_a_frag(dp[2 * kk], dp[2 * kk + 1], shi, slo);
#pragma unroll
        for (int dd = 0; dd < ND / 2; ++dd) {
          uint32_t of[4], qf[4];  // B fragments of n8 tiles 2dd, 2dd + 1
          const int row = qb + 16 * kk + (lane & 15);
          const int chunk = 2 * dd + lane / 16;
          rtmma::ldmatrix_x4_trans(of, rtmma::smem_addr(
              dOt + rtmma::swizzle<CH>(row, chunk)));
          rtmma::ldmatrix_x4_trans(qf, rtmma::smem_addr(
              Qt + rtmma::swizzle<CH>(row, chunk)));
          rtmma::mma_bf16_split(dv[2 * dd], dv[2 * dd + 1], phi, plo, of);
          rtmma::mma_bf16_split(dk[2 * dd], dk[2 * dd + 1], shi, slo, qf);
        }
      }
    }
    g = gn;
    q0 = qn;
  }

  // element e of dk[d]: key key0 + 8 (e / 2), dim 8d + 2t + e % 2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = key0 + 8 * i;
    if (kp >= a.Sk) continue;
    __nv_bfloat16* krow = static_cast<__nv_bfloat16*>(a.dk.p) +
                          (long long)b * a.dk.sb + (long long)hk * a.dk.sh +
                          (long long)kp * a.dk.ss + 2 * t;
    __nv_bfloat16* vrow = static_cast<__nv_bfloat16*>(a.dv.p) +
                          (long long)b * a.dv.sb + (long long)hk * a.dv.sh +
                          (long long)kp * a.dv.ss + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<uint32_t*>(krow + 8 * d) =
          rtmma::pack_bf16(dk[d][2 * i], dk[d][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(vrow + 8 * d) =
          rtmma::pack_bf16(dv[d][2 * i], dv[d][2 * i + 1]);
    }
  }
}

// dq_tc_kernel: replaces _bwd_dq_kernel
// (src/repro/kernels/flash_attention.py:195). The forward's shape: one
// block of 4 warps per (64-query tile, head, batch), warp w owning queries
// q0 + 16w .. + 15, their lse and delta in registers and their dq rows in
// fp32 registers, written once after the loop over the visible key tiles.
//   S = Q K^T and dP = dO V^T (Q and dO rows are A fragments, K and V rows
//   B fragments, as in fwd_tc_kernel), masked through row_keys(); then
//   dQ += dS K (dS packed from the accumulators as the A fragment, K as B
//   by ldmatrix.trans, as the forward reads V).
// Q and dO are loaded once; K and V go through the ring, as in the
// forward. Shared memory: Q, dO + 2 x (K, V) tiles, 48 KB at hd 64 and
// 96 KB at hd 128.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, HD == 64 ? 3 : 2)
    dq_tc_kernel(const FlashArgs a) {
  constexpr int CH = HD / 8;               // 16-byte chunks of a row
  constexpr int ND = HD / 8;               // n8 tiles of dq
  constexpr int KP = 32;                   // keys a pass
  constexpr int NJ = KP / 8;               // n8 tiles of a pass's S
  constexpr int TILE = kB * HD;
  extern __shared__ uint4 tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* dOs = Qs + TILE;
  __nv_bfloat16* Ks = dOs + TILE;          // 2 stages
  __nv_bfloat16* Vs = Ks + 2 * TILE;       // 2 stages

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row0 = q0 + warp * 16 + lane / 4;  // and row0 + 8
  int klo[2], khi[2], kx[2];  // the keys each row keeps (row_keys)
  row_keys(a, row0, klo[0], khi[0], kx[0]);
  row_keys(a, row0 + 8, klo[1], khi[1], kx[1]);
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long r = ((long long)b * a.H + h) * a.Sq +
                        min(row0 + 8 * i, a.Sq - 1);
    lse2[i] = a.lse[r] * kLog2e;
    delta[i] = a.delta[r];
  }

  int k0 = next_visible(a, q0, 0);
  if (k0 < a.Sk) {  // else the rows see no key: dq = 0
    load_tile_async<HD>(Qs, a.q, b, h, q0, a.Sq);
    load_tile_async<HD>(dOs, a.dout, b, h, q0, a.Sq);
    load_tile_async<HD>(Ks, a.k, b, hk, k0, a.Sk);
    load_tile_async<HD>(Vs, a.v, b, hk, k0, a.Sk);
  }
  rtmma::cp_async_commit();

  float dq[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
  const float scale2 = a.scale * kLog2e;

  for (int stage = 0; k0 < a.Sk; stage ^= 1) {
    rtmma::cp_async_wait<0>();
    __syncthreads();
    const int kn = next_visible(a, q0, k0 + kB);
    if (kn < a.Sk) {
      load_tile_async<HD>(Ks + (stage ^ 1) * TILE, a.k, b, hk, kn, a.Sk);
      load_tile_async<HD>(Vs + (stage ^ 1) * TILE, a.v, b, hk, kn, a.Sk);
    }
    rtmma::cp_async_commit();
    const __nv_bfloat16* Kt = Ks + stage * TILE;
    const __nv_bfloat16* Vt = Vs + stage * TILE;
    const bool full = tile_full(a, q0, k0);

#pragma unroll 1
    for (int kb = 0; kb < kB; kb += KP) {
      // S, dP: n8 tile j holds keys k0 + kb + 8j .. + 7
      float s[NJ][4], dp[NJ][4];
      two_products<HD>(s, dp, Qs, dOs, warp * 16, Kt, Vt, kb, lane);

      // element e of s[j]: row row0 + 8 (e / 2), key k0 + kb + 8j + 2t +
      // e % 2; dp becomes dS
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2, kp = k0 + kb + 8 * j + 2 * t + e % 2;
          float p = rtmma::exp2_approx(s[j][e] * scale2 - lse2[i]);
          if (!full && !((kp >= klo[i] && kp < khi[i]) || kp == kx[i]))
            p = 0.f;
          dp[j][e] = p * (dp[j][e] - delta[i]) * a.scale;
        }

      // dQ += dS K over the pass's k16 steps of keys
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) {
        uint32_t hi[4], lo[4];
        rtmma::split_a_frag(dp[2 * kk], dp[2 * kk + 1], hi, lo);
#pragma unroll
        for (int dd = 0; dd < ND / 2; ++dd) {
          uint32_t kf[4];  // B fragments of n8 tiles 2dd, 2dd + 1
          rtmma::ldmatrix_x4_trans(kf, rtmma::smem_addr(
              Kt + rtmma::swizzle<CH>(kb + 16 * kk + (lane & 15),
                                      2 * dd + lane / 16)));
          rtmma::mma_bf16_split(dq[2 * dd], dq[2 * dd + 1], hi, lo, kf);
        }
      }
    }
    k0 = kn;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + 8 * i;
    if (qp >= a.Sq) continue;
    __nv_bfloat16* qrow = static_cast<__nv_bfloat16*>(a.dq.p) +
                          (long long)b * a.dq.sb + (long long)h * a.dq.sh +
                          (long long)qp * a.dq.ss + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<uint32_t*>(qrow + 8 * d) =
          rtmma::pack_bf16(dq[d][2 * i], dq[d][2 * i + 1]);
  }
}

template <int HD>
cudaError_t dkv_tc(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sk + kB - 1) / kB, a.KV, a.B);
  const size_t smem = 6 * kB * HD * sizeof(__nv_bfloat16) +
                      4 * kB * sizeof(float);
  return launch<dkv_tc_kernel<HD>, kTcThreads>(grid, smem, a, st);
}

template <int HD>
cudaError_t dq_tc(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sq + kB - 1) / kB, a.H, a.B);
  const size_t smem = 6 * kB * HD * sizeof(__nv_bfloat16);
  return launch<dq_tc_kernel<HD>, kTcThreads>(grid, smem, a, st);
}

}  // namespace rtfa

// Writes a->dq from q, k, v, dout, lse, delta. hd must be 64 or 128.
extern "C" int rt_flash_attention_bwd_dq(const rtfa::FlashArgs* a,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (a->hd * 2 + a->bf16) {
    case 128: e = rtfa::dq<64>(*a, st); break;
    case 129: e = rtfa::dq_tc<64>(*a, st); break;
    case 256: e = rtfa::dq<128>(*a, st); break;
    case 257: e = rtfa::dq_tc<128>(*a, st); break;
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
    case 128: e = rtfa::dkv<64>(*a, st); break;
    case 129: e = rtfa::dkv_tc<64>(*a, st); break;
    case 256: e = rtfa::dkv<128>(*a, st); break;
    case 257: e = rtfa::dkv_tc<128>(*a, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
