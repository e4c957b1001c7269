// Flash attention backward for sm_90a: two kernels that recompute the score
// tiles from (q, k) and the stored logsumexp, so the (Sq, Sk) probability
// matrix never exists in device memory. With P = exp(s * scale - lse) where
// the mask keeps the pair and dS = P * (dP - delta) * scale,
//   dq:   dq = sum over key tiles of dS . K
//         (replaces src/repro/kernels/flash_attention.py:195,
//          _bwd_dq_kernel);
//   dk/dv: dk = sum over query tiles of dS^T . Q, dv = sum of P^T . dO
//         (replaces :228, _bwd_dkv_kernel).
// delta = rowsum(dO * O) comes in precomputed (one torch reduction, as the
// TPU path computes it with a jnp op outside its kernels, :281).
//
// The TPU kernel writes dk/dv per query head, (B, H, Sk, hd), and sums each
// GQA group afterwards (:323-325). Here one dk/dv block owns one (KV head,
// key tile) and loops over the G query heads of its group itself, so dk and
// dv are written once, per KV head, with no partials in device memory,
// summed in fp32 and rounded once. Neither kernel needs atomics: each output
// element has exactly one owner block. Two versions of each, both on the
// tensor cores: dq_tc_kernel and dkv_tc_kernel (bf16 inputs, mma.sync
// m16n8k16) and dq_tf32_kernel and dkv_tf32_kernel (fp32 inputs, mma.sync
// m16n8k8 on tf32 operands split three ways); their notes are below.
// Layout, masks and edges: see flash_attention.cuh.
#include "flash_attention.cuh"

namespace rtfa {

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
// over HT (a tile row's width), for the warp's 16 rows arow0 .. + 15 of
// the A tiles against the NJ n8 tiles of rows brow0 .. + 8 NJ - 1 of the B
// tiles (all swizzled shared tiles). dkv_tc_kernel passes (K, V; Q, dO)
// for S^T and dP^T, dq_tc_kernel (Q, dO; K, V) for S and dP.
template <int HT, int NJ>
__device__ __forceinline__ void two_products(
    float (&s)[NJ][4], float (&dp)[NJ][4], const __nv_bfloat16* A1,
    const __nv_bfloat16* A2, int arow0, const __nv_bfloat16* B1,
    const __nv_bfloat16* B2, int brow0, int lane) {
  constexpr int CH = HT / 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HT / 16; ++kk) {
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
// 49 KB at hd 64 and 97 KB at hd 128 (and at hd 120, padded to 128).
template <int HD>
__global__ void __launch_bounds__(kTcThreads, HD == 64 ? 3 : 2)
    dkv_tc_kernel(const FlashArgs a) {
  constexpr int HT = kTileDim<HD>;         // a tile row (hd 120: 128)
  constexpr int CH = HT / 8;               // 16-byte chunks of a tile row
  constexpr int ND = HT / 8;               // n8 tiles of dk, dv
  constexpr int QP = 32;                   // queries a pass
  constexpr int NJ = QP / 8;               // n8 tiles of a pass's S^T
  constexpr int TILE = kB * HT;
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
      two_products<HT>(s, dp, Ks, Vs, warp * 16, Qt, dOt, qb, lane);

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
      if (8 * d >= HD) continue;  // the padded dims
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
// 96 KB at hd 128 (and at hd 120, padded to 128).
template <int HD>
__global__ void __launch_bounds__(kTcThreads, HD == 64 ? 3 : 2)
    dq_tc_kernel(const FlashArgs a) {
  constexpr int HT = kTileDim<HD>;         // a tile row (hd 120: 128)
  constexpr int CH = HT / 8;               // 16-byte chunks of a tile row
  constexpr int ND = HT / 8;               // n8 tiles of dq
  constexpr int KP = 32;                   // keys a pass
  constexpr int NJ = KP / 8;               // n8 tiles of a pass's S
  constexpr int TILE = kB * HT;
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
      two_products<HT>(s, dp, Qs, dOs, warp * 16, Kt, Vt, kb, lane);

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
      if (8 * d < HD)  // not the padded dims
        *reinterpret_cast<uint32_t*>(qrow + 8 * d) =
            rtmma::pack_bf16(dq[d][2 * i], dq[d][2 * i + 1]);
  }
}

template <int HD>
cudaError_t dkv_tc(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sk + kB - 1) / kB, a.KV, a.B);
  const size_t smem = 6 * kB * kTileDim<HD> * sizeof(__nv_bfloat16) +
                      4 * kB * sizeof(float);
  return launch<dkv_tc_kernel<HD>, kTcThreads>(grid, smem, a, st);
}

template <int HD>
cudaError_t dq_tc(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sq + kB - 1) / kB, a.H, a.B);
  const size_t smem = 6 * kB * kTileDim<HD> * sizeof(__nv_bfloat16);
  return launch<dq_tc_kernel<HD>, kTcThreads>(grid, smem, a, st);
}

// The tensor-core backward (fp32: the DiT and recurrent-depth models, and
// the fp32 cross-checks of the AR paths). The shape of dkv_tc_kernel and
// dq_tc_kernel, with fwd_tf32_kernel's arithmetic: mma.sync m16n8k8 on tf32
// operands, every fp32 operand split into big + small (split_tf32) and each
// of the five products (S, dP, dV, dK, dQ) taken three times into one fp32
// accumulator (3xTF32). A plain tf32 product in any one of them puts the
// outputs it feeds past the card check's fp32 bound (2e-4 + 2e-4 |ref|) on
// inputs of scale 3 (the CPU emulation in
// tests/test_torch_attention_bwd_tf32.py), so all five are split.
//
// What bounds them: at the DiT-S/2 step's `full` case (B=256, H=6, S=256,
// hd 64) dq must do 38.7 GFLOP and dk/dv 51.5 GFLOP over the kept pairs;
// fp32-accurate on the tensor cores (three tf32 products each at 494.7
// TFLOP/s) that is 0.2344 / 0.3126 ms, above the time their bytes take at
// 3.35 TB/s: bound by operations, so the products go to the tensor cores.
//
// Fragments come from fp32 shared tiles by plain loads (ldmatrix moves b16
// only). A k-sum's order is free, so inside each 8-wide step k-index t
// stands for element 2t and t + 4 for 2t + 1; then a score accumulator tile
// (a thread's columns 2t, 2t + 1) is the A operand of the next product as it
// stands. The streamed tile (Q and dO in dk/dv, K in dq) is read two ways:
//   - as the B operand of a score product (S^T = K Q^T, dP^T = V dO^T; S =
//     Q K^T): row n of an n8 tile, dims 2t and 2t + 1, one float2;
//   - as the B operand of a gradient product (dV += P^T dO, dK += dS^T Q;
//     dQ += dS K): rows 2t and 2t + 1 (its k-indices), one dim a lane. Two
//     adjacent output tiles take dims 2g and 2g + 1 of a 16-dim slice, so
//     each row gives one float2 for both, and a thread ends with 4
//     consecutive dims of each output row (float4 stores).
// Rows are padded to HD + 8 floats. In a half-warp's float2 reads the first
// pattern hits every bank once; the second would hit rows 2t and 2t + 4
// (t = 0, 2) on the same banks. So n-index g of a score tile stands for row
// g ^ (g >> 2) of the 8 (rows 4-7 swapped in pairs): the second pattern
// then reads rows {0, 2, 5, 7} and {1, 3, 4, 6}, which fall on distinct
// banks too, and a thread's two score columns 2t, 2t + 1 are rows
// 2t + (e ^ (t >> 1)) (e = 0, 1): the pair swapped for t >= 2. Both hold
// for a pitch of 8 or 24 (mod 32): hd 32, 64 and 128 (and hd 120, whose
// tiles are hd 128's), and hd 112 (120).
// (tests/test_torch_attention_bwd_tf32.py checks the fragments against the
// PTX tables and counts the banks.)
// Flushes. The tensor cores add each mma's products into its fp32
// accumulator with truncation, not rounding to nearest, so a sum kept in the
// accumulators through every k8 step drifts toward zero as it grows: with
// dk and dv summed that way, keys that G * Sq = 4000 query rows see missed
// the fp32 bound on the card (tests/test_torch_gpu.py, causal S = 1000,
// G = 4: max |err| 1.4e-3), the error shrinking with the rows a key sees.
// So each pass's share of dq, dk and dv is summed from zero over the
// pass's k8 steps, output tile by tile, and added to the running sums by
// fp32 adds, which round to nearest (tune_attention_bwd.py prints the
// kernels' error against fp64 beside the plain versions').
// Loads: the fixed side (K, V in dk/dv; Q, dO in dq) once, the streamed
// side through a 2-stage cp.async ring that prefetches the next visible
// tile, one barrier a tile, as in the bf16 kernels. Shared memory: 6 tiles
// of 64 x (HD + 8) floats, 61 KB at hd 32 (3 blocks an SM), 108 KB at hd 64
// (2), 181 KB at hd 112 (1) and 204 KB at hd 128 and 120 (1). A warp takes
// its 64-row streamed tile in passes of kTf32Pass rows (a loop not
// unrolled).
// Copies are 16 bytes where q, k, v, dO and the outputs pass copies16(),
// else the same kernel is instantiated
// with 4-byte copies and scalar stores: every fp32 view with a contiguous
// head dim is taken.

template <int HD>
constexpr int kBwdPitch = kTileDim<HD> + 8;
// Rows of the streamed tile a warp takes in one pass (queries in dk/dv,
// keys in dq): the pass's two score tiles take kTf32Pass floats a thread
// beside the accumulators. tune_attention_bwd.py builds other widths: at hd
// 64 passes of 64 made dk/dv 12% slower (255 registers) and dq 4% faster;
// at hd 128 passes of 16 made dk/dv 11% slower and dq 3% faster. At hd 112
// passes of 16 made dq 5-6% faster with no spill (8 B at 32) and left
// dk/dv within 1% (its spills 24 B -> 12 B), so hd 112 takes 16.
template <int HD>
constexpr int kTf32Pass = HD == 112 ? 16 : 32;
// Blocks an SM that dq_tf32_kernel and dkv_tf32_kernel ask
// __launch_bounds__ for: as many as their shared memory allows (61 KB a
// block at hd 32, 108 KB at hd 64, 181 KB at hd 112, 204 KB at hd 128).
template <int HD>
constexpr int kTf32MinBlocks = HD == 32 ? 3 : HD == 64 ? 2 : 1;

// The row of an 8-row score tile that n-index g stands for.
__device__ __forceinline__ int score_row(int g) { return g ^ (g >> 2); }

// A pass's two score products for one warp: s = A1 B1^T and dp = A2 B2^T
// over HT (a tile row's width), for the warp's 16 rows of the A tiles (a1,
// a2 at row g, dim 2t) against the NJ n8 tiles of the B tiles (b1, b2 at
// the pass's first row): n8 tile j, n-index g is row 8j + score_row(g).
template <int HT, int NJ, int P>
__device__ __forceinline__ void score_products_tf32(
    float (&s)[NJ][4], float (&dp)[NJ][4], const float* a1, const float* a2,
    const float* b1, const float* b2, int g, int t) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  const int boff = score_row(g) * P + 2 * t;
#pragma unroll
  for (int kk = 0; kk < HT / 8; ++kk) {
    uint32_t ab1[4], as1[4], ab2[4], as2[4];
    q_frag_tf32<P>(a1 + 8 * kk, ab1, as1);
    q_frag_tf32<P>(a2 + 8 * kk, ab2, as2);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(
          b1 + 8 * j * P + boff + 8 * kk);
      const float2 y = *reinterpret_cast<const float2*>(
          b2 + 8 * j * P + boff + 8 * kk);
      uint32_t xb0, xs0, xb1, xs1, yb0, ys0, yb1, ys1;
      rtmma::split_tf32(x.x, xb0, xs0);
      rtmma::split_tf32(x.y, xb1, xs1);
      rtmma::split_tf32(y.x, yb0, ys0);
      rtmma::split_tf32(y.y, yb1, ys1);
      rtmma::mma_tf32x3(s[j], ab1, as1, xb0, xb1, xs0, xs1);
      rtmma::mma_tf32x3(dp[j], ab2, as2, yb0, yb1, ys0, ys1);
    }
  }
}

// A score accumulator tile as the split A fragment of a k8 step: column
// 2t is k-index t, column 2t + 1 is t + 4.
__device__ __forceinline__ void acc_frag_tf32(const float (&c)[4],
                                              uint32_t (&big)[4],
                                              uint32_t (&small)[4]) {
  rtmma::split_tf32(c[0], big[0], small[0]);  // (g, k t)
  rtmma::split_tf32(c[2], big[1], small[1]);  // (g + 8, k t)
  rtmma::split_tf32(c[1], big[2], small[2]);  // (g, k t + 4)
  rtmma::split_tf32(c[3], big[3], small[3]);  // (g + 8, k t + 4)
}

// d0 += A B0 and d1 += A B1 for the n8 output tiles of dims 16dd + 2g
// (d0) and 16dd + 2g + 1 (d1): r0 and r1 point at dim 16dd + 2g of the B
// rows of k-indices t and t + 4; one float2 from each, split.
__device__ __forceinline__ void gradient_products_tf32(
    float (&d0)[4], float (&d1)[4], const uint32_t (&ab)[4],
    const uint32_t (&as)[4], const float* r0, const float* r1) {
  const float2 x = *reinterpret_cast<const float2*>(r0);
  const float2 y = *reinterpret_cast<const float2*>(r1);
  uint32_t xb0, xs0, xb1, xs1, yb0, ys0, yb1, ys1;
  rtmma::split_tf32(x.x, xb0, xs0);
  rtmma::split_tf32(y.x, yb0, ys0);
  rtmma::split_tf32(x.y, xb1, xs1);
  rtmma::split_tf32(y.y, yb1, ys1);
  rtmma::mma_tf32x3(d0, ab, as, xb0, yb0, xs0, ys0);
  rtmma::mma_tf32x3(d1, ab, as, xb1, yb1, xs1, ys1);
}

// d += x, element by element (fp32 adds, rounded to nearest).
__device__ __forceinline__ void add_tile(float (&d)[4], const float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += x[e];
}

// Four consecutive floats of an output row.
template <bool V16>
__device__ __forceinline__ void store4(float* p, float x, float y, float z,
                                       float w) {
  if constexpr (V16) {
    *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
  } else {
    p[0] = x;
    p[1] = y;
    p[2] = z;
    p[3] = w;
  }
}

// Row i (row g + 8i of the warp's 16) of a thread's output accumulators,
// written at `row`: tiles 2dd and 2dd + 1 hold dims 16dd + 4t + {0, 2} and
// 16dd + 4t + {1, 3}; dims at or past HD (the padding) are not stored.
template <int HD, int ND, bool V16>
__device__ __forceinline__ void store_row(float* row, const float (&d)[ND][4],
                                          int i, int t) {
#pragma unroll
  for (int dd = 0; dd < ND / 2; ++dd)
    if (16 * dd + 4 * t < HD)
      store4<V16>(row + 16 * dd + 4 * t, d[2 * dd][2 * i],
                  d[2 * dd + 1][2 * i], d[2 * dd][2 * i + 1],
                  d[2 * dd + 1][2 * i + 1]);
}

// dkv_tf32_kernel: replaces _bwd_dkv_kernel
// (src/repro/kernels/flash_attention.py:228) for fp32. One block of 4
// warps per (64-key tile, KV head, batch); warp w owns keys k0 + 16w .. + 15
// and their dk, dv rows in fp32 registers, written once, per KV head, after
// the loop over the G query heads of the group and every visible 64-query
// tile. Transposed, as dkv_tc_kernel: S^T = K Q^T and dP^T = V dO^T (K, V
// the A operands, Q, dO the B), masked from the key side (key_queries),
// then dV += P^T dO and dK += dS^T Q. K and V are loaded once; Q, dO and
// the tile's 64 lse and delta values (4-byte cp.async, indices clamped to
// Sq - 1) go through the ring.
template <int HD, bool V16>
__global__ void __launch_bounds__(kTcThreads, kTf32MinBlocks<HD>)
    dkv_tf32_kernel(const FlashArgs a) {
  constexpr int P = kBwdPitch<HD>, TILE = kB * P;
  constexpr int HT = kTileDim<HD>;         // a tile row (hd 120: 128)
  constexpr int ND = HT / 8;               // n8 tiles of dk, dv
  constexpr int NQ = kTf32Pass<HD>;        // queries a pass
  constexpr int NJ = NQ / 8;               // n8 tiles of a pass's S^T
  static_assert(kTcThreads == 2 * kB, "one lse or delta value a thread");
  extern __shared__ float4 tf_smem[];
  float* Ks = reinterpret_cast<float*>(tf_smem);
  float* Vs = Ks + TILE;
  float* Qs = Vs + TILE;                   // 2 stages
  float* dOs = Qs + 2 * TILE;              // 2 stages
  float* rows = dOs + 2 * TILE;
  // rows + stage * 2kB: the tile's lse (kB floats), then its delta (kB)

  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, sw = t >> 1;
  const int key0 = k0 + warp * 16 + g;     // and key0 + 8
  int lo1[2], hi1[2], lo2[2], hi2[2];      // the queries each key is kept by
  key_queries(a, key0, lo1[0], hi1[0], lo2[0], hi2[0]);
  key_queries(a, key0 + 8, lo1[1], hi1[1], lo2[1], hi2[1]);

  // Start the copies of query tile q0 of head h into stage st.
  auto load_queries = [&](int st, int h, int q0) {
    load_tile_async<HD, P, V16>(Qs + st * TILE, a.q, b, h, q0, a.Sq);
    load_tile_async<HD, P, V16>(dOs + st * TILE, a.dout, b, h, q0, a.Sq);
    const int i = threadIdx.x % kB;
    const long long r =
        ((long long)b * a.H + h) * a.Sq + min(q0 + i, a.Sq - 1);
    rtmma::cp_async_4(rtmma::smem_addr(rows + st * 2 * kB + threadIdx.x),
                      threadIdx.x < kB ? a.lse + r : a.delta + r);
  };

  // (gh, q0): the query head of the group and the query tile; every head
  // sees the same tiles, the first of which is q_first
  int q_first = 0;
  while (q_first < a.Sq && !tile_visible(a, q_first, k0)) q_first += kB;
  int gh = q_first < a.Sq ? 0 : G, q0 = q_first;
  if (gh < G) {  // else no query sees these keys: dk = dv = 0
    load_tile_async<HD, P, V16>(Ks, a.k, b, hk, k0, a.Sk);
    load_tile_async<HD, P, V16>(Vs, a.v, b, hk, k0, a.Sk);
    load_queries(0, hk * G, q0);
  }
  rtmma::cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  const float scale2 = a.scale * kLog2e;
  const float* krow = Ks + (warp * 16 + g) * P + 2 * t;
  const float* vrow = Vs + (warp * 16 + g) * P + 2 * t;

  for (int stage = 0; gh < G; stage ^= 1) {
    rtmma::cp_async_wait<0>();
    // this stage (and K, V) is in shared memory for every thread, and every
    // warp is done with the other stage: prefetch the next pair into it
    __syncthreads();
    int gn = gh, qn = q0 + kB;
    while (qn < a.Sq && !tile_visible(a, qn, k0)) qn += kB;
    if (qn >= a.Sq) {
      ++gn;
      qn = q_first;
    }
    if (gn < G) load_queries(stage ^ 1, hk * G + gn, qn);
    rtmma::cp_async_commit();
    const float* Qt = Qs + stage * TILE;
    const float* dOt = dOs + stage * TILE;
    const float* lse = rows + stage * 2 * kB;
    const float* delta = lse + kB;
    const bool full = tile_full(a, q0, k0);

#pragma unroll 1
    for (int c0 = 0; c0 < kB; c0 += NQ) {
      // S^T, dP^T over the pass's queries c0 .. c0 + NQ - 1 of the tile
      float s[NJ][4], dp[NJ][4];
      score_products_tf32<HT, NJ, P>(s, dp, krow, vrow, Qt + c0 * P,
                                     dOt + c0 * P, g, t);

      // element e of s[j]: key key0 + 8 (e / 2), query c + (e % 2 ^ sw) of
      // the tile (c = c0 + 8j + 2t); s becomes P^T, dp dS^T
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse + c);
        const float2 d2 = *reinterpret_cast<const float2*>(delta + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2, o = (e & 1) ^ sw, qp = q0 + c + o;
          const float l = o ? l2.y : l2.x, dl = o ? d2.y : d2.x;
          float p = rtmma::exp2_approx(s[j][e] * scale2 - l * kLog2e);
          if (!full && !((qp >= lo1[i] && qp < hi1[i]) ||
                         (qp >= lo2[i] && qp < hi2[i])))
            p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl) * a.scale;
        }
      }

      // dV += P^T dO, dK += dS^T Q, the pass's share summed apart and then
      // added (flush note above): n8 tile j is a k8 step whose k-index t is
      // query row c0 + 8j + 2t + sw and t + 4 row c0 + 8j + 2t + 1 - sw
#pragma unroll
      for (int dd = 0; dd < ND / 2; ++dd) {
        float v0[4] = {}, v1[4] = {}, k0p[4] = {}, k1p[4] = {};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t pb[4], ps[4], sb[4], ss[4];
          acc_frag_tf32(s[j], pb, ps);
          acc_frag_tf32(dp[j], sb, ss);
          const int r0 = c0 + 8 * j + 2 * t + sw, r1 = r0 + 1 - 2 * sw;
          gradient_products_tf32(v0, v1, pb, ps,
                                 dOt + r0 * P + 2 * g + 16 * dd,
                                 dOt + r1 * P + 2 * g + 16 * dd);
          gradient_products_tf32(k0p, k1p, sb, ss,
                                 Qt + r0 * P + 2 * g + 16 * dd,
                                 Qt + r1 * P + 2 * g + 16 * dd);
        }
        add_tile(dv[2 * dd], v0);
        add_tile(dv[2 * dd + 1], v1);
        add_tile(dk[2 * dd], k0p);
        add_tile(dk[2 * dd + 1], k1p);
      }
    }
    gh = gn;
    q0 = qn;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = key0 + 8 * i;
    if (kp >= a.Sk) continue;
    store_row<HD, ND, V16>(
        static_cast<float*>(a.dk.p) + (long long)b * a.dk.sb +
            (long long)hk * a.dk.sh + (long long)kp * a.dk.ss,
        dk, i, t);
    store_row<HD, ND, V16>(
        static_cast<float*>(a.dv.p) + (long long)b * a.dv.sb +
            (long long)hk * a.dv.sh + (long long)kp * a.dv.ss,
        dv, i, t);
  }
}

// dq_tf32_kernel: replaces _bwd_dq_kernel
// (src/repro/kernels/flash_attention.py:195) for fp32. The forward's
// shape, as dq_tc_kernel: one block of 4 warps per (64-query tile, head,
// batch), warp w owning queries q0 + 16w .. + 15, their lse and delta in
// registers and their dq rows in fp32 registers, written once after the
// loop over the visible key tiles. S = Q K^T and dP = dO V^T (Q, dO the A
// operands, K, V the B), masked through row_keys(), then dQ += dS K. Q and
// dO are loaded once; K and V go through the ring.
template <int HD, bool V16>
__global__ void __launch_bounds__(kTcThreads, kTf32MinBlocks<HD>)
    dq_tf32_kernel(const FlashArgs a) {
  constexpr int P = kBwdPitch<HD>, TILE = kB * P;
  constexpr int HT = kTileDim<HD>;         // a tile row (hd 120: 128)
  constexpr int ND = HT / 8;               // n8 tiles of dq
  constexpr int NK = kTf32Pass<HD>;        // keys a pass
  constexpr int NJ = NK / 8;               // n8 tiles of a pass's S
  extern __shared__ float4 tf_smem[];
  float* Qs = reinterpret_cast<float*>(tf_smem);
  float* dOs = Qs + TILE;
  float* Ks = dOs + TILE;                  // 2 stages
  float* Vs = Ks + 2 * TILE;               // 2 stages

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, sw = t >> 1;
  const int row0 = q0 + warp * 16 + g;     // and row0 + 8
  int klo[2], khi[2], kx[2];               // the keys each row keeps
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
    load_tile_async<HD, P, V16>(Qs, a.q, b, h, q0, a.Sq);
    load_tile_async<HD, P, V16>(dOs, a.dout, b, h, q0, a.Sq);
    load_tile_async<HD, P, V16>(Ks, a.k, b, hk, k0, a.Sk);
    load_tile_async<HD, P, V16>(Vs, a.v, b, hk, k0, a.Sk);
  }
  rtmma::cp_async_commit();

  float dq[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
  const float scale2 = a.scale * kLog2e;
  const float* qrow = Qs + (warp * 16 + g) * P + 2 * t;
  const float* orow = dOs + (warp * 16 + g) * P + 2 * t;

  for (int stage = 0; k0 < a.Sk; stage ^= 1) {
    rtmma::cp_async_wait<0>();
    __syncthreads();
    const int kn = next_visible(a, q0, k0 + kB);
    if (kn < a.Sk) {
      load_tile_async<HD, P, V16>(Ks + (stage ^ 1) * TILE, a.k, b, hk, kn,
                                  a.Sk);
      load_tile_async<HD, P, V16>(Vs + (stage ^ 1) * TILE, a.v, b, hk, kn,
                                  a.Sk);
    }
    rtmma::cp_async_commit();
    const float* Kt = Ks + stage * TILE;
    const float* Vt = Vs + stage * TILE;
    const bool full = tile_full(a, q0, k0);

#pragma unroll 1
    for (int c0 = 0; c0 < kB; c0 += NK) {
      // S, dP over the pass's keys c0 .. c0 + NK - 1 of the tile
      float s[NJ][4], dp[NJ][4];
      score_products_tf32<HT, NJ, P>(s, dp, qrow, orow, Kt + c0 * P,
                                     Vt + c0 * P, g, t);

      // element e of s[j]: row row0 + 8 (e / 2), key k0 + c0 + 8j + 2t +
      // (e % 2 ^ sw); dp becomes dS
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          const int kp = k0 + c0 + 8 * j + 2 * t + ((e & 1) ^ sw);
          float p = rtmma::exp2_approx(s[j][e] * scale2 - lse2[i]);
          if (!full && !((kp >= klo[i] && kp < khi[i]) || kp == kx[i]))
            p = 0.f;
          dp[j][e] = p * (dp[j][e] - delta[i]) * a.scale;
        }

      // dQ += dS K, the pass's share summed apart and then added: n8 tile j
      // is a k8 step whose k-index t is key row c0 + 8j + 2t + sw and t + 4
      // row c0 + 8j + 2t + 1 - sw
#pragma unroll
      for (int dd = 0; dd < ND / 2; ++dd) {
        float q0p[4] = {}, q1p[4] = {};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t db[4], ds[4];
          acc_frag_tf32(dp[j], db, ds);
          const int r0 = c0 + 8 * j + 2 * t + sw, r1 = r0 + 1 - 2 * sw;
          gradient_products_tf32(q0p, q1p, db, ds,
                                 Kt + r0 * P + 2 * g + 16 * dd,
                                 Kt + r1 * P + 2 * g + 16 * dd);
        }
        add_tile(dq[2 * dd], q0p);
        add_tile(dq[2 * dd + 1], q1p);
      }
    }
    k0 = kn;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + 8 * i;
    if (qp >= a.Sq) continue;
    store_row<HD, ND, V16>(
        static_cast<float*>(a.dq.p) + (long long)b * a.dq.sb +
            (long long)h * a.dq.sh + (long long)qp * a.dq.ss,
        dq, i, t);
  }
}

template <int HD>
cudaError_t dkv_tf32(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sk + kB - 1) / kB, a.KV, a.B);
  const size_t smem = (6 * kB * kBwdPitch<HD> + 4 * kB) * sizeof(float);
  if (copies16(a.q) && copies16(a.k) && copies16(a.v) &&
      copies16(a.dout) && copies16(a.dk) && copies16(a.dv))
    return launch<dkv_tf32_kernel<HD, true>, kTcThreads>(grid, smem, a, st);
  return launch<dkv_tf32_kernel<HD, false>, kTcThreads>(grid, smem, a, st);
}

template <int HD>
cudaError_t dq_tf32(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sq + kB - 1) / kB, a.H, a.B);
  const size_t smem = 6 * kB * kBwdPitch<HD> * sizeof(float);
  if (copies16(a.q) && copies16(a.k) && copies16(a.v) &&
      copies16(a.dout) && copies16(a.dq))
    return launch<dq_tf32_kernel<HD, true>, kTcThreads>(grid, smem, a, st);
  return launch<dq_tf32_kernel<HD, false>, kTcThreads>(grid, smem, a, st);
}

}  // namespace rtfa

// Writes a->dq from q, k, v, dout, lse, delta. hd must be 64, 120 or 128,
// or 32 or 112 in fp32.
extern "C" int rt_flash_attention_bwd_dq(const rtfa::FlashArgs* a,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (a->hd * 2 + a->bf16) {
    case 64: e = rtfa::dq_tf32<32>(*a, st); break;
    case 128: e = rtfa::dq_tf32<64>(*a, st); break;
    case 129: e = rtfa::dq_tc<64>(*a, st); break;
    case 224: e = rtfa::dq_tf32<112>(*a, st); break;
    case 240: e = rtfa::dq_tf32<120>(*a, st); break;
    case 241: e = rtfa::dq_tc<120>(*a, st); break;
    case 256: e = rtfa::dq_tf32<128>(*a, st); break;
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
    case 64: e = rtfa::dkv_tf32<32>(*a, st); break;
    case 128: e = rtfa::dkv_tf32<64>(*a, st); break;
    case 129: e = rtfa::dkv_tc<64>(*a, st); break;
    case 224: e = rtfa::dkv_tf32<112>(*a, st); break;
    case 240: e = rtfa::dkv_tf32<120>(*a, st); break;
    case 241: e = rtfa::dkv_tc<120>(*a, st); break;
    case 256: e = rtfa::dkv_tf32<128>(*a, st); break;
    case 257: e = rtfa::dkv_tc<128>(*a, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
