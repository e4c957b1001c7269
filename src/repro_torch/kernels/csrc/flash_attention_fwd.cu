// Flash attention forward for sm_90a: online-softmax attention with fp32
// accumulation, writing out (in q's dtype) and the per-row logsumexp.
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:101
// (_fwd_kernel, called through _fwd_impl at :141). Layout, masks and edges:
// see flash_attention.cuh. Two kernels: fwd_kernel (fp32 inputs, fp32 FMAs
// on the CUDA cores) and fwd_tc_kernel (bf16 inputs, tensor cores).
//
// fwd_kernel: one block per (64-row q tile, head, batch); GQA head h reads
// KV head h / (H / KV). Thread (ty, tx) owns score rows 4*ty + i and columns
// tx + 16*j of each 64 x 64 tile, and output dims tx + 16*j of its rows.
//
// fwd_tc_kernel (bf16). What bounds it: at the DB step's db_concat case
// (B=8, H=32, S=2x512, hd 64) the call must move 135.3 MB (q, k, v, out
// and lse once: 0.0404 ms at 3.35 TB/s) and do 17.21 GFLOP over the kept
// pairs (0.0174 ms at 989 TFLOP/s): bound by bytes, but only 2.3x above
// the operations, and the 80 of 256 tiles per (batch, head) it computes
// (partly masked ones whole) hold 21.5 GFLOP, 32.2 with the split P below
// (0.0326 ms at the peak). So both sides count: each byte is read
// from device memory about once (a block reads its Q tile once and the K/V
// tiles of its (batch, KV head), which the neighbouring q-tile blocks of
// the same head read from L2), and the products run on the tensor cores.
//   Grid and tiles: one block of 4 warps per (64-row q tile, head, batch),
//   each warp owning 16 q rows; K/V tiles of 64 keys, so tile_visible()
//   applies unchanged. A tile that tile_full() finds wholly kept skips the
//   mask; in the others each score is tested against its row's keys from
//   row_keys() (keep()'s mask as an interval and one key: a few integer
//   compares a score, where keep() branches on the mask kind for each).
//   Registers are capped for 3 blocks an SM at hd 64 and 2 at hd 128
//   (__launch_bounds__), with no spills.
//   Loads: cp.async 16-byte chunks into shared tiles swizzled by
//   (chunk ^ row % 8) so ldmatrix reads are free of bank conflicts; rows
//   past the sequence end are zero-filled. The Q tile is read from device
//   memory once; its A fragments are re-read from shared memory by
//   ldmatrix at each K tile (held in registers across the loop they take
//   16 / 32 more, which spills at hd 128). K and V go
//   through a 2-stage ring: right after the barrier that publishes tile i,
//   the loads of the next VISIBLE tile (skipped tiles are never loaded) are
//   started into the other stage, so they overlap tile i's products; one
//   barrier per tile. Shared memory: Q + 2 x (K, V) = 5 x 64 x hd x 2 B,
//   40 KB at hd 64 and 80 KB at hd 128 (above 48 KB through launch<>).
//   S = Q K^T: mma.sync m16n8k16 (bf16 in, fp32 accumulate; bf16 products
//   are exact in fp32, as the reference's fp32 upcast), K fragments by
//   ldmatrix (K's rows are the col-major B operand as stored). A warp's
//   16 x 64 slice is 8 n8 tiles; a thread holds 2 rows x 16 scores.
//   Online softmax in registers: scores scaled by log2(e)/sqrt(hd) and
//   exponentiated by ex2.approx, lse written in natural log; row max across
//   the quad with two shuffles, the row sum kept per thread and summed
//   across the quad once at the end; the accumulator rescaled by the
//   correction factor as fwd_kernel does. P never goes to shared memory.
//   O += P V with P at fp32 accuracy: standard flash attention rounds P to
//   bf16 before this product, but the reference keeps P in fp32 (the
//   Pallas kernel upcasts q, k, v; the plain version does the same).
//   Rounding P alone puts outputs past the card check's bound (2e-4 +
//   2^-7 |ref| for bf16 outputs) in every mask kind: hundreds to
//   thousands per case at S = 100-512, max error up to 0.0156 (the CPU
//   emulation of this kernel's arithmetic in
//   tests/test_torch_attention_tc.py). So P is split into P_hi = bf16(P)
//   and P_lo = bf16(P - P_hi), both packed from the score accumulators of
//   two adjacent n8 tiles as the A fragment (no shuffle), and both
//   products go into one fp32 accumulator: no output past the bound, max
//   error that of the output's own rounding, for 1.5x the tensor-core
//   work of a plain forward. V fragments by ldmatrix.trans (V is
//   row-major [key][d]).
//   Epilogue: divide by max(l, 1e-30), round to bf16, store bf16 pairs
//   (4 bytes) through o's strides; lane 0 of each quad writes lse. A row
//   that sees no key gets out = 0 and lse = -1e30, as fwd_kernel.
//   Why mma.sync and not yet wgmma: wgmma needs shared-memory descriptors,
//   its own swizzled layouts (or TMA tensor maps) and warpgroup barriers,
//   none of which the repository has yet; mma.sync, ldmatrix and cp.async
//   run on sm_90a and keep the tile shape, the pipeline, the masks and the
//   lse contract that a wgmma version would keep, with only the inner
//   products changing. The wrapper refuses bf16 tensors whose base pointer
//   is not 16-byte aligned or whose batch, head and sequence strides are
//   not multiples of 8 elements (16-byte copies).
#include "flash_attention.cuh"

namespace rtfa {

template <int HD>
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

  load_tile<HD>(Qs, a.q, b, h, q0, a.Sq);

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
    load_tile<HD>(Ks, a.k, b, hk, k0, a.Sk);
    load_tile<HD>(Vs, a.v, b, hk, k0, a.Sk);
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
      static_cast<float*>(a.o.p)[base + tx + 16 * j] = acc[i][j] / lc;
    if (tx == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + qp] = m[i] + logf(lc);
  }
}

template <int HD>
cudaError_t fwd(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sq + kB - 1) / kB, a.H, a.B);
  const size_t smem = (3 * kB * (HD + 1) + kB * (kB + 1)) * sizeof(float);
  return launch<fwd_kernel<HD>>(grid, smem, a, st);
}

constexpr float kLn2 = 0.6931471805599453f;

// Blocks an SM must hold at once: 3 at hd 64 (<= 168 registers a thread),
// 2 at hd 128 (its 64 output floats a thread leave no room for a third).
template <int HD>
__global__ void __launch_bounds__(kTcThreads, HD == 64 ? 3 : 2)
    fwd_tc_kernel(const FlashArgs a) {
  constexpr int CH = HD / 8;      // 16-byte chunks of a row
  constexpr int KS = HD / 16;     // k16 steps of Q K^T
  constexpr int ND = HD / 8;      // n8 tiles of a warp's output
  constexpr int TILE = kB * HD;   // elements of one 64-row tile
  extern __shared__ uint4 tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* Ks = Qs + TILE;      // 2 stages
  __nv_bfloat16* Vs = Ks + 2 * TILE;  // 2 stages

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

  int k0 = next_visible(a, q0, 0);
  if (k0 < a.Sk) {  // else the rows see no key: out = 0, lse = -1e30
    load_tile_async<HD>(Qs, a.q, b, h, q0, a.Sq);
    load_tile_async<HD>(Ks, a.k, b, hk, k0, a.Sk);
    load_tile_async<HD>(Vs, a.v, b, hk, k0, a.Sk);
  }
  rtmma::cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = a.scale * kLog2e;

  for (int stage = 0; k0 < a.Sk; stage ^= 1) {
    rtmma::cp_async_wait<0>();
    // tile k0 (and Q) is in shared memory for every thread, and every warp
    // is done with the other stage: prefetch the next visible tile into it
    __syncthreads();
    const int kn = next_visible(a, q0, k0 + kB);
    if (kn < a.Sk) {
      load_tile_async<HD>(Ks + (stage ^ 1) * TILE, a.k, b, hk, kn, a.Sk);
      load_tile_async<HD>(Vs + (stage ^ 1) * TILE, a.v, b, hk, kn, a.Sk);
    }
    rtmma::cp_async_commit();
    const __nv_bfloat16* Kt = Ks + stage * TILE;
    const __nv_bfloat16* Vt = Vs + stage * TILE;

    // S = Q K^T: n8 tile j holds keys k0 + 8j .. + 7
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qf[4];  // A fragment: the warp's 16 rows, dims 16kk..16kk+15
      rtmma::ldmatrix_x4(qf, rtmma::smem_addr(Qs + rtmma::swizzle<CH>(
          warp * 16 + (lane & 15), 2 * kk + lane / 16)));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];  // B fragments of n8 tiles 2np and 2np + 1
        rtmma::ldmatrix_x4(kf, rtmma::smem_addr(Kt + rtmma::swizzle<CH>(
            16 * np + (lane & 7) + (lane / 16) * 8, 2 * kk + (lane / 8) % 2)));
        rtmma::mma_bf16(s[2 * np], qf, kf[0], kf[1]);
        rtmma::mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
      }
    }

    // element e of s[j]: row row0 + 8 (e / 2), key k0 + 8j + 2t + e % 2
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    if (!tile_full(a, q0, k0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2, kp = k0 + 8 * j + 2 * t + e % 2;
          if (!((kp >= klo[i] && kp < khi[i]) || kp == kx[i]))
            s[j][e] = kNegInf;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // a row that has seen no key yet keeps m = -1e30: subtracting 0
      // instead sends every exponential to 0 (masked scores sit at -1e30)
      const float m_use = m_new == kNegInf ? 0.f : m_new;
      const float corr = rtmma::exp2_approx(m[i] - m_use);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[j][e] = rtmma::exp2_approx(s[j][e] - m_use);
          sum += s[j][e];
        }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[d][2 * i] *= corr;
        o[d][2 * i + 1] *= corr;
      }
    }

    // O += P V over 4 k16 steps of 16 keys; P as hi + lo bf16 fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
      rtmma::split_a_frag(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];  // B fragments of output n8 tiles 2dp and 2dp + 1
        rtmma::ldmatrix_x4_trans(vf, rtmma::smem_addr(Vt + rtmma::swizzle<CH>(
            16 * kk + (lane & 15), 2 * dp + lane / 16)));
        rtmma::mma_bf16_split(o[2 * dp], o[2 * dp + 1], hi, lo, vf);
      }
    }
    k0 = kn;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const int qp = row0 + 8 * i;
    if (qp >= a.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o.p) +
                          (long long)b * a.o.sb + (long long)h * a.o.sh +
                          (long long)qp * a.o.ss + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<uint32_t*>(orow + 8 * d) =
          rtmma::pack_bf16(o[d][2 * i] / lc, o[d][2 * i + 1] / lc);
    if (t == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + qp] =
          l[i] > 0.f ? m[i] * kLn2 + logf(lc) : kNegInf;
  }
}

template <int HD>
cudaError_t fwd_tc(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sq + kB - 1) / kB, a.H, a.B);
  const size_t smem = 5 * kB * HD * sizeof(__nv_bfloat16);
  return launch<fwd_tc_kernel<HD>, kTcThreads>(grid, smem, a, st);
}

}  // namespace rtfa

// Writes a->o and a->lse from a->q, a->k, a->v. hd must be 64 or 128; bf16
// tensors must be 16-byte aligned with strides that are multiples of 8.
extern "C" int rt_flash_attention_fwd(const rtfa::FlashArgs* a, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (a->hd * 2 + a->bf16) {
    case 128: e = rtfa::fwd<64>(*a, st); break;
    case 129: e = rtfa::fwd_tc<64>(*a, st); break;
    case 256: e = rtfa::fwd<128>(*a, st); break;
    case 257: e = rtfa::fwd_tc<128>(*a, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
