// Flash attention forward for sm_90a: online-softmax attention with fp32
// accumulation, writing out (in q's dtype) and the per-row logsumexp.
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:101
// (_fwd_kernel, called through _fwd_impl at :141). Layout, masks and edges:
// see flash_attention.cuh. Two kernels, both on the tensor cores:
// fwd_tc_kernel (bf16 inputs, mma.sync m16n8k16) and fwd_tf32_kernel (fp32
// inputs, mma.sync m16n8k8 on tf32 operands split three ways). Both run one
// block of 4 warps per (64-row q tile, head, batch); GQA head h reads KV
// head h / (H / KV).
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
//   row_keys() (the mask as an interval and one key: a few integer
//   compares a score, where testing the mask kind for each pair was slow).
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
//   correction factor 2^(m_old - m_new). P never goes to shared memory.
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
//   that sees no key gets out = 0 and lse = -1e30.
//   Why mma.sync and not yet wgmma: wgmma needs shared-memory descriptors,
//   its own swizzled layouts (or TMA tensor maps) and warpgroup barriers,
//   none of which the repository has yet; mma.sync, ldmatrix and cp.async
//   run on sm_90a and keep the tile shape, the pipeline, the masks and the
//   lse contract that a wgmma version would keep, with only the inner
//   products changing. The wrapper refuses bf16 tensors whose base pointer
//   is not 16-byte aligned or whose batch, head and sequence strides are
//   not multiples of 8 elements (16-byte copies).
//
// fwd_tf32_kernel (fp32: the DiT and recurrent-depth models, and the fp32
// cross-checks of the AR paths). What bounds it: at the DiT-S/2 step's
// `full` case (B=256, H=6, S=256, hd 64) the call must move 404.2 MB
// (0.1207 ms at 3.35 TB/s) and do 25.77 GFLOP, which at fp32 accuracy on the
// tensor cores is three tf32 products each (0.1563 ms at 494.7 TFLOP/s):
// bound by operations, so the products go to the tensor cores.
//   Precision. A plain tf32 product keeps 11 bits of each operand: rounding
//   Q, K (or P, V) to tf32 puts outputs past the card check's fp32 bound
//   (2e-4 + 2e-4 |ref|), in thousands per case at inputs of scale 3 (the CPU
//   emulation in tests/test_torch_attention_tf32.py). So every operand x is
//   split into big = tf32(x) (to nearest) and small = tf32(x - big)
//   (truncated; split_tf32 in mma.cuh, three instructions an element), and
//   each product is big*big + big*small + small*big in one fp32 accumulator
//   (3xTF32): in the emulation, as close to an fp64 reference as the fp32
//   plain version is, for 3x the tensor-core work.
//   Products: mma.sync m16n8k8 (ldmatrix moves b16 only, so fragments come
//   from shared memory by plain loads). The order of a k-sum is free, so
//   k-index t stands for element 2t of an 8-wide slice and t + 4 for 2t + 1:
//   - S = Q K^T: A = Q (rows g, g + 8; dims 8kk + 2t, 2t + 1), B = K (key
//     8j + g, the same dims), each a float2 load. Q and K rows are padded to
//     HD + 8 floats, so a half-warp's float2 reads (words 8g + 2t) hit every
//     bank once.
//   - O += P V: the score accumulators give a thread keys 2t and 2t + 1 of
//     each n8 tile, which is the A operand of one k8 step as it stands (no
//     shuffle); V's B fragment is V[8j + 2t][8d + g] and V[8j + 2t + 1][..],
//     single floats from rows padded to HD + 4 (words 8t + g and 8t + 4 + g:
//     conflict-free). P is split in registers.
//   Each warp splits the Q, K and V values it reads, every tile: holding
//   Q's split fragments in registers across the loop at hd 64 (231
//   registers against 202) measured no faster, and at hd 128 it spills.
//   Loads: at hd 64 K and V go through a 2-stage cp.async ring as in
//   fwd_tc_kernel (next visible tile prefetched right after the barrier,
//   one barrier a tile): Q + 2 x K at HD + 8, 2 x V at HD + 4 floats a row
//   is 88 KB, 2 blocks an SM. At hd 128 two stages (168 KB) allow one
//   block of 4 warps an SM, which leaves the mma.sync chains' latency
//   unhidden; one stage (103 KB: the next tile loads after a second
//   barrier) allows two, which measured 16% faster (kTf32Stages). Masks,
//   online softmax in base 2 and the epilogue as fwd_tc_kernel; out is
//   stored as float2 pairs.
//   Alignment: the copies are 16 bytes when every tensor's base is 16-byte
//   aligned and its strides multiples of 4 floats; otherwise the same
//   kernel is instantiated with 4-byte copies and scalar stores, so any
//   fp32 view with a contiguous head dim is taken.
#include "flash_attention.cuh"

namespace rtfa {

constexpr float kLn2 = 0.6931471805599453f;

// One key tile of the online softmax, for the two rows (row0, row0 + 8) a
// thread holds: element e of s[j] is row row0 + 8 (e / 2), key
// k0 + 8j + 2t + e % 2. Scales the scores by scale2 (base 2), masks them
// to -1e30 unless the tile is full (klo/khi/kx from row_keys), turns them
// into P = 2^(s - m_new) in place, and rescales the output accumulators o
// and the per-thread row sums l by 2^(m_old - m_new).
template <int ND>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4],
                                             float (&o)[ND][4], float (&m)[2],
                                             float (&l)[2], bool full,
                                             const int (&klo)[2],
                                             const int (&khi)[2],
                                             const int (&kx)[2], int k0,
                                             int t, float scale2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
  if (!full) {
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
}

// The row sum of row i of a thread's pair (summed across the quad), and
// the row's lse (natural log; -1e30 for a row that saw no key). Returns
// max(l, 1e-30), the divisor of the output.
__device__ __forceinline__ float finish_row(float& l, float m, float* lse,
                                            bool write) {
  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);
  const float lc = fmaxf(l, 1e-30f);
  if (write) *lse = l > 0.f ? m * kLn2 + logf(lc) : kNegInf;
  return lc;
}

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
    softmax_tile<ND>(s, o, m, l, tile_full(a, q0, k0), klo, khi, kx, k0, t,
                     scale2);

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
    const int qp = row0 + 8 * i;
    const float lc = finish_row(l[i], m[i],
                                a.lse + ((long long)b * a.H + h) * a.Sq + qp,
                                qp < a.Sq && t == 0);
    if (qp >= a.Sq) continue;
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o.p) +
                          (long long)b * a.o.sb + (long long)h * a.o.sh +
                          (long long)qp * a.o.ss + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<uint32_t*>(orow + 8 * d) =
          rtmma::pack_bf16(o[d][2 * i] / lc, o[d][2 * i + 1] / lc);
  }
}

template <int HD>
cudaError_t fwd_tc(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sq + kB - 1) / kB, a.H, a.B);
  const size_t smem = 5 * kB * HD * sizeof(__nv_bfloat16);
  return launch<fwd_tc_kernel<HD>, kTcThreads>(grid, smem, a, st);
}

// Row pitches of fwd_tf32_kernel's fp32 tiles, in floats: Q and K rows are
// read as float2 at words 8g + 2t (mod 32) of a half-warp, V's as floats
// at words 8t + g and 8t + 4 + g: every bank once a request.
template <int HD>
constexpr int kQKPitch = HD + 8;
template <int HD>
constexpr int kVPitch = HD + 4;
// Stages of fwd_tf32_kernel's K/V ring (2: the next tile's loads overlap
// this tile's products; 1: they wait for them). The kernel asks for 2
// blocks an SM, which at hd 128 leaves shared memory for one stage only
// (103 KB a block against 168 KB with two): a trade that measured faster
// (tune_attention_fwd.py). At hd 32 two stages take 48 KB a block.
template <int HD>
constexpr int kTf32Stages = HD == 128 ? 1 : 2;

template <int HD, bool V16>
__global__ void __launch_bounds__(kTcThreads, 2)
    fwd_tf32_kernel(const FlashArgs a) {
  constexpr int QP = kQKPitch<HD>, VP = kVPitch<HD>, ST = kTf32Stages<HD>;
  constexpr int KS = HD / 8;          // k8 steps of Q K^T
  constexpr int ND = HD / 8;          // n8 tiles of a warp's output
  extern __shared__ float4 tf_smem[];
  float* Qs = reinterpret_cast<float*>(tf_smem);
  float* Ks = Qs + kB * QP;           // ST stages
  float* Vs = Ks + ST * kB * QP;      // ST stages

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  int klo[2], khi[2], kx[2];
  row_keys(a, row0, klo[0], khi[0], kx[0]);
  row_keys(a, row0 + 8, klo[1], khi[1], kx[1]);

  int k0 = next_visible(a, q0, 0);
  if (k0 < a.Sk) {  // else the rows see no key: out = 0, lse = -1e30
    load_tile_async<HD, QP, V16>(Qs, a.q, b, h, q0, a.Sq);
    load_tile_async<HD, QP, V16>(Ks, a.k, b, hk, k0, a.Sk);
    load_tile_async<HD, VP, V16>(Vs, a.v, b, hk, k0, a.Sk);
  }
  rtmma::cp_async_commit();
  const float* qrow = Qs + (warp * 16 + g) * QP + 2 * t;

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = a.scale * kLog2e;

  for (int stage = 0; k0 < a.Sk; stage = (stage + 1) % ST) {
    rtmma::cp_async_wait<0>();
    __syncthreads();  // as fwd_tc_kernel: tile k0 is in, the other stage free
    const int kn = next_visible(a, q0, k0 + kB);
    if constexpr (ST == 2) {
      if (kn < a.Sk) {
        load_tile_async<HD, QP, V16>(Ks + (stage ^ 1) * kB * QP, a.k, b, hk,
                                     kn, a.Sk);
        load_tile_async<HD, VP, V16>(Vs + (stage ^ 1) * kB * VP, a.v, b, hk,
                                     kn, a.Sk);
      }
      rtmma::cp_async_commit();
    }
    const float* Kt = Ks + stage * kB * QP;
    const float* Vt = Vs + stage * kB * VP;

    // S = Q K^T: n8 tile j holds keys k0 + 8j .. + 7; k-index t of step kk
    // is dim 8kk + 2t, t + 4 is dim 8kk + 2t + 1
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ab[4], as[4];
      q_frag_tf32<QP>(qrow + 8 * kk, ab, as);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(
            Kt + (8 * j + g) * QP + 8 * kk + 2 * t);
        uint32_t b0, b0s, b1, b1s;
        rtmma::split_tf32(kv.x, b0, b0s);
        rtmma::split_tf32(kv.y, b1, b1s);
        rtmma::mma_tf32x3(s[j], ab, as, b0, b1, b0s, b1s);
      }
    }
    softmax_tile<ND>(s, o, m, l, tile_full(a, q0, k0), klo, khi, kx, k0, t,
                     scale2);

    // O += P V: score tile j is the k8 step over keys k0 + 8j .. + 7 with
    // k-index t <-> key 8j + 2t and t + 4 <-> key 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t pb[4], ps[4];
      rtmma::split_tf32(s[j][0], pb[0], ps[0]);  // (g, key 2t)
      rtmma::split_tf32(s[j][2], pb[1], ps[1]);  // (g + 8, key 2t)
      rtmma::split_tf32(s[j][1], pb[2], ps[2]);  // (g, key 2t + 1)
      rtmma::split_tf32(s[j][3], pb[3], ps[3]);  // (g + 8, key 2t + 1)
      const float* vrow = Vt + (8 * j + 2 * t) * VP + g;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        uint32_t b0, b0s, b1, b1s;
        rtmma::split_tf32(vrow[8 * d], b0, b0s);        // V[8j + 2t][8d + g]
        rtmma::split_tf32(vrow[VP + 8 * d], b1, b1s);   // V[8j + 2t + 1][..]
        rtmma::mma_tf32x3(o[d], pb, ps, b0, b1, b0s, b1s);
      }
    }
    if constexpr (ST == 1) {
      __syncthreads();  // every warp is done with the one stage
      if (kn < a.Sk) {
        load_tile_async<HD, QP, V16>(Ks, a.k, b, hk, kn, a.Sk);
        load_tile_async<HD, VP, V16>(Vs, a.v, b, hk, kn, a.Sk);
      }
      rtmma::cp_async_commit();
    }
    k0 = kn;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + 8 * i;
    const float lc = finish_row(l[i], m[i],
                                a.lse + ((long long)b * a.H + h) * a.Sq + qp,
                                qp < a.Sq && t == 0);
    if (qp >= a.Sq) continue;
    float* orow = static_cast<float*>(a.o.p) + (long long)b * a.o.sb +
                  (long long)h * a.o.sh + (long long)qp * a.o.ss + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const float x = o[d][2 * i] / lc, y = o[d][2 * i + 1] / lc;
      if constexpr (V16) {
        *reinterpret_cast<float2*>(orow + 8 * d) = make_float2(x, y);
      } else {
        orow[8 * d] = x;
        orow[8 * d + 1] = y;
      }
    }
  }
}

template <int HD>
cudaError_t fwd_tf32(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid((a.Sq + kB - 1) / kB, a.H, a.B);
  const size_t smem = ((1 + kTf32Stages<HD>) * kQKPitch<HD> +
                       kTf32Stages<HD> * kVPitch<HD>) * kB * sizeof(float);
  if (copies16(a.q) && copies16(a.k) && copies16(a.v) && copies16(a.o))
    return launch<fwd_tf32_kernel<HD, true>, kTcThreads>(grid, smem, a, st);
  return launch<fwd_tf32_kernel<HD, false>, kTcThreads>(grid, smem, a, st);
}

}  // namespace rtfa

// Writes a->o and a->lse from a->q, a->k, a->v. hd must be 64 or 128, or 32
// in fp32; bf16 tensors must be 16-byte aligned with strides that are
// multiples of 8.
extern "C" int rt_flash_attention_fwd(const rtfa::FlashArgs* a, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (a->hd * 2 + a->bf16) {
    case 64: e = rtfa::fwd_tf32<32>(*a, st); break;
    case 128: e = rtfa::fwd_tf32<64>(*a, st); break;
    case 129: e = rtfa::fwd_tc<64>(*a, st); break;
    case 256: e = rtfa::fwd_tf32<128>(*a, st); break;
    case 257: e = rtfa::fwd_tc<128>(*a, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
