// Chunked-prefill attention over a paged KV pool (a chunk of C query tokens
// per slot, G grouped heads each, so C*G rows per KV head), for sm_90a.
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill.py:52
// (_prefill_kernel, called through flash_prefill at :114). Common masks and
// edges: see paged_attention.cuh. Two routes, a plain function of the dtypes
// (flash_prefill.prefill_route), with no fallback between them, both on the
// tensor cores with one block of 4 warps per (64-row tile, slot * kv head):
//   * bf16 q over bf16 or int8 pages (every bf16 policy, the serving path's
//     commit_prompt_chunk among them): prefill_tc_kernel, bf16 mma.sync;
//   * fp32 q or fp32 pages (the fp32 and fp32_kvint8 policies; fp32 q over
//     bf16 pages and bf16 q over fp32 pages too): prefill_tf32_kernel,
//     3xTF32 mma.sync, further below.
//
// prefill_tc_kernel. What bounds it: at stablelm's case (C=64, B=8, KV=32,
// G=1, hd 64, chunks at 0..448) the call must move 25 MB (0.0075 ms at
// 3.35 TB/s) and do about 1 GFLOP over the kept pairs (1 us on the tensor
// cores): bytes, as long as the products run on the tensor cores, which
// CUDA cores in fp32 (67 TFLOP/s) would not allow.
//   Grid: one block of 4 warps per (64-row tile, slot * kv head); rows
//   r = i*G + g as the plain version orders them, so a tile holds 64/G
//   query tokens of one KV head; each warp owns 16 rows. Q is copied once
//   (cp.async, 16-byte chunks, rows past C*G zeroed) into a swizzled tile
//   and its A fragments re-read by ldmatrix at each key tile, as
//   fwd_tc_kernel (flash_attention_fwd.cu) does.
//   K/V: 64-key tiles (4 pages at psz 16) gathered through the page table
//   by cp.async into a 2-stage ring: the next tile's copies start right
//   after the barrier that publishes this one. Only tiles some row can see
//   are loaded: [max(0, q_first - window + 1), q_last]; keys outside it,
//   and past the pool, are zero-filled.
//   S = Q K^T by mma.sync m16n8k16 (bf16 in, fp32 accumulate: the products
//   of bf16 values are exact in fp32), online softmax in base 2 in fp32,
//   O += P V with P split into bf16 hi + lo (mma.cuh's split_a_frag), so P
//   keeps the reference's fp32 accuracy (the Pallas kernel works in fp32
//   throughout; bf16 P alone breaks the card bound, as in the dense
//   forward: tests/test_torch_paged_tc.py).
//   Mask: row r keeps keys [max(0, len + i - window + 1), len + i], i = r/G,
//   an interval per row (the row_keys idea of flash_attention.cuh); a tile
//   that every row of the block sees whole skips the per-score test.
//   int8 pages: raw bytes go through their own 2-stage ring (8-byte copies
//   at hd 120, whose rows are 120 bytes) with the tile's page scales
//   (cp.async, 4 bytes each); after the barrier the block converts the tile
//   to bf16 (exact: |v| <= 127) into one swizzled K and V tile, and a second
//   barrier publishes it. The K scale multiplies each score column after
//   Q K^T, the V scale is folded into p (fp32) before the hi/lo split, and
//   l sums the unscaled p: the plain version's dequantized arithmetic, up
//   to fp32 reordering.
//   hd 120 (h2o-danube3) and 112 (zamba2): rows are padded to 128 dims in
//   shared memory (the swizzle wants whole 128-byte lines); the chunks past
//   HD / 8 of every row and Q's columns past HD are zero-filled, so the
//   scores are unchanged, and output columns past HD are not written.
//   Shared memory: Q + 2 x (K, V) bf16 tiles, 40 KB at hd 64, 80 KB at
//   hd 120/128; int8: Q + (K, V) bf16 + 2 x (K, V) raw + scales, 41/81 KB.
#include <type_traits>

#include "paged_attention.cuh"

namespace rtk {

constexpr int kPB = 64;          // rows of a q tile, keys of a k tile
constexpr int kPThreads = 128;   // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int HD>
struct PrefillTc {
  // dims, padded to whole 128-byte lines (8 chunks) for the swizzle
  static constexpr int HP = (HD + 63) / 64 * 64;
  static constexpr int CH = HP / 8;      // 16-byte bf16 chunks of a row
  static constexpr int VCH = HD / 8;     // chunks that hold data
  static constexpr int TILE = kPB * HP;  // bf16 elements of a tile
  static constexpr bool Q8 = std::is_same<T, int8_t>::value;
  static constexpr int RC = HD % 16 == 0 ? 16 : 8;  // bytes an int8 copy
  static constexpr size_t kSmem =
      Q8 ? 3 * TILE * 2 + 4 * kPB * HP + 4 * kPB * sizeof(float)
         : 5 * TILE * 2;
};

// One key tile of the online softmax for the two rows (row0, row0 + 8) a
// thread holds: element e of s[j] is row row0 + 8 (e / 2), key
// k0 + 8j + 2t + e % 2; scores already scaled to base 2. Unless `full`,
// masks them to -1e30 outside their row's [klo, khi]; turns them into
// P = 2^(s - m_new) in place, adds P to the per-thread row sums l, and
// rescales o and l by 2^(m_old - m_new).
template <int ND>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4],
                                             float (&o)[ND][4], float (&m)[2],
                                             float (&l)[2], bool full,
                                             const int (&klo)[2],
                                             const int (&khi)[2], int k0,
                                             int t) {
  if (!full) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, kp = k0 + 8 * j + 2 * t + e % 2;
        if (kp < klo[i] || kp > khi[i]) s[j][e] = kNegInf;
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

// Eight int8 values as eight bf16 (exact), one 16-byte chunk.
__device__ __forceinline__ uint4 int8x8_to_bf16(const int8_t* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = rtmma::pack_bf16(static_cast<float>(c[2 * i]),
                            static_cast<float>(c[2 * i + 1]));
  return out;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kPThreads, HD == 64 ? 3 : 2)
    prefill_tc_kernel(const PagedArgs a) {
  using L = PrefillTc<T, HD>;
  constexpr int HP = L::HP, CH = L::CH, KS = HP / 16, ND = HP / 8;
  constexpr int TILE = L::TILE;
  constexpr int NKV = L::Q8 ? 1 : 2;  // bf16 K/V tiles: a ring, or one
  extern __shared__ uint4 pf_smem[];
  __nv_bfloat16* const Qs = reinterpret_cast<__nv_bfloat16*>(pf_smem);
  __nv_bfloat16* const Ks = Qs + TILE;
  __nv_bfloat16* const Vs = Ks + NKV * TILE;
  // int8 pages: raw [stage][K, V][64][HP] bytes, scales [stage][K, V][64]
  int8_t* const raw = reinterpret_cast<int8_t*>(Vs + NKV * TILE);
  float* const scl = reinterpret_cast<float*>(raw + 4 * kPB * HP);

  const int b = blockIdx.y / a.KV, kv = blockIdx.y % a.KV;
  const int rows = a.C * a.G;
  const int r0 = blockIdx.x * kPB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int length = a.lengths[b];
  const int n_keys = a.npg * a.psz;
  const int q_first = length + r0 / a.G;
  const int q_last = length + (min(r0 + kPB, rows) - 1) / a.G;
  const int kend = min(q_last + 1, n_keys);
  const int kbeg = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  // keys every row of the block sees: [lo_all, hi_all]
  const int hi_all = min(q_first, n_keys - 1);
  const int lo_all = a.window > 0 ? max(0, q_last - a.window + 1) : 0;
  int klo[2], khi[2];  // each of this thread's rows' keys
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + warp * 16 + lane / 4 + 8 * i;
    const int pos = length + row / a.G;
    klo[i] = a.window > 0 ? max(0, pos - a.window + 1) : 0;
    khi[i] = row < rows ? min(pos, n_keys - 1) : -1;
  }

  const int* const table = a.page_table + (size_t)b * a.npg;
  const T* const kp = static_cast<const T*>(a.k_pages);
  const T* const vp = static_cast<const T*>(a.v_pages);
  // the pool offset (elements) of key idx's row, or -1 outside [kbeg, kend)
  auto key_row = [&](int idx) -> long long {
    if (idx < kbeg || idx >= kend) return -1;
    return (((long long)table[idx / a.psz] * a.psz + idx % a.psz) * a.KV +
            kv) * HD;
  };
  // start the copies of key tile k0 into stage `stage`
  auto load_kv = [&](int k0, int stage) {
    if constexpr (L::Q8) {
      int8_t* const rk = raw + stage * 2 * kPB * HP;
      int8_t* const rv = rk + kPB * HP;
      constexpr int NRC = HD / L::RC;  // copies a row
      for (int e = threadIdx.x; e < kPB * NRC; e += kPThreads) {
        const int r = e / NRC, c = e % NRC;
        const long long row = key_row(k0 + r);
        const long long off = row < 0 ? 0 : row + c * L::RC;
        const uint32_t so = rtmma::smem_addr(rk + r * HP + c * L::RC);
        const uint32_t sv = rtmma::smem_addr(rv + r * HP + c * L::RC);
        if constexpr (L::RC == 16) {
          rtmma::cp_async_16(so, kp + off, row >= 0);
          rtmma::cp_async_16(sv, vp + off, row >= 0);
        } else {
          rtmma::cp_async_8(so, kp + off, row >= 0);
          rtmma::cp_async_8(sv, vp + off, row >= 0);
        }
      }
      if (threadIdx.x < kPB) {
        const int idx = k0 + threadIdx.x;
        const bool ok = idx >= kbeg && idx < kend;
        const int ph = ok ? table[idx / a.psz] : 0;
        float* const sc = scl + stage * 2 * kPB;
        rtmma::cp_async_4(rtmma::smem_addr(sc + threadIdx.x),
                          a.k_scale + ph, ok);
        rtmma::cp_async_4(rtmma::smem_addr(sc + kPB + threadIdx.x),
                          a.v_scale + ph, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPB * CH / kPThreads; ++i) {
        const int e = threadIdx.x + i * kPThreads;
        const int r = e / CH, c = e % CH;
        const long long row = c < L::VCH ? key_row(k0 + r) : -1;
        const long long off = row < 0 ? 0 : row + c * 8;
        const int so = rtmma::swizzle<CH>(r, c);
        rtmma::cp_async_16(rtmma::smem_addr(Ks + stage * TILE + so),
                           kp + off, row >= 0);
        rtmma::cp_async_16(rtmma::smem_addr(Vs + stage * TILE + so),
                           vp + off, row >= 0);
      }
    }
  };

  int k0 = kbeg / kPB * kPB;
  if (k0 < kend) {  // else no row sees a key: out = 0
    const __nv_bfloat16* const q = static_cast<const __nv_bfloat16*>(a.q);
#pragma unroll
    for (int i = 0; i < kPB * CH / kPThreads; ++i) {
      const int e = threadIdx.x + i * kPThreads;
      const int r = e / CH, c = e % CH;
      const bool ok = r0 + r < rows && c < L::VCH;
      const __nv_bfloat16* src =
          ok ? q + row_offset(a, b, kv, r0 + r, HD) + c * 8 : q;
      rtmma::cp_async_16(rtmma::smem_addr(Qs + rtmma::swizzle<CH>(r, c)), src,
                         ok);
    }
    load_kv(k0, 0);
  }
  rtmma::cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = a.scale * kLog2e;

  for (int stage = 0; k0 < kend; stage ^= 1) {
    rtmma::cp_async_wait<0>();
    // tile k0 (and Q) is in shared memory for every thread, and every warp
    // is done with the other stage: prefetch the next tile into it
    __syncthreads();
    const int kn = k0 + kPB;
    if (kn < kend) load_kv(kn, stage ^ 1);
    rtmma::cp_async_commit();
    const __nv_bfloat16* Kt = Ks + stage * TILE;
    const __nv_bfloat16* Vt = Vs + stage * TILE;
    const float* ksc = nullptr;
    if constexpr (L::Q8) {
      const int8_t* const rk = raw + stage * 2 * kPB * HP;
      const int8_t* const rv = rk + kPB * HP;
      for (int e = threadIdx.x; e < kPB * CH; e += kPThreads) {
        const int r = e / CH, c = e % CH;
        uint4 kx = make_uint4(0, 0, 0, 0), vx = kx;
        if (c < L::VCH) {
          kx = int8x8_to_bf16(rk + r * HP + 8 * c);
          vx = int8x8_to_bf16(rv + r * HP + 8 * c);
        }
        const int so = rtmma::swizzle<CH>(r, c);
        *reinterpret_cast<uint4*>(Ks + so) = kx;
        *reinterpret_cast<uint4*>(Vs + so) = vx;
      }
      __syncthreads();  // the bf16 tile is complete
      Kt = Ks;
      Vt = Vs;
      ksc = scl + stage * 2 * kPB;
    }

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
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float c0 = scale2, c1 = scale2;
      if constexpr (L::Q8) {  // the key's page K scale, per column
        const float2 ks = *reinterpret_cast<const float2*>(ksc + 8 * j +
                                                           2 * t);
        c0 *= ks.x;
        c1 *= ks.y;
      }
      s[j][0] *= c0;
      s[j][1] *= c1;
      s[j][2] *= c0;
      s[j][3] *= c1;
    }
    const bool full = k0 >= lo_all && k0 + kPB - 1 <= hi_all;
    softmax_tile<ND>(s, o, m, l, full, klo, khi, k0, t);
    if constexpr (L::Q8) {  // fold the key's page V scale into p
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 vs = *reinterpret_cast<const float2*>(
            ksc + kPB + 8 * j + 2 * t);
        s[j][0] *= vs.x;
        s[j][1] *= vs.y;
        s[j][2] *= vs.x;
        s[j][3] *= vs.y;
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
    const int row = r0 + warp * 16 + lane / 4 + 8 * i;
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const float lc = fmaxf(l[i], 1e-30f);
    if (row >= rows) continue;
    float* const orow = a.out + row_offset(a, b, kv, row, HD) + 2 * t;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<float2*>(orow + 8 * d) =
          make_float2(o[d][2 * i] / lc, o[d][2 * i + 1] / lc);
  }
}

// prefill_tf32_kernel: the route of fp32 q or fp32 pages. What bounds it: at
// stablelm's case with fp32 q and pages (C=64, B=8, KV=32, G=1, hd 64,
// chunks at 0..448) the call must move 46 MB (0.0138 ms at 3.35 TB/s) and
// do about 1 GFLOP over the kept pairs, which at the card's fp32-accurate
// rate (3xTF32: 495 / 3 TFLOP/s) is 6 us: bytes, as long as the products
// run on the tensor cores; on CUDA cores (67 TFLOP/s) the products alone
// would take 15 us. The design is prefill_tc_kernel's, with fp32 tiles:
//   Grid and rows: as prefill_tc_kernel, one block of 4 warps per (64-row
//   tile, slot * kv head), rows r = i*G + g, 16 rows a warp; so a K/V row
//   is read from device memory once per row tile.
//   Q: copied once into an fp32 tile (cp.async from fp32 q; bf16 q widened
//   on the copy, exact). At hd 64 each warp splits its A fragments into
//   tf32 big + small (split_tf32) once and keeps them in registers (64);
//   at hd 120/128 that would be 128 registers more, so it re-reads and
//   splits them each key tile, as fwd_tf32_kernel does.
//   K/V: 64-key tiles gathered through the page table by cp.async. fp32
//   pages land in fp32 tiles of fwd_tf32_kernel's row pitches (Q and K
//   rows a multiple of 32 floats plus 8, V rows plus 4: every fragment read
//   touches each bank once) in a ring of its stage count (2 at hd 64; 1 at
//   hd 120/128, where two stages would leave one block an SM). bf16 and
//   int8 pages go raw through a 2-stage ring of their own (with the int8
//   page scales, 4-byte copies); after the barrier the block widens the
//   tile to fp32 (exact) into one K and one V tile, and a second barrier
//   publishes it. Only tiles some row can see are loaded, keys outside
//   [max(0, q_first - window + 1), q_last] and past the pool zero-filled.
//   Products: S = Q K^T and O += P V by mma.sync m16n8k8 on tf32 operands,
//   each fp32 operand split in big + small and the three products of
//   mma_tf32x3 summed (3xTF32: fp32 accuracy; one tf32 product breaks the
//   card bound, tests/test_torch_prefill_tf32.py). A bf16 or int8 operand
//   is exact in tf32: its small term is zero, and the product it would
//   feed is dropped (two products, not three).
//   Softmax: online, base 2, fp32, prefill_tc_kernel's softmax_tile (an
//   interval of keys per row, the per-score test skipped where the whole
//   tile is visible to every row). int8: the K scale multiplies the score
//   columns, the V scale is folded into p before the split, l sums the
//   unscaled p.
//   hd 120 and 112: 15 and 14 k8 steps, so rows need no padding (the
//   pitches are those of hd 128); output columns stop at HD.
//   Shared memory: hd 64 fp32 pages 88 KB (2 blocks an SM), hd 120/128
//   101 KB; bf16 or int8 pages: Q, one K and V tile and the raw ring, 85 /
//   70 KB at hd 64, 165 / 134 KB at hd 128.
//   Measured at about 3.4x its bound at that case: a third block an SM,
//   one stage, and a 2x2 warp layout with half the splits were all slower,
//   while the time follows the product count (int8 pages, two products:
//   0.71x), which points at the mma.sync tf32 rate (PERF.md); wgmma is
//   the next step.
template <int HD>
constexpr int kTfRow = (HD + 31) / 32 * 32;  // a row's floats, rounded

template <typename TQ, typename TP, int HD>
struct PrefillTf32 {
  static constexpr int QP = kTfRow<HD> + 8;  // Q and K rows: words 8g + 2t
  static constexpr int VP = kTfRow<HD> + 4;  // V rows: words 8t + g
  static constexpr bool QX = sizeof(TQ) == 2;  // bf16 q: exact in tf32
  static constexpr bool PX = sizeof(TP) < 4;   // bf16 or int8 pages: exact
  static constexpr bool Q8 = std::is_same<TP, int8_t>::value;
  // fp32 K/V tiles: a ring of fwd_tf32_kernel's kTf32Stages for fp32
  // pages, one tile (fed by the raw ring) for bf16 and int8 pages
  static constexpr int ST = PX ? 1 : (HD == 64 ? 2 : 1);
  static constexpr int RB = HD * static_cast<int>(sizeof(TP));  // raw row
  static constexpr int RC = RB % 16 == 0 ? 16 : 8;  // bytes a raw copy
  static constexpr size_t kSmem =
      (size_t)(kPB * QP + ST * kPB * (QP + VP)) * sizeof(float) +
      (PX ? 4 * kPB * RB + (Q8 ? 4 * kPB * sizeof(float) : 0) : 0);
  static_assert(!(QX && PX), "bf16 q over bf16 or int8 pages is the tc "
                "route");
};

// An operand for the tf32 products: exact (bf16 or int8 widened) as its own
// bits with no small term, else split_tf32.
template <bool EXACT>
__device__ __forceinline__ void tf32_operand(float x, uint32_t& big,
                                             uint32_t& small) {
  if constexpr (EXACT) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    rtmma::split_tf32(x, big, small);
  }
}

// d += A B to fp32 accuracy from split operands, the products of a zero
// small term (an exact operand) dropped: mma_tf32x3's order otherwise.
template <bool AX, bool BX>
__device__ __forceinline__ void mma_fp32(float (&d)[4],
                                         const uint32_t (&a_big)[4],
                                         const uint32_t (&a_small)[4],
                                         uint32_t b0, uint32_t b1,
                                         uint32_t b0s, uint32_t b1s) {
  if constexpr (!AX) rtmma::mma_tf32(d, a_small, b0, b1);
  if constexpr (!BX) rtmma::mma_tf32(d, a_big, b0s, b1s);
  rtmma::mma_tf32(d, a_big, b0, b1);
}

// The A fragment of Q's k8 step at p (row g's dims 8kk + 2t, 2t + 1; p +
// 8 * QP is row g + 8): k-index t is dim 2t, t + 4 is dim 2t + 1.
template <int QP, bool EXACT>
__device__ __forceinline__ void q_frag(const float* p, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * QP);
  tf32_operand<EXACT>(x0.x, big[0], small[0]);  // (g, k t)
  tf32_operand<EXACT>(x1.x, big[1], small[1]);  // (g + 8, k t)
  tf32_operand<EXACT>(x0.y, big[2], small[2]);  // (g, k t + 4)
  tf32_operand<EXACT>(x1.y, big[3], small[3]);  // (g + 8, k t + 4)
}

// Four bf16 or int8 page values at p as a float4 (exact).
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

__device__ __forceinline__ float4 widen4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

template <typename TQ, typename TP, int HD>
__global__ void __launch_bounds__(kPThreads, 2)
    prefill_tf32_kernel(const PagedArgs a) {
  using L = PrefillTf32<TQ, TP, HD>;
  constexpr int QP = L::QP, VP = L::VP, ST = L::ST, RB = L::RB;
  constexpr int KS = HD / 8, ND = HD / 8;  // k8 steps; n8 output tiles
  constexpr int CH = HD / 4;               // 4-float pieces of a row
  constexpr bool QREG = HD == 64;          // Q's split fragments in registers
  constexpr bool RING = L::PX || ST == 2;  // next tile's copies overlap
  extern __shared__ float4 tf_smem[];
  float* const Qs = reinterpret_cast<float*>(tf_smem);
  float* const Ks = Qs + kPB * QP;       // ST stages
  float* const Vs = Ks + ST * kPB * QP;  // ST stages
  // bf16 / int8 pages: raw [stage][K, V][64][RB] bytes, scales [stage][K,
  // V][64]
  char* const raw = reinterpret_cast<char*>(Vs + ST * kPB * VP);
  float* const scl = reinterpret_cast<float*>(raw + 4 * kPB * RB);

  const int b = blockIdx.y / a.KV, kv = blockIdx.y % a.KV;
  const int rows = a.C * a.G;
  const int r0 = blockIdx.x * kPB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int length = a.lengths[b];
  const int n_keys = a.npg * a.psz;
  const int q_first = length + r0 / a.G;
  const int q_last = length + (min(r0 + kPB, rows) - 1) / a.G;
  const int kend = min(q_last + 1, n_keys);
  const int kbeg = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  // keys every row of the block sees: [lo_all, hi_all]
  const int hi_all = min(q_first, n_keys - 1);
  const int lo_all = a.window > 0 ? max(0, q_last - a.window + 1) : 0;
  int klo[2], khi[2];  // each of this thread's rows' keys
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + warp * 16 + g + 8 * i;
    const int pos = length + row / a.G;
    klo[i] = a.window > 0 ? max(0, pos - a.window + 1) : 0;
    khi[i] = row < rows ? min(pos, n_keys - 1) : -1;
  }

  const int* const table = a.page_table + (size_t)b * a.npg;
  const TP* const kp = static_cast<const TP*>(a.k_pages);
  const TP* const vp = static_cast<const TP*>(a.v_pages);
  // the pool offset (elements) of key idx's row, or -1 outside [kbeg, kend)
  auto key_row = [&](int idx) -> long long {
    if (idx < kbeg || idx >= kend) return -1;
    return (((long long)table[idx / a.psz] * a.psz + idx % a.psz) * a.KV +
            kv) * HD;
  };
  // start the copies of key tile k0 into stage `stage` of its ring
  auto load_kv = [&](int k0, int stage) {
    if constexpr (L::PX) {
      char* const rk = raw + stage * 2 * kPB * RB;
      char* const rv = rk + kPB * RB;
      constexpr int NRC = RB / L::RC;  // copies a row
      for (int e = threadIdx.x; e < kPB * NRC; e += kPThreads) {
        const int r = e / NRC, c = e % NRC;
        const long long row = key_row(k0 + r);
        const long long off = row < 0 ? 0 : row * (long long)sizeof(TP) +
                                                 c * L::RC;
        const uint32_t so = rtmma::smem_addr(rk + r * RB + c * L::RC);
        const uint32_t sv = rtmma::smem_addr(rv + r * RB + c * L::RC);
        const char* const ksrc = reinterpret_cast<const char*>(kp) + off;
        const char* const vsrc = reinterpret_cast<const char*>(vp) + off;
        if constexpr (L::RC == 16) {
          rtmma::cp_async_16(so, ksrc, row >= 0);
          rtmma::cp_async_16(sv, vsrc, row >= 0);
        } else {
          rtmma::cp_async_8(so, ksrc, row >= 0);
          rtmma::cp_async_8(sv, vsrc, row >= 0);
        }
      }
      if constexpr (L::Q8) {
        if (threadIdx.x < kPB) {
          const int idx = k0 + threadIdx.x;
          const bool ok = idx >= kbeg && idx < kend;
          const int ph = ok ? table[idx / a.psz] : 0;
          float* const sc = scl + stage * 2 * kPB;
          rtmma::cp_async_4(rtmma::smem_addr(sc + threadIdx.x),
                            a.k_scale + ph, ok);
          rtmma::cp_async_4(rtmma::smem_addr(sc + kPB + threadIdx.x),
                            a.v_scale + ph, ok);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPB * CH / kPThreads; ++i) {
        const int e = threadIdx.x + i * kPThreads;
        const int r = e / CH, c = e % CH;
        const long long row = key_row(k0 + r);
        const long long off = row < 0 ? 0 : row + 4 * c;
        rtmma::cp_async_16(
            rtmma::smem_addr(Ks + (stage * kPB + r) * QP + 4 * c), kp + off,
            row >= 0);
        rtmma::cp_async_16(
            rtmma::smem_addr(Vs + (stage * kPB + r) * VP + 4 * c), vp + off,
            row >= 0);
      }
    }
  };

  int k0 = kbeg / kPB * kPB;
  if (k0 < kend) {  // else no row sees a key: out = 0
#pragma unroll
    for (int i = 0; i < kPB * CH / kPThreads; ++i) {
      const int e = threadIdx.x + i * kPThreads;
      const int r = e / CH, c = e % CH;
      const bool ok = r0 + r < rows;
      const size_t off = ok ? row_offset(a, b, kv, r0 + r, HD) + 4 * c : 0;
      float* const dst = Qs + r * QP + 4 * c;
      if constexpr (L::QX) {  // widened on the copy; rows past C*G zero
        *reinterpret_cast<float4*>(dst) =
            ok ? widen4(static_cast<const __nv_bfloat16*>(a.q) + off)
               : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        rtmma::cp_async_16(rtmma::smem_addr(dst),
                           static_cast<const float*>(a.q) + off, ok);
      }
    }
    load_kv(k0, 0);
  }
  rtmma::cp_async_commit();

  const float* const qrow = Qs + (warp * 16 + g) * QP + 2 * t;
  uint32_t qb[QREG ? KS : 1][4], qs[QREG ? KS : 1][4];
  if constexpr (QREG) {
    if (k0 < kend) {
      rtmma::cp_async_wait<0>();
      __syncthreads();  // Q is in shared memory for every thread
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        q_frag<QP, L::QX>(qrow + 8 * kk, qb[kk], qs[kk]);
    }
  }

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = a.scale * kLog2e;

  for (int it = 0; k0 < kend; ++it) {
    const int cur = it & 1;
    rtmma::cp_async_wait<0>();
    // tile k0 (and Q) is in shared memory for every thread, and every warp
    // is done with the other stage: prefetch the next tile into it
    __syncthreads();
    const int kn = k0 + kPB;
    if constexpr (RING) {
      if (kn < kend) load_kv(kn, cur ^ 1);
      rtmma::cp_async_commit();
    }
    const float* Kt = Ks + (ST == 2 ? cur : 0) * kPB * QP;
    const float* Vt = Vs + (ST == 2 ? cur : 0) * kPB * VP;
    const float* ksc = nullptr;
    if constexpr (L::PX) {  // widen the raw tile into the fp32 K and V
      const TP* const rk =
          reinterpret_cast<const TP*>(raw + cur * 2 * kPB * RB);
      const TP* const rv = rk + kPB * HD;
#pragma unroll
      for (int i = 0; i < kPB * CH / kPThreads; ++i) {
        const int e = threadIdx.x + i * kPThreads;
        const int r = e / CH, c = e % CH;
        *reinterpret_cast<float4*>(Ks + r * QP + 4 * c) =
            widen4(rk + r * HD + 4 * c);
        *reinterpret_cast<float4*>(Vs + r * VP + 4 * c) =
            widen4(rv + r * HD + 4 * c);
      }
      __syncthreads();  // the fp32 tile is complete
      if constexpr (L::Q8) ksc = scl + cur * 2 * kPB;
    }

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
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qb[kk][e];
          as[e] = qs[kk][e];
        }
      } else {
        q_frag<QP, L::QX>(qrow + 8 * kk, ab, as);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 kx = *reinterpret_cast<const float2*>(
            Kt + (8 * j + g) * QP + 8 * kk + 2 * t);
        uint32_t b0, b0s, b1, b1s;
        tf32_operand<L::PX>(kx.x, b0, b0s);
        tf32_operand<L::PX>(kx.y, b1, b1s);
        mma_fp32<L::QX, L::PX>(s[j], ab, as, b0, b1, b0s, b1s);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float c0 = scale2, c1 = scale2;
      if constexpr (L::Q8) {  // the key's page K scale, per column
        const float2 ks = *reinterpret_cast<const float2*>(ksc + 8 * j +
                                                           2 * t);
        c0 *= ks.x;
        c1 *= ks.y;
      }
      s[j][0] *= c0;
      s[j][1] *= c1;
      s[j][2] *= c0;
      s[j][3] *= c1;
    }
    const bool full = k0 >= lo_all && k0 + kPB - 1 <= hi_all;
    softmax_tile<ND>(s, o, m, l, full, klo, khi, k0, t);
    if constexpr (L::Q8) {  // fold the key's page V scale into p
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 vs = *reinterpret_cast<const float2*>(
            ksc + kPB + 8 * j + 2 * t);
        s[j][0] *= vs.x;
        s[j][1] *= vs.y;
        s[j][2] *= vs.x;
        s[j][3] *= vs.y;
      }
    }

    // O += P V: score tile j is the k8 step over keys k0 + 8j .. + 7 with
    // k-index t <-> key 8j + 2t and t + 4 <-> key 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t pb[4], ps[4];
      rtmma::split_tf32(s[j][0], pb[0], ps[0]);  // (g, key 2t)
      rtmma::split_tf32(s[j][2], pb[1], ps[1]);  // (g + 8, key 2t)
      rtmma::split_tf32(s[j][1], pb[2], ps[2]);  // (g, key 2t + 1)
      rtmma::split_tf32(s[j][3], pb[3], ps[3]);  // (g + 8, key 2t + 1)
      const float* const vrow = Vt + (8 * j + 2 * t) * VP + g;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        uint32_t b0, b0s, b1, b1s;
        tf32_operand<L::PX>(vrow[8 * d], b0, b0s);       // V[8j + 2t][8d + g]
        tf32_operand<L::PX>(vrow[VP + 8 * d], b1, b1s);  // V[8j + 2t + 1][..]
        mma_fp32<false, L::PX>(o[d], pb, ps, b0, b1, b0s, b1s);
      }
    }
    if constexpr (!RING) {
      __syncthreads();  // every warp is done with the one stage
      if (kn < kend) load_kv(kn, 0);
      rtmma::cp_async_commit();
    }
    k0 = kn;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + warp * 16 + g + 8 * i;
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const float lc = fmaxf(l[i], 1e-30f);
    if (row >= rows) continue;
    float* const orow = a.out + row_offset(a, b, kv, row, HD) + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<float2*>(orow + 8 * d) =
          make_float2(o[d][2 * i] / lc, o[d][2 * i + 1] / lc);
  }
}

template <typename T, int HD>
cudaError_t prefill_tc(const PagedArgs& a, int B, cudaStream_t st) {
  const dim3 grid((a.C * a.G + kPB - 1) / kPB, B * a.KV);
  return launch_smem<prefill_tc_kernel<T, HD>>(grid, dim3(kPThreads),
                                               PrefillTc<T, HD>::kSmem, a, st);
}

template <typename T>
cudaError_t prefill_tc_hd(const PagedArgs& a, int B, int hd,
                          cudaStream_t st) {
  switch (hd) {
    case 64: return prefill_tc<T, 64>(a, B, st);
    case 112: return prefill_tc<T, 112>(a, B, st);
    case 120: return prefill_tc<T, 120>(a, B, st);
    case 128: return prefill_tc<T, 128>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TP, int HD>
cudaError_t prefill_tf32(const PagedArgs& a, int B, cudaStream_t st) {
  const dim3 grid((a.C * a.G + kPB - 1) / kPB, B * a.KV);
  return launch_smem<prefill_tf32_kernel<TQ, TP, HD>>(
      grid, dim3(kPThreads), PrefillTf32<TQ, TP, HD>::kSmem, a, st);
}

template <typename TQ, typename TP>
cudaError_t prefill_tf32_hd(const PagedArgs& a, int B, int hd,
                            cudaStream_t st) {
  switch (hd) {
    case 64: return prefill_tf32<TQ, TP, 64>(a, B, st);
    case 112: return prefill_tf32<TQ, TP, 112>(a, B, st);
    case 120: return prefill_tf32<TQ, TP, 120>(a, B, st);
    case 128: return prefill_tf32<TQ, TP, 128>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

inline PagedArgs prefill_args(const void* q, int q_bf16, const void* k_pages,
                              const void* v_pages, const void* k_scale,
                              const void* v_scale, const void* page_table,
                              const void* lengths, void* out, int C, int KV,
                              int G, int npg, int psz, int window,
                              float scale) {
  PagedArgs a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.page_table = static_cast<const int*>(page_table);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.lse = nullptr;
  a.part = nullptr;
  a.nsplit = 1;
  a.q_bf16 = q_bf16;
  a.C = C;
  a.KV = KV;
  a.G = G;
  a.npg = npg;
  a.psz = psz;
  a.window = window;
  a.scale = scale;
  return a;
}

}  // namespace rtk

// The bf16 tensor-core route: bf16 q
// (q_bf16 = 1) over bf16 (page_dtype 1) or int8 (2, with scales) pages; q
// and the pages 16-byte aligned and contiguous.
extern "C" int rt_flash_prefill_tc(const void* q, int q_bf16,
                                   const void* k_pages, const void* v_pages,
                                   const void* k_scale, const void* v_scale,
                                   const void* page_table,
                                   const void* lengths, void* out, int B,
                                   int C, int KV, int G, int hd, int npg,
                                   int psz, int window, float scale,
                                   int page_dtype, void* stream) {
  if (!q_bf16) return static_cast<int>(cudaErrorInvalidValue);
  const rtk::PagedArgs a = rtk::prefill_args(
      q, 1, k_pages, v_pages, k_scale, v_scale, page_table, lengths, out, C,
      KV, G, npg, psz, window, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (page_dtype) {
    case 1: e = rtk::prefill_tc_hd<__nv_bfloat16>(a, B, hd, st); break;
    case 2: e = rtk::prefill_tc_hd<int8_t>(a, B, hd, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// The 3xTF32 route, with rt_flash_prefill_tc's arguments: fp32 q (q_bf16 =
// 0) over fp32 (page_dtype 0), bf16 (1) or int8 (2, with scales) pages, or
// bf16 q over fp32 pages; q and the pages 16-byte aligned and contiguous.
extern "C" int rt_flash_prefill_tf32(const void* q, int q_bf16,
                                     const void* k_pages, const void* v_pages,
                                     const void* k_scale, const void* v_scale,
                                     const void* page_table,
                                     const void* lengths, void* out, int B,
                                     int C, int KV, int G, int hd, int npg,
                                     int psz, int window, float scale,
                                     int page_dtype, void* stream) {
  const rtk::PagedArgs a = rtk::prefill_args(
      q, q_bf16, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
      out, C, KV, G, npg, psz, window, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (q_bf16 * 3 + page_dtype) {
    case 0: e = rtk::prefill_tf32_hd<float, float>(a, B, hd, st); break;
    case 1:
      e = rtk::prefill_tf32_hd<float, __nv_bfloat16>(a, B, hd, st);
      break;
    case 2: e = rtk::prefill_tf32_hd<float, int8_t>(a, B, hd, st); break;
    case 3:
      e = rtk::prefill_tf32_hd<__nv_bfloat16, float>(a, B, hd, st);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
