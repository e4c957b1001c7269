// Chunked-prefill attention over a paged KV pool (a chunk of C query tokens
// per slot, G grouped heads each, so C*G rows per KV head), for sm_90a.
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill.py:52
// (_prefill_kernel, called through flash_prefill at :114). Common masks and
// edges: see paged_attention.cuh. Two routes, a plain function of the dtypes
// (flash_prefill.prefill_route), with no fallback between them:
//   * bf16 q over bf16 or int8 pages (every bf16 policy, the serving path's
//     commit_prompt_chunk among them): prefill_tc_kernel, below;
//   * fp32 q or fp32 pages (the fp32 and fp32_kvint8 policies):
//     paged_attention_kernel<T, HD, 8> of paged_attention.cuh on CUDA
//     cores, one block of 8 warps per (slot, kv head, tile of rows), 8 rows
//     a warp; up to 4 warps split the rows and the others split the keys.
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
//   hd 120 (h2o-danube3): rows are padded to 128 dims in shared memory;
//   chunk 15 of every row and Q's columns 120-127 are zero-filled, so the
//   scores are unchanged, and output columns past 120 are not written.
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
  static constexpr int HP = (HD + 15) / 16 * 16;  // dims, padded to k16
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

// The CUDA-core kernel in prefill (R = 8 rows a warp), by page dtype and
// head dim.
template <typename T, int HD>
cudaError_t launch_hd(const PagedArgs& a, dim3 grid, dim3 block,
                      cudaStream_t st) {
  paged_attention_kernel<T, HD, 8><<<grid, block, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const PagedArgs& a, int hd, dim3 grid, dim3 block,
                     cudaStream_t st) {
  switch (hd) {
    case 64: return launch_hd<T, 64>(a, grid, block, st);
    case 120: return launch_hd<T, 120>(a, grid, block, st);
    case 128: return launch_hd<T, 128>(a, grid, block, st);
    default: return cudaErrorInvalidValue;
  }
}

// page_dtype: 0 fp32, 1 bf16, 2 int8 (with scales).
inline int launch_paged_prefill(const PagedArgs& a, int B, int hd,
                                int page_dtype, int nwarps, int grid_y,
                                cudaStream_t st) {
  const dim3 grid(B * a.KV, grid_y);
  const dim3 block(kWarp * nwarps);
  cudaError_t e;
  switch (page_dtype) {
    case 0: e = launch_t<float>(a, hd, grid, block, st); break;
    case 1: e = launch_t<__nv_bfloat16>(a, hd, grid, block, st); break;
    case 2: e = launch_t<int8_t>(a, hd, grid, block, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
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
    case 120: return prefill_tc<T, 120>(a, B, st);
    case 128: return prefill_tc<T, 128>(a, B, st);
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
  a.nrg = 1;
  return a;
}

}  // namespace rtk

// The CUDA-core route (fp32 q or fp32 pages). page_dtype: 0 fp32, 1 bf16,
// 2 int8 (with scales).
extern "C" int rt_flash_prefill(const void* q, int q_bf16,
                                const void* k_pages, const void* v_pages,
                                const void* k_scale, const void* v_scale,
                                const void* page_table, const void* lengths,
                                void* out, int B, int C, int KV, int G, int hd,
                                int npg, int psz, int window, float scale,
                                int page_dtype, void* stream) {
  constexpr int R = 8;
  constexpr int nwarps = 8;
  const int rows = C * G;
  rtk::PagedArgs a = rtk::prefill_args(q, q_bf16, k_pages, v_pages, k_scale,
                                       v_scale, page_table, lengths, out, C,
                                       KV, G, npg, psz, window, scale);
  a.nrg = rows <= R ? 1 : rows <= 2 * R ? 2 : 4;
  const int grid_y = (rows + R * a.nrg - 1) / (R * a.nrg);
  return rtk::launch_paged_prefill(a, B, hd, page_dtype, nwarps, grid_y,
                                   static_cast<cudaStream_t>(stream));
}

// The tensor-core route, with rt_flash_prefill's arguments: bf16 q
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
