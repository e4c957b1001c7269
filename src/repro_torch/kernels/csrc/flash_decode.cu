// Flash-decode over a paged KV pool (one query token per slot, G grouped
// query heads per KV head), for sm_90a. Replaces the Pallas TPU kernel
// src/repro/kernels/flash_decode.py:51 (_decode_kernel, called through
// flash_decode at :114). Common masks and edges: see paged_attention.cuh.
//
// What bounds it. Decode reads every visible K/V row of the slot once and
// does 4*G*hd flops per key: about 1 flop per byte at G = 1, so bytes. At
// stablelm's case (B=8, KV=32, G=1, hd 64, ragged lengths to 544) it must
// move 21.4 MB (0.0064 ms at 3.35 TB/s). What it takes to reach that is
// enough bytes in flight: about 25 KB an SM by Little's law.
//
// paged_decode_kernel. One block of 4 warps (2 where 4 warps' shared memory
// would pass an SM's 227 KB: fp32 pages at hd 120 and 128; decode_launch
// picks) per (slot, kv head, split): the slot's visible 32-key tiles are shared
// out among gridDim.y blocks (the split, from the lengths read in the
// kernel), and within a block the warps take interleaved tiles.
//   * Each warp stages its tiles' K and V rows in its own 2-stage ring in
//     shared memory by cp.async: 16-byte copies (8 for int8 at hd 120, whose
//     rows are 120 bytes), neighbouring lanes on neighbouring copies of one
//     row (8 lanes a 128-byte row at hd 64 bf16), each row's physical page
//     from the page table. Tile t + 1's copies are in flight while tile t is
//     scored and summed; no barrier wider than the warp.
//   * Scores: lane j owns key j, reading its K row from shared memory copy
//     by copy against the warp's query rows (fp32, shared memory). The row
//     pitch is padded to an odd number of copies, so the 8 (16-byte) or 16
//     (8-byte) lanes of one shared-memory phase read 8 or 16 different bank
//     groups: free of bank conflicts (counted in tests/test_torch_paged_tc.py).
//   * P.V: lanes own neighbouring dims (2 per lane per 64), read V as
//     bf16x2 / float2 / char2 from the staged rows and walk the tile's 32
//     keys, p_j broadcast by a shuffle. No device-memory load sits in that
//     loop: the page-table entry of tile t + 2 and the int8 scales of tile
//     t + 1 are loaded one tile ahead into registers.
//   * int8 pages: raw bytes are staged and dequantized in registers, scores
//     times the key's page K scale, p times its page V scale before the sum
//     (the row sum l takes the unscaled p).
//   * The warps merge (m, l, acc) through shared memory. With one block a
//     pair it writes out and lse; with several it writes its partial (acc,
//     m, l) and decode_merge_kernel, launched after it on the same stream,
//     merges the splits in fp32.
//   The split is chosen by the wrapper (flash_decode.decode_splits): one
//   block a pair when the pairs fill the SMs, else enough blocks for about
//   two an SM, never fewer than 16 tiles a block (a shorter share loses to
//   the merge launch).
#include "paged_attention.cuh"

namespace rtk {

constexpr int kStages = 2;

// One K (or V) tile of 32 keys in shared memory: rows of HD elements copied
// in kCopy-byte pieces, kPitch bytes apart (an odd number of copies). A
// stage of a warp's ring holds a K tile, a V tile and the 32 keys' page
// scales (K then V; int8 pages only).
template <typename T, int HD>
struct DecodeTile {
  static constexpr int kRow = HD * (int)sizeof(T);
  static constexpr int kCopy = kRow % 16 == 0 ? 16 : 8;
  static constexpr int kCopies = kRow / kCopy;
  static constexpr int kPitch = (kCopies | 1) * kCopy;
  static constexpr int kBytes = kTile * kPitch;
  static constexpr int kStage = 2 * kBytes + 2 * kTile * (int)sizeof(float);
  static_assert(kRow % 8 == 0, "rows of whole 8-byte copies");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

// The BYTES / sizeof(T) elements of one staged copy, as fp32.
template <typename T, int BYTES>
__device__ __forceinline__ void copy_to_float(const char* p, float* o) {
  if constexpr (BYTES == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 16 / (int)sizeof(T); ++i) o[i] = to_f(e[i]);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8 / (int)sizeof(T); ++i) o[i] = to_f(e[i]);
  }
}

// Two adjacent elements of a staged row, as fp32.
__device__ __forceinline__ float2 pair_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_f(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  if constexpr (BYTES == 16)
    rtmma::cp_async_16(dst, src, valid);
  else
    rtmma::cp_async_8(dst, src, valid);
}

// Dynamic shared memory of a block of nw warps: the warps' rings, their
// query rows (then partial accumulators) and their m, l.
template <typename T, int HD, int R>
constexpr size_t decode_smem(int nw) {
  return (size_t)nw * (kStages * DecodeTile<T, HD>::kStage +
                       (R * HD + 2 * R) * sizeof(float));
}

// Rows r < G of slot b, kv head kv; R = G rounded up to a power of two.
template <typename T, int HD, int R>
__global__ void __launch_bounds__(4 * kWarp)
    paged_decode_kernel(const PagedArgs a) {
  using Tl = DecodeTile<T, HD>;
  constexpr int NC = Tl::kCopy / (int)sizeof(T);  // elements a copy
  constexpr int NP = (HD + 63) / 64;              // dim pairs a lane owns
  extern __shared__ uint4 dec_smem[];
  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  char* const smem = reinterpret_cast<char*>(dec_smem);
  char* const ring = smem + warp * kStages * Tl::kStage;
  float* const buf = reinterpret_cast<float*>(smem + nw * kStages * Tl::kStage);
  float* const m_s = buf + nw * R * HD;
  float* const l_s = m_s + nw * R;

  const int b = blockIdx.x / a.KV, kv = blockIdx.x % a.KV;
  const int length = a.lengths[b];
  const int kend = min(length, a.npg * a.psz);
  const int kbeg = a.window > 0 ? max(0, length - a.window + 1) : 0;
  // this block's share of the visible 32-key tiles [tb, tb + nt)
  const int tb = kbeg / kTile;
  const int nt = kend > kbeg ? (kend - 1) / kTile + 1 - tb : 0;
  const int per = (nt + a.nsplit - 1) / a.nsplit;
  const int t_hi = tb + min(nt, (int)(blockIdx.y + 1) * per);

  const char* const kbase = static_cast<const char*>(a.k_pages);
  const char* const vbase = static_cast<const char*>(a.v_pages);
  const int* const table = a.page_table + (size_t)b * a.npg;
  const bool quant = a.k_scale != nullptr;

  // the physical page of key tile * 32 + lane (0, the trash page, outside
  // the visible keys)
  auto phys_of = [&](int tile) {
    const int idx = tile * kTile + lane;
    return idx >= kbeg && idx < kend ? table[idx / a.psz] : 0;
  };
  // start the copies of tile `tile` into stage `stage`; `phys` as phys_of
  auto issue = [&](int tile, int stage, int phys) {
    char* const kd = ring + stage * Tl::kStage;
    char* const vd = kd + Tl::kBytes;
#pragma unroll
    for (int i = 0; i < Tl::kCopies; ++i) {
      const int e = lane + kWarp * i;
      const int j = e / Tl::kCopies, c = e % Tl::kCopies;
      const int pj = __shfl_sync(kFull, phys, j);
      const int idx = tile * kTile + j;
      const bool ok = idx >= kbeg && idx < kend;
      const size_t off =
          ok ? (((size_t)pj * a.psz + idx % a.psz) * a.KV + kv) * Tl::kRow +
                   c * Tl::kCopy
             : 0;
      const int so = j * Tl::kPitch + c * Tl::kCopy;
      cp_async<Tl::kCopy>(rtmma::smem_addr(kd + so), kbase + off, ok);
      cp_async<Tl::kCopy>(rtmma::smem_addr(vd + so), vbase + off, ok);
    }
    if (quant) {  // this lane's key's page scales (zeros outside the keys)
      const int idx = tile * kTile + lane;
      const bool ok = idx >= kbeg && idx < kend;
      float* const sc = reinterpret_cast<float*>(vd + Tl::kBytes);
      rtmma::cp_async_4(rtmma::smem_addr(sc + lane), a.k_scale + phys, ok);
      rtmma::cp_async_4(rtmma::smem_addr(sc + kTile + lane),
                        a.v_scale + phys, ok);
    }
  };

  float m[R], l[R], acc[R][NP][2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;  // this lane's keys only; summed across the warp at the end
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[r][i][0] = acc[r][i][1] = 0.f;
  }

  // the ring: tiles ti, ti + nw, ... of this warp, kStages - 1 in flight
  // while one is summed; the page of the next tile to issue is loaded one
  // tile ahead, so no dependent load waits in the loop
  int ti = tb + blockIdx.y * per + warp;
  int ph[kStages - 1];
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k)
    ph[k] = ti + k * nw < t_hi ? phys_of(ti + k * nw) : 0;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (ti + k * nw < t_hi) issue(ti + k * nw, k, ph[k]);
    rtmma::cp_async_commit();
  }
  int ph_next = ti + (kStages - 1) * nw < t_hi
                    ? phys_of(ti + (kStages - 1) * nw)
                    : 0;

  // the query rows, in fp32, while the first tiles are in flight
  float* const q_w = buf + warp * R * HD;
  for (int e = lane; e < R * HD; e += kWarp) {
    const int row = e / HD;
    float v = 0.f;
    if (row < a.G) {
      const size_t off = row_offset(a, b, kv, row, HD) + e % HD;
      v = a.q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(a.q)[off])
                   : static_cast<const float*>(a.q)[off];
    }
    q_w[e] = v;
  }

  for (int stage = 0; ti < t_hi; ti += nw, stage = (stage + 1) % kStages) {
    const int tn = ti + (kStages - 1) * nw;
    if (tn < t_hi) issue(tn, (stage + kStages - 1) % kStages, ph_next);
    rtmma::cp_async_commit();
    ph_next = tn + nw < t_hi ? phys_of(tn + nw) : 0;
    rtmma::cp_async_wait<kStages - 1>();
    __syncwarp();  // tile ti (and q) is in shared memory for every lane

    const char* const Kt = ring + stage * Tl::kStage;
    const T* const Vt = reinterpret_cast<const T*>(Kt + Tl::kBytes);
    const float* const sc =
        reinterpret_cast<const float*>(Kt + 2 * Tl::kBytes);
    const float ksc = quant ? sc[lane] : 1.f;
    const float vsc = quant ? sc[kTile + lane] : 1.f;
    const int idx = ti * kTile + lane;
    const bool valid = idx >= kbeg && idx < kend;

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const char* const krow = Kt + lane * Tl::kPitch;
#pragma unroll
    for (int c = 0; c < Tl::kCopies; ++c) {
      float kf[NC];
      copy_to_float<T, Tl::kCopy>(krow + c * Tl::kCopy, kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* qr = q_w + r * HD + c * NC;
#pragma unroll
        for (int j = 0; j < NC; ++j) s[r] = fmaf(qr[j], kf[j], s[r]);
      }
    }

    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool ok = valid && r < a.G;
      const float sc = ok ? s[r] * ksc * a.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float pe = ok ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + pe;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        acc[r][i][0] *= corr;
        acc[r][i][1] *= corr;
      }
      m[r] = m_new;
      p[r] = pe * vsc;
    }

#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const T* vrow = reinterpret_cast<const T*>(
          reinterpret_cast<const char*>(Vt) + j * Tl::kPitch);
      float2 vv[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int d = 64 * i + 2 * lane;
        vv[i] = d < HD ? pair_f(vrow + d) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          acc[r][i][0] = fmaf(pj, vv[i].x, acc[r][i][0]);
          acc[r][i][1] = fmaf(pj, vv[i].y, acc[r][i][1]);
        }
      }
    }
    __syncwarp();  // every lane is done with this stage before it refills
  }
  rtmma::cp_async_wait<0>();

  // Merge the warps' partial softmax states through shared memory.
  __syncthreads();  // every warp is done with its queries in buf
  float* const acc_w = buf + warp * R * HD;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float lw = warp_sum(l[r]);
    if (lane == 0) {
      m_s[warp * R + r] = m[r];
      l_s[warp * R + r] = lw;
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int d = 64 * i + 2 * lane;
      if (d < HD)
        *reinterpret_cast<float2*>(acc_w + r * HD + d) =
            make_float2(acc[r][i][0], acc[r][i][1]);
    }
  }
  __syncthreads();
  for (int r = warp; r < a.G; r += nw) {
    float M = kNegInf;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, m_s[w * R + r]);
    float L = 0.f, o[NP][2];
#pragma unroll
    for (int i = 0; i < NP; ++i) o[i][0] = o[i][1] = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float c = expf(m_s[w * R + r] - M);
      L += l_s[w * R + r] * c;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int d = 64 * i + 2 * lane;
        if (d < HD) {
          const float2 x =
              *reinterpret_cast<const float2*>(buf + (w * R + r) * HD + d);
          o[i][0] += x.x * c;
          o[i][1] += x.y * c;
        }
      }
    }
    if (a.nsplit == 1) {
      const float Lc = fmaxf(L, 1e-30f);
      float* const orow = a.out + row_offset(a, b, kv, r, HD);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int d = 64 * i + 2 * lane;
        if (d < HD)
          *reinterpret_cast<float2*>(orow + d) =
              make_float2(o[i][0] / Lc, o[i][1] / Lc);
      }
      if (lane == 0)
        a.lse[((size_t)b * a.KV + kv) * a.G + r] = M + logf(Lc);
    } else {
      float* const pp =
          a.part + (((size_t)blockIdx.x * a.nsplit + blockIdx.y) * a.G + r) *
                       (HD + 2);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int d = 64 * i + 2 * lane;
        if (d < HD)
          *reinterpret_cast<float2*>(pp + d) = make_float2(o[i][0], o[i][1]);
      }
      if (lane == 0) {
        pp[HD] = M;
        pp[HD + 1] = L;
      }
    }
  }
}

// The splits' partials (acc, m, l) of each (slot, kv head) merged in fp32
// into out and lse, as the warps are merged within a block.
__global__ void decode_merge_kernel(const PagedArgs a, int hd) {
  const int b = blockIdx.x / a.KV, kv = blockIdx.x % a.KV;
  const float* const p0 =
      a.part + (size_t)blockIdx.x * a.nsplit * a.G * (hd + 2);
  for (int e = threadIdx.x; e < a.G * hd; e += blockDim.x) {
    const int g = e / hd, d = e % hd;
    float M = kNegInf;
    for (int z = 0; z < a.nsplit; ++z)
      M = fmaxf(M, p0[(z * a.G + g) * (hd + 2) + hd]);
    float L = 0.f, o = 0.f;
    for (int z = 0; z < a.nsplit; ++z) {
      const float* pz = p0 + (z * a.G + g) * (hd + 2);
      const float c = expf(pz[hd] - M);
      L += pz[hd + 1] * c;
      o += pz[d] * c;
    }
    const float Lc = fmaxf(L, 1e-30f);
    a.out[row_offset(a, b, kv, g, hd) + d] = o / Lc;
    if (d == 0) a.lse[((size_t)b * a.KV + kv) * a.G + g] = M + logf(Lc);
  }
}

// 4 warps a block where their shared memory fits an SM, else 2.
template <typename T, int HD, int R>
cudaError_t decode_launch(const PagedArgs& a, dim3 grid, cudaStream_t st) {
  constexpr int nw = decode_smem<T, HD, R>(4) <= (size_t)kMaxSmem ? 4 : 2;
  static_assert(decode_smem<T, HD, R>(nw) <= (size_t)kMaxSmem,
                "two warps' rings fit an SM");
  return launch_smem<paged_decode_kernel<T, HD, R>>(
      grid, dim3(kWarp * nw), decode_smem<T, HD, R>(nw), a, st);
}

template <typename T, int HD>
cudaError_t decode_r(const PagedArgs& a, int R, dim3 grid, cudaStream_t st) {
  switch (R) {
    case 1: return decode_launch<T, HD, 1>(a, grid, st);
    case 2: return decode_launch<T, HD, 2>(a, grid, st);
    case 4: return decode_launch<T, HD, 4>(a, grid, st);
    case 8: return decode_launch<T, HD, 8>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t decode_hd(const PagedArgs& a, int hd, int R, dim3 grid,
                      cudaStream_t st) {
  switch (hd) {
    case 64: return decode_r<T, 64>(a, R, grid, st);
    case 120: return decode_r<T, 120>(a, R, grid, st);
    case 128: return decode_r<T, 128>(a, R, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rtk

// page_dtype: 0 fp32, 1 bf16, 2 int8 (with scales). nsplit comes from the
// wrapper; with nsplit > 1, part holds B * KV * nsplit * G * (hd + 2)
// floats.
extern "C" int rt_flash_decode(const void* q, int q_bf16, const void* k_pages,
                               const void* v_pages, const void* k_scale,
                               const void* v_scale, const void* page_table,
                               const void* lengths, void* out, void* lse,
                               void* part, int B, int KV, int G, int hd,
                               int npg, int psz, int window, float scale,
                               int page_dtype, int nsplit, void* stream) {
  int R = 1;
  while (R < G) R *= 2;
  if (R > 8 || nsplit < 1 ||
      (nsplit > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  rtk::PagedArgs a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.page_table = static_cast<const int*>(page_table);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.part = static_cast<float*>(part);
  a.nsplit = nsplit;
  a.q_bf16 = q_bf16;
  a.C = 1;
  a.KV = KV;
  a.G = G;
  a.npg = npg;
  a.psz = psz;
  a.window = window;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * KV, nsplit);
  cudaError_t e;
  switch (page_dtype) {
    case 0: e = rtk::decode_hd<float>(a, hd, R, grid, st); break;
    case 1:
      e = rtk::decode_hd<__nv_bfloat16>(a, hd, R, grid, st);
      break;
    case 2: e = rtk::decode_hd<int8_t>(a, hd, R, grid, st); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e == cudaSuccess && nsplit > 1) {
    rtk::decode_merge_kernel<<<B * KV, 128, 0, st>>>(a, hd);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}
