// Paged attention for Hopper (sm_90a): what flash_decode.cu and
// flash_prefill.cu share, and the CUDA-core kernel of prefill's fp32 route.
//
// Replaces the Pallas TPU kernels src/repro/kernels/flash_decode.py
// (_decode_kernel) and src/repro/kernels/flash_prefill.py (_prefill_kernel).
// Those walk a (slot, kv_head, page) grid whose page axis runs in order on
// one core, carrying the online-softmax state (m, l, acc) in VMEM scratch.
// Here a thread block owns one (slot, kv_head) pair (and a tile of query
// rows, or a share of the keys); the page axis becomes a loop inside the
// block. Three kernels:
//   * paged_decode_kernel (flash_decode.cu): every page dtype, CUDA cores,
//     K/V tiles staged in shared memory by cp.async;
//   * prefill_tc_kernel (flash_prefill.cu): bf16 q over bf16 or int8 pages,
//     on the tensor cores (mma.sync);
//   * paged_attention_kernel (below): fp32 q or fp32 pages in prefill (the
//     fp32 and fp32_kvint8 policies), CUDA cores, reading K and V straight
//     from device memory; the kernel both paged wrappers ran before the
//     two above.
//
// Common to all three: the block loops only over keys some of its rows can
// see, [max(0, q_first - window + 1), min(q_last + incl, n_pages * psz)), so
// no page past lengths[b] (decode) or lengths[b] + C - 1 (prefill) is read;
// masks are finite (-1e30) and the normaliser is max(l, 1e-30), so an empty
// slot gives out = 0 and lse ~ -1e30, as the TPU kernel does, and rows past
// a chunk's valid tokens stay finite; q is read as it is, G or C*G rows with
// no padded copy (the TPU kernel padded them to 8 sublanes).
//
// paged_attention_kernel: lane j of a warp owns key j of a 32-key tile: it
// reads its own page table entry, streams its K row (16-byte loads,
// dequantized in registers, int8 pages times their page's fp32 scale) and
// dots it with the warp's query rows, which sit in shared memory in fp32.
// The tile's max and sum are warp shuffles; the P.V product reads each V row
// once per warp with lanes on neighbouring dims and broadcasts p_j with a
// shuffle, so one warp covers R query rows per pass. The warps along the key
// axis take interleaved tiles and merge their (m, l, acc) through shared
// memory at the end; the warps along the row axis take disjoint rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <atomic>

#include "mma.cuh"

namespace rtk {

constexpr float kNegInf = -1e30f;
constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kTile = kWarp;  // keys per warp pass: one per lane
constexpr unsigned kFull = 0xffffffffu;

// Eight consecutive page elements as fp32 (rows are multiples of 8 elements,
// so the loads are 16 bytes for bf16, 32 for fp32 and 8 for int8).
template <typename T>
struct PageLoad;

template <>
struct PageLoad<float> {
  static __device__ __forceinline__ void load8(const float* p, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
};

template <>
struct PageLoad<__nv_bfloat16> {
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                               float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <>
struct PageLoad<int8_t> {
  static __device__ __forceinline__ void load8(const int8_t* p, float* o) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);
  }
  static __device__ __forceinline__ float load1(const int8_t* p) {
    return static_cast<float>(*p);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct PagedArgs {
  const void* q;          // (B, C, KV, G, HD) fp32 or bf16; decode: C = 1
  const void* k_pages;    // (P, psz, KV, HD)
  const void* v_pages;
  const float* k_scale;   // (P,) per-page scales of an int8 pool, else null
  const float* v_scale;
  const int* page_table;  // (B, npg)
  const int* lengths;     // (B,) committed tokens before this step
  float* out;             // like q, fp32
  float* lse;             // (B, KV, G) fp32, decode only
  float* part;            // decode split across blocks: per (slot, kv head,
                          // split, row) acc[HD], m, l; else null
  int nsplit;             // decode: blocks per (slot, kv head)
  int q_bf16;
  int C, KV, G, npg, psz;
  int window;             // <= 0: no sliding window
  float scale;            // 1 / sqrt(HD)
  int nrg;                // warps along the row axis; the rest split keys
};

// Row r = i*G + g of slot b is query token i, group member g.
__device__ __forceinline__ size_t row_offset(const PagedArgs& a, int b,
                                             int kv, int row, int hd) {
  return ((((size_t)b * a.C + row / a.G) * a.KV + kv) * a.G + row % a.G) *
         (size_t)hd;
}

// Row r of slot b sits at lengths[b] + r/G and sees idx <= its position
// (the chunk's own k/v are already in the pool), and idx > position - window
// when windowed.
template <typename T, int HD, int R>
__global__ void __launch_bounds__(kWarp* kMaxWarps)
    paged_attention_kernel(const PagedArgs a) {
  constexpr int NI = (HD + kWarp - 1) / kWarp;  // dims per lane
  __shared__ float buf[kMaxWarps * R * HD];     // queries, then partial accs
  __shared__ float m_s[kMaxWarps * R];
  __shared__ float l_s[kMaxWarps * R];

  const int b = blockIdx.x / a.KV;
  const int kv = blockIdx.x % a.KV;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int ksplit = (blockDim.x / kWarp) / a.nrg;
  const int rg = warp % a.nrg;
  const int ks = warp / a.nrg;
  const int rows_total = a.C * a.G;
  const int rows_block = R * a.nrg;
  const int rb0 = blockIdx.y * rows_block;
  const int r0 = rb0 + rg * R;
  const int length = a.lengths[b];
  const int n_keys = a.npg * a.psz;

  float* q_w = buf + warp * R * HD;
  for (int e = lane; e < R * HD; e += kWarp) {
    const int row = r0 + e / HD;
    float v = 0.f;
    if (row < rows_total) {
      const size_t off = row_offset(a, b, kv, row, HD) + e % HD;
      v = a.q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(a.q)[off])
                   : static_cast<const float*>(a.q)[off];
    }
    q_w[e] = v;
  }
  __syncwarp();

  const int last_row = min(rb0 + rows_block, rows_total) - 1;
  const int q_first = length + rb0 / a.G;
  const int q_last = length + last_row / a.G;
  const int kend = min(q_last + 1, n_keys);
  const int kbeg = a.window > 0 ? max(0, q_first - a.window + 1) : 0;

  float m[R], l[R], acc[R][NI];
  int qpos[R];
  bool row_ok[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
    row_ok[r] = r0 + r < rows_total;
    qpos[r] = length + (r0 + r) / a.G;
  }

  for (int t0 = (kbeg / kTile) * kTile + ks * kTile; t0 < kend;
       t0 += kTile * ksplit) {
    const int idx = t0 + lane;
    const bool in_range = idx < kend;
    int phys = 0;
    float ksc = 1.f, vsc = 1.f;
    if (in_range) {
      phys = a.page_table[(size_t)b * a.npg + idx / a.psz];
      if (a.k_scale != nullptr) {
        ksc = a.k_scale[phys];
        vsc = a.v_scale[phys];
      }
    }

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    if (in_range) {
      const T* kp = static_cast<const T*>(a.k_pages) +
                    (((size_t)phys * a.psz + idx % a.psz) * a.KV + kv) * HD;
#pragma unroll 4
      for (int d0 = 0; d0 < HD; d0 += 8) {
        float kf[8];
        PageLoad<T>::load8(kp + d0, kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float* qr = q_w + r * HD + d0;
#pragma unroll
          for (int j = 0; j < 8; ++j) s[r] = fmaf(qr[j], kf[j], s[r]);
        }
      }
    }

    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bool valid = in_range && row_ok[r] && idx <= qpos[r];
      if (a.window > 0) valid = valid && idx > qpos[r] - a.window;
      const float sc = valid ? s[r] * ksc * a.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float pe = valid ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(pe);
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= corr;
      m[r] = m_new;
      p[r] = pe;
    }

    const int nk = min(kTile, kend - t0);
    for (int j = 0; j < nk; ++j) {
      const int physj = __shfl_sync(kFull, phys, j);
      const float vscj = __shfl_sync(kFull, vsc, j);
      const int idxj = t0 + j;
      const T* vp = static_cast<const T*>(a.v_pages) +
                    (((size_t)physj * a.psz + idxj % a.psz) * a.KV + kv) * HD;
      float vv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + kWarp * i;
        vv[i] = d < HD ? PageLoad<T>::load1(vp + d) * vscj : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

  // Merge the key-split warps' partial softmax states.
  __syncthreads();  // every warp is done with its queries in buf
  float* acc_w = buf + warp * R * HD;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      m_s[warp * R + r] = m[r];
      l_s[warp * R + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + kWarp * i;
      if (d < HD) acc_w[r * HD + d] = acc[r][i];
    }
  }
  __syncthreads();
  if (ks != 0) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r;
    if (row >= rows_total) continue;
    float M = kNegInf;
    for (int k = 0; k < ksplit; ++k)
      M = fmaxf(M, m_s[(rg + k * a.nrg) * R + r]);
    float L = 0.f, o[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) o[i] = 0.f;
    for (int k = 0; k < ksplit; ++k) {
      const int w2 = rg + k * a.nrg;
      const float c = expf(m_s[w2 * R + r] - M);
      L += l_s[w2 * R + r] * c;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + kWarp * i;
        if (d < HD) o[i] += buf[(w2 * R + r) * HD + d] * c;
      }
    }
    const float Lc = fmaxf(L, 1e-30f);
    const size_t off = row_offset(a, b, kv, row, HD);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + kWarp * i;
      if (d < HD) a.out[off + d] = o[i] / Lc;
    }
  }
}

// Launch KERNEL with `smem` bytes of dynamic shared memory on the current
// device. The attribute that allows more than 48 KB is a property of the
// function on one device, so it is set once per (instantiation, device):
// `allowed[dev]` keeps the largest size granted there, and later launches,
// CUDA-graph captures included, make no other runtime call than
// cudaGetDevice.
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

template <void (*KERNEL)(const PagedArgs)>
cudaError_t launch_smem(dim3 grid, dim3 block, size_t smem,
                        const PagedArgs& a, cudaStream_t st) {
  static std::atomic<int> allowed[kMaxDevices];
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev].load() < (int)smem) {
    err = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev].store((int)smem);
  }
  KERNEL<<<grid, block, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace rtk
