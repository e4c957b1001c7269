// Paged attention for Hopper (sm_90a): what flash_decode.cu and
// flash_prefill.cu share.
//
// Replaces the Pallas TPU kernels src/repro/kernels/flash_decode.py
// (_decode_kernel) and src/repro/kernels/flash_prefill.py (_prefill_kernel).
// Those walk a (slot, kv_head, page) grid whose page axis runs in order on
// one core, carrying the online-softmax state (m, l, acc) in VMEM scratch.
// Here a thread block owns one (slot, kv_head) pair (and a tile of query
// rows, or a share of the keys); the page axis becomes a loop inside the
// block. Two kernels:
//   * paged_decode_kernel (flash_decode.cu): every page dtype, CUDA cores,
//     K/V tiles staged in shared memory by cp.async;
//   * prefill_tc_kernel and prefill_tf32_kernel (flash_prefill.cu): the
//     chunked prefill on the tensor cores, bf16 q over bf16 or int8 pages
//     by mma.sync m16n8k16, and fp32 q or fp32 pages (the fp32 and
//     fp32_kvint8 policies) by 3xTF32 m16n8k8.
//
// Common to both: the block loops only over keys some of its rows can
// see, [max(0, q_first - window + 1), min(q_last + incl, n_pages * psz)), so
// no page past lengths[b] (decode) or lengths[b] + C - 1 (prefill) is read;
// masks are finite (-1e30) and the normaliser is max(l, 1e-30), so an empty
// slot gives out = 0 and lse ~ -1e30, as the TPU kernel does, and rows past
// a chunk's valid tokens stay finite; q is read as it is, G or C*G rows with
// no padded copy (the TPU kernel padded them to 8 sublanes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <atomic>

#include "mma.cuh"

namespace rtk {

constexpr float kNegInf = -1e30f;
constexpr int kWarp = 32;
constexpr int kTile = kWarp;  // keys per warp pass: one per lane
constexpr unsigned kFull = 0xffffffffu;

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
};

// Row r = i*G + g of slot b is query token i, group member g.
__device__ __forceinline__ size_t row_offset(const PagedArgs& a, int b,
                                             int kv, int row, int hd) {
  return ((((size_t)b * a.C + row / a.G) * a.KV + kv) * a.G + row % a.G) *
         (size_t)hd;
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
