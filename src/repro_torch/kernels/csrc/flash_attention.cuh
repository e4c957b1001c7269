// Flash attention for Hopper (sm_90a): what flash_attention_fwd.cu and
// flash_attention_bwd.cu share.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
// _fwd_kernel (:101), _bwd_dq_kernel (:195) and _bwd_dkv_kernel (:228).
// Those walk a (B, H, q-tile, k-tile) grid whose last axis runs in order on
// one core, carrying (m, l, acc) or the dq / dk, dv sums in VMEM scratch,
// and visit every tile, masking inside it. Here one thread block owns one
// 64-row tile of one (batch, head) pair and loops over the other axis
// itself; tiles the mask leaves empty are skipped by the loop bounds check
// (tile_visible), and the exact mask is applied inside the tiles kept.
//
// Layout. Tensors are read in place through strides: (batch, head, seq)
// strides in elements with the head dim contiguous, so the (B, S, H, hd)
// tensors of the model are passed as (B, H, S, hd) views with no transpose
// copy. lse and delta are (B, H, Sq) fp32, contiguous.
//
// What bounds it. At the training shapes (S = 512-1024, hd = 64) attention
// does about 2*S*hd/(bytes per row) flops per byte, above the ridge of the
// tensor cores' rate in bf16 and far above the CUDA cores' in fp32. So all
// six kernels run on the tensor cores with mma.sync (mma.cuh): in bf16
// fwd_tc_kernel (flash_attention_fwd.cu), dq_tc_kernel and dkv_tc_kernel
// (flash_attention_bwd.cu) on m16n8k16; in fp32 fwd_tf32_kernel,
// dq_tf32_kernel and dkv_tf32_kernel on m16n8k8 tf32, at fp32 accuracy by
// splitting each operand into two tf32 terms and taking each product three
// times (3xTF32). Each block of 4 warps owns one 64-row tile.
//
// Edges. Masks are finite (-1e30) and the normaliser is max(l, 1e-30), so a
// row that sees no key ends with out = 0 and lse ~ -1e30, as the TPU kernel
// does; the backward computes P only where the mask admits the pair, so such
// rows get zero gradients, never NaN.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <atomic>

#include "mma.cuh"

namespace rtfa {

constexpr float kNegInf = -1e30f;
constexpr int kB = 64;         // rows of a q tile and of a k tile
constexpr unsigned kFull = 0xffffffffu;

enum MaskKind { kFullMask = 0, kCausal = 1, kWindow = 2, kDbConcat = 3,
                kTwoPass = 4 };

// One tensor: base pointer and (batch, head, seq) strides in elements.
struct TRef {
  void* p;
  long long sb, sh, ss;
};

struct FlashArgs {
  TRef q, k, v, o, dout, dq, dk, dv;
  float* lse;    // (B, H, Sq): written by the forward, read by the backward
  float* delta;  // (B, H, Sq): rowsum(dO * O), read by the backward
  int B, H, KV, Sq, Sk, hd;
  int mask_kind, window, mask_seq;
  int bf16;      // every q/k/v/o/dO/dq/dk/dv tensor is bf16, else fp32
  float scale;
};

// The keys that the keep-mask of _tile_mask (flash_attention.py:68) admits
// for row qp, as an interval [lo, hi) and one more key x (-1: none), all
// inside [0, Sk): the mask with a few integer compares a pair.
__device__ __forceinline__ void row_keys(const FlashArgs& a, int qp, int& lo,
                                         int& hi, int& x) {
  lo = 0;
  hi = 0;
  x = -1;
  if (qp >= a.Sq) return;
  const int S = a.mask_seq;
  switch (a.mask_kind) {
    case kCausal: hi = qp + 1; break;
    case kWindow: lo = max(0, qp - a.window + 1); hi = qp + 1; break;
    case kDbConcat:
      if (qp < S) {
        hi = qp + 1;                 // clean <- clean past
      } else {
        hi = min(qp - S, S);         // noisy <- clean strictly before
        x = qp;                      // and itself
      }
      break;
    case kTwoPass: hi = min(S, qp); x = qp + S; break;
    default: hi = a.Sk;
  }
  hi = min(hi, a.Sk);
  if (x >= a.Sk) x = -1;
}

// The queries that the mask admits for key kp, as two intervals [lo1, hi1)
// and [lo2, hi2) inside [0, Sq) (empty: lo >= hi): row_keys() seen from the
// key side, for the dk/dv kernel, whose rows are keys.
__device__ __forceinline__ void key_queries(const FlashArgs& a, int kp,
                                            int& lo1, int& hi1, int& lo2,
                                            int& hi2) {
  lo1 = hi1 = lo2 = hi2 = 0;
  if (kp >= a.Sk) return;
  const int S = a.mask_seq;
  hi1 = a.Sq;
  switch (a.mask_kind) {
    case kCausal: lo1 = kp; break;
    case kWindow: lo1 = kp; hi1 = kp + a.window; break;
    case kDbConcat:
      lo1 = kp;
      if (kp < S) {
        hi1 = S;                     // clean queries at or after it
        lo2 = kp + S + 1;            // noisy queries strictly after it
        hi2 = a.Sq;
      } else {
        hi1 = kp + 1;                // a noisy key: its own query
      }
      break;
    case kTwoPass:
      if (kp < S) {
        lo1 = kp + 1;                // clean key: later queries
      } else {
        lo1 = kp - S;                // diagonal key: its one query
        hi1 = kp - S + 1;
      }
      break;
    default: break;
  }
  hi1 = min(hi1, a.Sq);
  hi2 = min(hi2, a.Sq);
}

// Whether the tile [q0, q0 + 64) x [k0, k0 + 64) holds any kept pair: a
// conservative test, exact enough that the skipped tiles hold none.
__device__ __forceinline__ bool tile_visible(const FlashArgs& a, int q0,
                                             int k0) {
  const int q1 = min(q0 + kB, a.Sq) - 1;
  const int k1 = min(k0 + kB, a.Sk) - 1;
  if (q0 > q1 || k0 > k1) return false;
  switch (a.mask_kind) {
    case kCausal: return k0 <= q1;
    case kWindow: return k0 <= q1 && k1 > q0 - a.window;
    case kDbConcat: {
      const int S = a.mask_seq;
      const bool clean = q0 < S && k0 < S && k0 <= min(q1, S - 1);
      const bool noisy_clean = q1 >= S && k0 < S && k0 < q1 - S;
      const bool self = max(max(q0, k0), S) <= min(q1, k1);
      return clean || noisy_clean || self;
    }
    case kTwoPass: {
      const int S = a.mask_seq;
      return (k0 < S && k0 < q1) || max(q0 + S, k0) <= min(q1 + S, k1);
    }
    default: return true;
  }
}

// Whether the mask keeps every pair of the tile [q0, q0 + 64) x
// [k0, k0 + 64), so that the tensor-core forward skips masking it: both
// ranges lie inside the sequences and the worst corner is kept.
__device__ __forceinline__ bool tile_full(const FlashArgs& a, int q0,
                                          int k0) {
  const int q1 = q0 + kB - 1, k1 = k0 + kB - 1;
  if (q1 >= a.Sq || k1 >= a.Sk) return false;
  switch (a.mask_kind) {
    case kCausal: return k1 <= q0;
    case kWindow: return k1 <= q0 && k0 > q1 - a.window;
    case kDbConcat: {
      const int S = a.mask_seq;
      return (q1 < S && k1 <= q0) || (q0 >= S && k1 < S && k1 < q0 - S);
    }
    case kTwoPass: return k1 < a.mask_seq && k1 < q0;
    default: return true;
  }
}

// The tensor-core kernels (fwd_tc_kernel, dq_tc_kernel, dkv_tc_kernel):
// 4 warps, each owning 16 rows of a 64-row tile.
constexpr int kTcThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Start the cp.async copies of rows [r0, r0 + 64) of (b, h) of the bf16
// tensor t into the swizzled tile dst; rows at or past n are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const TRef& t, int b, int h,
                                                int r0, int n) {
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(t.p) +
                              (long long)b * t.sb + (long long)h * t.sh;
#pragma unroll
  for (int i = 0; i < kB * CH / kTcThreads; ++i) {
    const int e = threadIdx.x + i * kTcThreads;
    const int r = e / CH, c = e % CH;
    const bool ok = r0 + r < n;
    const __nv_bfloat16* src =
        ok ? base + (long long)(r0 + r) * t.ss + c * 8 : base;
    rtmma::cp_async_16(rtmma::smem_addr(dst + rtmma::swizzle<CH>(r, c)), src,
                       ok);
  }
}

// Start the cp.async copies of rows [r0, r0 + 64) of (b, h) of the fp32
// tensor t into the tile dst, PITCH floats a row; rows at or past n are
// zero-filled. V16: 16-byte chunks (t's base 16-byte aligned, its strides
// multiples of 4 floats); else one float a copy.
template <int HD, int PITCH, bool V16>
__device__ __forceinline__ void load_tile_async(float* dst, const TRef& t,
                                                int b, int h, int r0, int n) {
  constexpr int W = V16 ? 4 : 1;  // floats a copy
  constexpr int CH = HD / W;      // copies a row
  const float* base = static_cast<const float*>(t.p) + (long long)b * t.sb +
                      (long long)h * t.sh;
#pragma unroll
  for (int i = 0; i < kB * CH / kTcThreads; ++i) {
    const int e = threadIdx.x + i * kTcThreads;
    const int r = e / CH, c = (e % CH) * W;
    const bool ok = r0 + r < n;
    const float* src = ok ? base + (long long)(r0 + r) * t.ss + c : base;
    const uint32_t to = rtmma::smem_addr(dst + r * PITCH + c);
    if constexpr (V16)
      rtmma::cp_async_16(to, src, ok);
    else
      rtmma::cp_async_4(to, src, ok);
  }
}

// The first key tile at or after k0 that tile_visible admits for the query
// tile q0 (>= a.Sk: none).
__device__ __forceinline__ int next_visible(const FlashArgs& a, int q0,
                                            int k0) {
  while (k0 < a.Sk && !tile_visible(a, q0, k0)) k0 += kB;
  return k0;
}

// Whether the fp32 kernels can copy t in 16-byte chunks: a 16-byte aligned
// base and batch, head and sequence strides that are multiples of 4 floats.
inline bool copies16(const TRef& t) {
  return reinterpret_cast<uintptr_t>(t.p) % 16 == 0 && t.sb % 4 == 0 &&
         t.sh % 4 == 0 && t.ss % 4 == 0;
}

// The m16n8k8 tf32 A fragment of one k8 step from fp32 rows at p (row g,
// dims 2t and 2t + 1 of the step, as k-indices t and t + 4) and p + 8 rows,
// split into big and small.
template <int PITCH>
__device__ __forceinline__ void q_frag_tf32(const float* p, uint32_t (&big)[4],
                                            uint32_t (&small)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * PITCH);
  rtmma::split_tf32(x0.x, big[0], small[0]);  // (g, k t)
  rtmma::split_tf32(x1.x, big[1], small[1]);  // (g + 8, k t)
  rtmma::split_tf32(x0.y, big[2], small[2]);  // (g, k t + 4)
  rtmma::split_tf32(x1.y, big[3], small[3]);  // (g + 8, k t + 4)
}

// Launch KERNEL with THREADS threads a block and `smem` bytes of dynamic
// shared memory on the current device. The attribute that allows more than
// 48 KB is a property of the function on one device, so it is set once per
// (instantiation, device):
// `allowed[dev]` keeps the largest size granted there, and later launches,
// CUDA-graph captures included, make no other runtime call than
// cudaGetDevice.
constexpr int kMaxDevices = 64;

template <void (*KERNEL)(const FlashArgs), int THREADS>
cudaError_t launch(dim3 grid, size_t smem, const FlashArgs& a,
                   cudaStream_t st) {
  static std::atomic<int> allowed[kMaxDevices];
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
  KERNEL<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace rtfa
