// Helpers shared by the row-wise elementwise kernels (gate_residual.cu,
// ln_modulate.cu, edm_loss.cu): fp32 widening, 4-wide vector loads and
// stores (one 16-byte fp32 or 8-byte bf16 access per thread, so a warp's
// access is coalesced), and warp / block sums in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rowwise {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block (blockDim.x a multiple of 32, at most 1024);
// the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    if (lane < static_cast<int>(blockDim.x >> 5)) v = part[lane];
    v = warp_sum(v);
  }
  return v;
}

}  // namespace rowwise
