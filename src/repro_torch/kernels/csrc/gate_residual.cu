// Gated residual, out = res + branch * (1 + gate), for sm_90a. Replaces the
// forward Pallas TPU kernel src/repro/kernels/fused_adaln.py:137
// (_gate_res_kernel, called through fused_gate_residual at :203).
//
// What bounds it: bytes. It reads res and branch (B, S, d), reads the
// per-example gate (B, d), writes out (B, S, d), and does 2 flops per
// element. The TPU kernel tiled rows into VMEM; here a grid-stride loop
// gives each thread 4 neighbouring elements (one 16-byte fp32 or 8-byte
// bf16 load per stream), so every warp access is coalesced. The gate is read
// through a row stride, so a column slice of the AdaLN head's (B, 6d)
// output needs no copy. Math is fp32 with explicit round-to-nearest adds
// and multiplies (no fused multiply-add), the same two roundings as the
// plain PyTorch version; the output is written in res's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T, typename TG>
__global__ void gate_residual_kernel(const T* __restrict__ res,
                                     const T* __restrict__ branch,
                                     const TG* __restrict__ gate,
                                     T* __restrict__ out, long long n4,
                                     int S, int d4, long long gate_stride) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / d4;  // over B*S
    const int c = static_cast<int>(i - row * d4) * 4;
    const TG* g = gate + (row / S) * gate_stride + c;
    float r[4], x[4], o[4];
    Vec4<T>::load(res + i * 4, r);
    Vec4<T>::load(branch + i * 4, x);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = __fadd_rn(r[j], __fmul_rn(x[j], __fadd_rn(1.f, to_f(g[j]))));
    Vec4<T>::store(out + i * 4, o);
  }
}

template <typename T, typename TG>
void launch(const void* res, const void* branch, const void* gate, void* out,
            long long n4, int S, int d4, long long gate_stride,
            cudaStream_t st) {
  const int threads = 256;
  long long blocks = (n4 + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  gate_residual_kernel<T, TG><<<static_cast<int>(blocks), threads, 0, st>>>(
      static_cast<const T*>(res), static_cast<const T*>(branch),
      static_cast<const TG*>(gate), static_cast<T*>(out), n4, S, d4,
      gate_stride);
}

}  // namespace

// x_dtype / gate_dtype: 0 fp32, 1 bf16. rows = B*S; d % 4 == 0.
extern "C" int rt_gate_residual(const void* res, const void* branch,
                                const void* gate, void* out, long long rows,
                                int S, int d, long long gate_stride,
                                int x_dtype, int gate_dtype, void* stream) {
  if (d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = rows * (d / 4);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d4 = d / 4;
  switch (x_dtype * 2 + gate_dtype) {
    case 0: launch<float, float>(res, branch, gate, out, n4, S, d4, gate_stride, st); break;
    case 1: launch<float, __nv_bfloat16>(res, branch, gate, out, n4, S, d4, gate_stride, st); break;
    case 2: launch<__nv_bfloat16, float>(res, branch, gate, out, n4, S, d4, gate_stride, st); break;
    case 3: launch<__nv_bfloat16, __nv_bfloat16>(res, branch, gate, out, n4, S, d4, gate_stride, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
