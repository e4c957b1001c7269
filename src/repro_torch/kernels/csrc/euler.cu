// Fused EDM Euler step, z' = a z + b F, and its backward, for sm_90a.
// Replaces the Pallas TPU kernels src/repro/kernels/fused_adaln.py:214
// (_euler_kernel) and :221 (_euler_bwd_kernel), called through fused_euler
// at :294.
//
// a = r + (1 - r) c_skip and b = (1 - r) c_out, with r = sigma_to / sigma,
// are per-example fp32 scalars the wrapper computes (the denoiser combine
// D = c_skip z + c_out F and the Euler step z' = r z + (1 - r) D folded into
// one pass; at sigma_to = 0 it is D itself).
//
// What bounds them: bytes. The forward reads z and F (B, S, d) once and
// writes z' once, 3 flops per element; the backward reads the cotangent g
// and writes dz = a g and dF = b g. One grid-stride pass; each thread takes
// 4 neighbouring elements (one 16-byte fp32 or 8-byte bf16 access per
// stream) where every row start is aligned to 4 elements, else 1 element
// (d or a row stride not a multiple of 4). z and F are read through row
// strides (batch and sequence), unit stride along d: the recurrent-depth
// sampler's F is the noisy half h[:, S:] of a (B, 2S, d) stream, read in
// place without a copy.
// The output and the backward's streams are contiguous. Math is fp32 with
// explicit round-to-nearest multiplies and adds (no fused multiply-add), the
// roundings of the plain PyTorch versions, so both agree bit for bit.
#include "rowwise.cuh"

namespace {

using rowwise::load_vec;
using rowwise::store1;
using rowwise::store_vec;
using rowwise::to_f;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

__device__ __forceinline__ float axpby(float a, float x, float b, float y) {
  return __fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y));
}

// n = B * S * (d / W) groups of W elements; group i is row i / (d / W) of
// the (B * S) rows, columns [c, c + W).
template <typename TZ, typename TF, int W>
__global__ void euler_kernel(const TZ* __restrict__ z,
                             const TF* __restrict__ f,
                             const float* __restrict__ a,
                             const float* __restrict__ b,
                             TZ* __restrict__ out, long long n, int S, int d,
                             long long z_sb, long long z_ss, long long f_sb,
                             long long f_ss) {
  const int dw = d / W;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / dw;
    const int c = static_cast<int>(i - row * dw) * W;
    const long long bi = row / S;
    const long long s = row - bi * S;
    const float ab = a[bi], bb = b[bi];
    const TZ* zp = z + bi * z_sb + s * z_ss + c;
    const TF* fp = f + bi * f_sb + s * f_ss + c;
    TZ* op = out + row * d + c;
    if constexpr (W == 4) {
      float zv[4], fv[4], o[4];
      load_vec<TZ, 4>(zp, zv);
      load_vec<TF, 4>(fp, fv);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = axpby(ab, zv[j], bb, fv[j]);
      store_vec<TZ, 4>(op, o);
    } else {
      store1(op, axpby(ab, to_f(*zp), bb, to_f(*fp)));
    }
  }
}

// g, dz, df contiguous (B, S, d) in one dtype.
template <typename TG, int W>
__global__ void euler_bwd_kernel(const TG* __restrict__ g,
                                 const float* __restrict__ a,
                                 const float* __restrict__ b,
                                 TG* __restrict__ dz, TG* __restrict__ df,
                                 long long n, int S, int d) {
  const int dw = d / W;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long bi = i / dw / S;
    const float ab = a[bi], bb = b[bi];
    const long long off = i * W;
    if constexpr (W == 4) {
      float gv[4], oz[4], of[4];
      load_vec<TG, 4>(g + off, gv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        oz[j] = __fmul_rn(ab, gv[j]);
        of[j] = __fmul_rn(bb, gv[j]);
      }
      store_vec<TG, 4>(dz + off, oz);
      store_vec<TG, 4>(df + off, of);
    } else {
      const float gv = to_f(g[off]);
      store1(dz + off, __fmul_rn(ab, gv));
      store1(df + off, __fmul_rn(bb, gv));
    }
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

template <typename TZ, typename TF>
void launch(const void* z, const void* f, const float* a, const float* b,
            void* out, int B, int S, int d, long long z_sb, long long z_ss,
            long long f_sb, long long f_ss, bool vec, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * S;
  if (vec) {
    const long long n = rows * (d / 4);
    euler_kernel<TZ, TF, 4><<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const TZ*>(z), static_cast<const TF*>(f), a, b,
        static_cast<TZ*>(out), n, S, d, z_sb, z_ss, f_sb, f_ss);
  } else {
    const long long n = rows * d;
    euler_kernel<TZ, TF, 1><<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const TZ*>(z), static_cast<const TF*>(f), a, b,
        static_cast<TZ*>(out), n, S, d, z_sb, z_ss, f_sb, f_ss);
  }
}

template <typename TG>
void launch_bwd(const void* g, const float* a, const float* b, void* dz,
                void* df, int B, int S, int d, bool vec, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * S;
  if (vec) {
    const long long n = rows * (d / 4);
    euler_bwd_kernel<TG, 4><<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const TG*>(g), a, b, static_cast<TG*>(dz),
        static_cast<TG*>(df), n, S, d);
  } else {
    const long long n = rows * d;
    euler_bwd_kernel<TG, 1><<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const TG*>(g), a, b, static_cast<TG*>(dz),
        static_cast<TG*>(df), n, S, d);
  }
}

}  // namespace

// z (B, S, d) with row strides (z_sb, z_ss), f likewise, both unit stride
// along d; a, b (B,) fp32; out contiguous (B, S, d) in z's dtype. Dtypes:
// 0 fp32, 1 bf16; (z, f) is (fp32, fp32), (fp32, bf16) or (bf16, bf16). vec != 0 takes 4 elements a thread: d, the strides and
// every base pointer must then be multiples of 4 elements (the caller
// checks the pointers' alignment).
extern "C" int rt_euler_fwd(const void* z, const void* f, const void* a,
                            const void* b, void* out, int B, int S, int d,
                            long long z_sb, long long z_ss, long long f_sb,
                            long long f_ss, int z_dtype, int f_dtype, int vec,
                            void* stream) {
  if (B < 1 || S < 1 || d < 1 || (vec && (d % 4 || z_sb % 4 || z_ss % 4 ||
                                          f_sb % 4 || f_ss % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  switch (z_dtype * 2 + f_dtype) {
    case 0: launch<float, float>(z, f, af, bf, out, B, S, d, z_sb, z_ss, f_sb, f_ss, vec, st); break;
    case 1: launch<float, __nv_bfloat16>(z, f, af, bf, out, B, S, d, z_sb, z_ss, f_sb, f_ss, vec, st); break;
    case 3: launch<__nv_bfloat16, __nv_bfloat16>(z, f, af, bf, out, B, S, d, z_sb, z_ss, f_sb, f_ss, vec, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g, dz, df contiguous (B, S, d) in g_dtype; a, b (B,) fp32.
extern "C" int rt_euler_bwd(const void* g, const void* a, const void* b,
                            void* dz, void* df, int B, int S, int d,
                            int g_dtype, int vec, void* stream) {
  if (B < 1 || S < 1 || d < 1 || (vec && d % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  switch (g_dtype) {
    case 0: launch_bwd<float>(g, af, bf, dz, df, B, S, d, vec, st); break;
    case 1: launch_bwd<__nv_bfloat16>(g, af, bf, dz, df, B, S, d, vec, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
