// Gated residual, out = res + branch * (1 + gate), and its backward, for
// sm_90a. Replaces the Pallas TPU kernels src/repro/kernels/fused_adaln.py:137
// (_gate_res_kernel) and :143 (_gate_res_bwd_kernel), called through
// fused_gate_residual at :203.
//
// What bounds them: bytes. The forward reads res and branch (B, S, d),
// reads the per-example gate (B, d), writes out (B, S, d), and does 2 flops
// per element; the backward reads the cotangent g and branch, writes
// d_branch = g * (1 + gate) and per-tile sums of g * branch for d_gate. The
// TPU kernels tiled rows into VMEM; here each thread takes 4 neighbouring
// elements (one 16-byte fp32 or 8-byte bf16 load per stream), so every warp
// access is coalesced. The gate is read through a row stride, so a column
// slice of the AdaLN head's (B, 6d) output needs no copy. Elementwise math
// is fp32 with explicit round-to-nearest adds and multiplies (no fused
// multiply-add), the same roundings as the plain PyTorch versions; outputs
// are written in the streams' dtype.
//
// The backward's d_gate is a sum over the rows of one example. A block owns
// one tile of tile_rows rows of one example and loops over them per column,
// so no tile crosses examples and no atomics are needed: it writes its fp32
// column sums to partials[b, tile, :], and the caller sums the tiles (the
// TPU kernel's (B, n_tiles, d) partials, summed outside it).
#include "rowwise.cuh"

namespace {

using rowwise::to_f;
using rowwise::Vec4;

constexpr int kThreads = 256;

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

// grid (n_tiles, B): block (tile, b) owns rows [tile*tile_rows, ...) of
// example b; each thread owns column quads and walks the tile's rows.
template <typename T, typename TG>
__global__ void gate_residual_bwd_kernel(const T* __restrict__ branch,
                                         const TG* __restrict__ gate,
                                         const T* __restrict__ g,
                                         T* __restrict__ dbranch,
                                         float* __restrict__ dgate_part,
                                         int S, int d, long long gate_stride,
                                         int tile_rows, int n_tiles) {
  const int tile = blockIdx.x, b = blockIdx.y;
  const int row0 = tile * tile_rows;
  const int nrows = min(tile_rows, S - row0);
  const TG* gt = gate + b * gate_stride;
  const long long base = (static_cast<long long>(b) * S + row0) * d;
  float* part = dgate_part + (static_cast<long long>(b) * n_tiles + tile) * d;
  for (int c = threadIdx.x * 4; c < d; c += blockDim.x * 4) {
    float g1[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) g1[j] = __fadd_rn(1.f, to_f(gt[c + j]));
    for (int r = 0; r < nrows; ++r) {
      const long long off = base + static_cast<long long>(r) * d + c;
      float gv[4], bv[4], o[4];
      Vec4<T>::load(g + off, gv);
      Vec4<T>::load(branch + off, bv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = __fmul_rn(gv[j], g1[j]);
        acc[j] = fmaf(gv[j], bv[j], acc[j]);
      }
      Vec4<T>::store(dbranch + off, o);
    }
    Vec4<float>::store(part + c, acc);
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

template <typename T, typename TG>
void launch_bwd(const void* branch, const void* gate, const void* g,
                void* dbranch, float* part, int B, int S, int d,
                long long gate_stride, int tile_rows, cudaStream_t st) {
  const int n_tiles = (S + tile_rows - 1) / tile_rows;
  gate_residual_bwd_kernel<T, TG><<<dim3(n_tiles, B), kThreads, 0, st>>>(
      static_cast<const T*>(branch), static_cast<const TG*>(gate),
      static_cast<const T*>(g), static_cast<T*>(dbranch), part, S, d,
      gate_stride, tile_rows, n_tiles);
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

// branch, g, dbranch: (B, S, d) in x_dtype; gate (B, d) with row stride
// gate_stride; dgate_part (B, ceil(S / tile_rows), d) fp32. d % 4 == 0.
extern "C" int rt_gate_residual_bwd(const void* branch, const void* gate,
                                    const void* g, void* dbranch,
                                    void* dgate_part, int B, int S, int d,
                                    long long gate_stride, int tile_rows,
                                    int x_dtype, int gate_dtype,
                                    void* stream) {
  if (d % 4 != 0 || B < 1 || S < 1 || tile_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dgate_part);
  switch (x_dtype * 2 + gate_dtype) {
    case 0: launch_bwd<float, float>(branch, gate, g, dbranch, part, B, S, d, gate_stride, tile_rows, st); break;
    case 1: launch_bwd<float, __nv_bfloat16>(branch, gate, g, dbranch, part, B, S, d, gate_stride, tile_rows, st); break;
    case 2: launch_bwd<__nv_bfloat16, float>(branch, gate, g, dbranch, part, B, S, d, gate_stride, tile_rows, st); break;
    case 3: launch_bwd<__nv_bfloat16, __nv_bfloat16>(branch, gate, g, dbranch, part, B, S, d, gate_stride, tile_rows, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
