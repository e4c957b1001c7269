// The EDM denoising loss in F-space (paper Eq. 6), sum over a tile of
// (f - (y - c_skip z) / c_out)^2, and its backward, for sm_90a. Replaces the
// Pallas TPU kernels src/repro/kernels/edm_loss.py:41 (_loss_kernel) and :58
// (_loss_bwd_kernel), called through edm_loss_partials / edm_loss.
//
// What bounds them: bytes. The forward reads f, z, y (B, S, d) fp32 once and
// writes a few partial sums; the backward reads them again with one
// cotangent per tile and writes df, dz, dy. The target (y - c_skip z) / c_out
// is formed in registers on both passes and never stored, as the TPU kernels
// formed it in VMEM. c_skip and c_out are per example (B,), made by the
// caller with the reference's rsqrt form.
//
// Forward: the loss's tiles are block_rows rows of one example (the TPU
// kernel's grid); a block owns sub_rows rows of one tile, sums its squared
// errors in fp32 (4 neighbouring elements per thread, then a block sum) and
// writes partials[b, tile, sub]; the caller sums the sub-tiles, so the
// result is the TPU kernel's (B, n_tiles) partials. Rows past S are never
// read (the TPU kernel zero-pads and masks them: they add exactly zero).
//
// Backward: df = 2 (f - t) g[b, tile], dz = (c_skip / c_out) df,
// dy = -df / c_out, elementwise over all B*S*d elements, with explicit
// round-to-nearest operations in the reference's order (target divided as
// written), so the outputs equal the plain PyTorch version's.
#include "rowwise.cuh"

namespace {

using rowwise::load_vec;
using rowwise::store_vec;

constexpr int kThreads = 256;

__device__ __forceinline__ float target(float y, float z, float cs,
                                        float co) {
  return __fdiv_rn(__fsub_rn(y, __fmul_rn(cs, z)), co);
}

// grid (n_sub, n_tiles, B); partials (B, n_tiles, n_sub) fp32.
__global__ void edm_loss_fwd_kernel(const float* __restrict__ f,
                                    const float* __restrict__ z,
                                    const float* __restrict__ y,
                                    const float* __restrict__ c_skip,
                                    const float* __restrict__ c_out,
                                    float* __restrict__ partials, int S,
                                    int d, int block_rows, int sub_rows) {
  const int sub = blockIdx.x, tile = blockIdx.y, b = blockIdx.z;
  const int tile_end = min((tile + 1) * block_rows, S);
  const int r0 = tile * block_rows + sub * sub_rows;
  const int r1 = min(r0 + sub_rows, tile_end);
  const float cs = c_skip[b], co = c_out[b];
  float acc = 0.f;
  if (r0 < r1) {
    const long long base = (static_cast<long long>(b) * S + r0) * d;
    const long long n = static_cast<long long>(r1 - r0) * d;
    for (long long i = threadIdx.x * 4LL; i < n; i += kThreads * 4LL) {
      float fv[4], zv[4], yv[4];
      load_vec<float, 4>(f + base + i, fv);
      load_vec<float, 4>(z + base + i, zv);
      load_vec<float, 4>(y + base + i, yv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = __fsub_rn(fv[j], target(yv[j], zv[j], cs, co));
        acc = fmaf(e, e, acc);
      }
    }
  }
  const float total = rowwise::block_sum(acc);
  if (threadIdx.x == 0)
    partials[(static_cast<long long>(b) * gridDim.y + tile) * gridDim.x +
             sub] = total;
}

// g: (B, n_tiles) fp32, the cotangent of each tile's partial sum.
__global__ void edm_loss_bwd_kernel(const float* __restrict__ f,
                                    const float* __restrict__ z,
                                    const float* __restrict__ y,
                                    const float* __restrict__ c_skip,
                                    const float* __restrict__ c_out,
                                    const float* __restrict__ g,
                                    float* __restrict__ df,
                                    float* __restrict__ dz,
                                    float* __restrict__ dy, long long n4,
                                    int S, int d4, int block_rows,
                                    int n_tiles) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / d4;  // over B*S
    const int b = static_cast<int>(row / S);
    const int s = static_cast<int>(row - static_cast<long long>(b) * S);
    const float cs = c_skip[b], co = c_out[b];
    const float gv = g[b * n_tiles + s / block_rows];
    const float ratio = __fdiv_rn(cs, co);
    float fv[4], zv[4], yv[4], o_f[4], o_z[4], o_y[4];
    load_vec<float, 4>(f + i * 4, fv);
    load_vec<float, 4>(z + i * 4, zv);
    load_vec<float, 4>(y + i * 4, yv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t = target(yv[j], zv[j], cs, co);
      const float e = __fmul_rn(__fmul_rn(2.f, __fsub_rn(fv[j], t)), gv);
      o_f[j] = e;
      o_z[j] = __fmul_rn(e, ratio);
      o_y[j] = __fdiv_rn(-e, co);
    }
    store_vec<float, 4>(df + i * 4, o_f);
    store_vec<float, 4>(dz + i * 4, o_z);
    store_vec<float, 4>(dy + i * 4, o_y);
  }
}

}  // namespace

// f, z, y: (B, S, d) contiguous fp32; c_skip, c_out: (B,) fp32;
// partials: (B, ceil(S / block_rows), ceil(block_rows / sub_rows)) fp32.
// d % 4 == 0.
extern "C" int rt_edm_loss_fwd(const void* f, const void* z, const void* y,
                               const void* c_skip, const void* c_out,
                               void* partials, int B, int S, int d,
                               int block_rows, int sub_rows, void* stream) {
  if (d % 4 != 0 || B < 1 || S < 1 || block_rows < 1 || sub_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (S + block_rows - 1) / block_rows;
  const int n_sub = (block_rows + sub_rows - 1) / sub_rows;
  edm_loss_fwd_kernel<<<dim3(n_sub, n_tiles, B), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(z),
      static_cast<const float*>(y), static_cast<const float*>(c_skip),
      static_cast<const float*>(c_out), static_cast<float*>(partials), S, d,
      block_rows, sub_rows);
  return static_cast<int>(cudaGetLastError());
}

// f, z, y, df, dz, dy: (B, S, d) contiguous fp32; g: (B, n_tiles) fp32.
extern "C" int rt_edm_loss_bwd(const void* f, const void* z, const void* y,
                               const void* c_skip, const void* c_out,
                               const void* g, void* df, void* dz, void* dy,
                               int B, int S, int d, int block_rows,
                               void* stream) {
  if (d % 4 != 0 || B < 1 || S < 1 || block_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (S + block_rows - 1) / block_rows;
  const long long n4 = static_cast<long long>(B) * S * (d / 4);
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  edm_loss_bwd_kernel<<<static_cast<int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(z),
      static_cast<const float*>(y), static_cast<const float*>(c_skip),
      static_cast<const float*>(c_out), static_cast<const float*>(g),
      static_cast<float*>(df), static_cast<float*>(dz),
      static_cast<float*>(dy), n4, S, d / 4, block_rows, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
