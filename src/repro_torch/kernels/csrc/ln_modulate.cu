// Non-parametric LayerNorm followed by the AdaLN modulation,
// out = LN(x) * (1 + scale) + shift, and its backward, for sm_90a. Replaces
// the Pallas TPU kernels src/repro/kernels/fused_adaln.py:43 (_ln_mod_kernel)
// and :53 (_ln_mod_bwd_kernel), called through fused_ln_modulate.
//
// What bounds them: bytes. The forward reads x (B, S, d) and the
// per-example scale and shift (B, d) and writes out (B, S, d), a few flops
// per element; the backward reads x and the cotangent g and writes dx, plus
// per-tile (B, d) sums for d_scale and d_shift. The TPU kernels kept a
// (rows x d) tile in VMEM; here a row is re-read from L1/L2 for each pass
// over it, so device memory is still read about once.
//
// Statistics are the reference's two-pass form: mean = sum(x) / d, then
// var = sum((x - mean)^2) / d (never E[x^2] - mean^2), rstd =
// rsqrt(var + eps), all in fp32. scale and shift are read through row
// strides, so column slices of the AdaLN head's (B, 6d) output need no copy.
//
// Forward: one warp per row; pass 1 sums x, pass 2 sums the squared
// deviations, pass 3 writes the modulated row (4 neighbouring elements per
// lane, coalesced).
//
// Backward: dy = g * (1 + scale), xhat = (x - mean) * rstd,
// dx = rstd * (dy - mean(dy) - xhat * mean(dy * xhat)),
// d_scale = sum over rows of g * xhat, d_shift = sum over rows of g. A block
// owns a tile of tile_rows rows of one example (so no tile crosses examples
// and no atomics are needed). Step 1, one warp per row: the row's mean,
// rstd, mean(dy) and mean(dy * xhat) = rstd * mean(dy * (x - mean)) into
// shared memory. Step 2, one thread per column quad: walk the tile's rows,
// write dx and sum g * xhat and g per column, then write the tile's fp32
// column sums to partials[b, tile, :]; the caller sums the tiles (the TPU
// kernel's (B, n_tiles, d) partials, summed outside it).
#include "rowwise.cuh"

namespace {

using rowwise::to_f;
using rowwise::Vec4;
using rowwise::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTileRows = 64;

template <typename T, typename TM>
__global__ void ln_mod_fwd_kernel(const T* __restrict__ x,
                                  const TM* __restrict__ scale,
                                  const TM* __restrict__ shift,
                                  T* __restrict__ out, long long rows, int S,
                                  int d, long long scale_stride,
                                  long long shift_stride, float eps) {
  const int lane = threadIdx.x & 31;
  const float fd = static_cast<float>(d);
  for (long long row = blockIdx.x * static_cast<long long>(kWarps) +
                       (threadIdx.x >> 5);
       row < rows; row += static_cast<long long>(gridDim.x) * kWarps) {
    const T* xr = x + row * d;
    float s = 0.f;
    for (int c = lane * 4; c < d; c += 128) {
      float v[4];
      Vec4<T>::load(xr + c, v);
      s += (v[0] + v[1]) + (v[2] + v[3]);
    }
    const float mean = warp_sum(s) / fd;
    float q = 0.f;
    for (int c = lane * 4; c < d; c += 128) {
      float v[4];
      Vec4<T>::load(xr + c, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = v[j] - mean;
        q = fmaf(t, t, q);
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / fd + eps);
    const long long b = row / S;
    const TM* sc = scale + b * scale_stride;
    const TM* sh = shift + b * shift_stride;
    T* o = out + row * d;
    for (int c = lane * 4; c < d; c += 128) {
      float v[4], y[4];
      Vec4<T>::load(xr + c, v);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = (v[j] - mean) * rstd * (1.f + to_f(sc[c + j])) +
               to_f(sh[c + j]);
      Vec4<T>::store(o + c, y);
    }
  }
}

// grid (n_tiles, B); block (tile, b) owns rows [tile*tile_rows, ...) of
// example b. dscale_part / dshift_part: (B, n_tiles, d) fp32.
template <typename T, typename TM>
__global__ void ln_mod_bwd_kernel(const T* __restrict__ x,
                                  const TM* __restrict__ scale,
                                  const T* __restrict__ g,
                                  T* __restrict__ dx,
                                  float* __restrict__ dscale_part,
                                  float* __restrict__ dshift_part, int S,
                                  int d, long long scale_stride,
                                  int tile_rows, int n_tiles, float eps) {
  __shared__ float st_mean[kMaxTileRows], st_rstd[kMaxTileRows],
      st_mdy[kMaxTileRows], st_mdyx[kMaxTileRows];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int row0 = tile * tile_rows;
  const int nrows = min(tile_rows, S - row0);
  const TM* sc = scale + b * scale_stride;
  const long long base = (static_cast<long long>(b) * S + row0) * d;
  const int lane = threadIdx.x & 31;
  const float fd = static_cast<float>(d);

  // step 1: per-row statistics, one warp per row
  for (int r = threadIdx.x >> 5; r < nrows; r += kWarps) {
    const T* xr = x + base + static_cast<long long>(r) * d;
    const T* gr = g + base + static_cast<long long>(r) * d;
    float sx = 0.f, sdy = 0.f;
    for (int c = lane * 4; c < d; c += 128) {
      float xv[4], gv[4];
      Vec4<T>::load(xr + c, xv);
      Vec4<T>::load(gr + c, gv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sx += xv[j];
        sdy += gv[j] * (1.f + to_f(sc[c + j]));
      }
    }
    const float mean = warp_sum(sx) / fd;
    const float mdy = warp_sum(sdy) / fd;
    float sq = 0.f, sdyx = 0.f;
    for (int c = lane * 4; c < d; c += 128) {
      float xv[4], gv[4];
      Vec4<T>::load(xr + c, xv);
      Vec4<T>::load(gr + c, gv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = xv[j] - mean;
        sq = fmaf(t, t, sq);
        sdyx = fmaf(gv[j] * (1.f + to_f(sc[c + j])), t, sdyx);
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / fd + eps);
    const float mdyx = warp_sum(sdyx) / fd * rstd;
    if (lane == 0) {
      st_mean[r] = mean;
      st_rstd[r] = rstd;
      st_mdy[r] = mdy;
      st_mdyx[r] = mdyx;
    }
  }
  __syncthreads();

  // step 2: dx and the column sums, one thread per column quad
  const long long pbase = (static_cast<long long>(b) * n_tiles + tile) * d;
  for (int c = threadIdx.x * 4; c < d; c += blockDim.x * 4) {
    float s1[4], asc[4] = {0.f, 0.f, 0.f, 0.f}, ash[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) s1[j] = 1.f + to_f(sc[c + j]);
    for (int r = 0; r < nrows; ++r) {
      const long long off = base + static_cast<long long>(r) * d + c;
      const float mean = st_mean[r], rstd = st_rstd[r], mdy = st_mdy[r],
                  mdyx = st_mdyx[r];
      float xv[4], gv[4], o[4];
      Vec4<T>::load(x + off, xv);
      Vec4<T>::load(g + off, gv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xhat = (xv[j] - mean) * rstd;
        const float dy = gv[j] * s1[j];
        o[j] = rstd * (dy - mdy - xhat * mdyx);
        asc[j] = fmaf(gv[j], xhat, asc[j]);
        ash[j] += gv[j];
      }
      Vec4<T>::store(dx + off, o);
    }
    Vec4<float>::store(dscale_part + pbase + c, asc);
    Vec4<float>::store(dshift_part + pbase + c, ash);
  }
}

template <typename T, typename TM>
void launch_fwd(const void* x, const void* scale, const void* shift,
                void* out, long long rows, int S, int d,
                long long scale_stride, long long shift_stride, float eps,
                cudaStream_t st) {
  long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  ln_mod_fwd_kernel<T, TM><<<static_cast<int>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const TM*>(scale),
      static_cast<const TM*>(shift), static_cast<T*>(out), rows, S, d,
      scale_stride, shift_stride, eps);
}

template <typename T, typename TM>
void launch_bwd(const void* x, const void* scale, const void* g, void* dx,
                float* dscale_part, float* dshift_part, int B, int S, int d,
                long long scale_stride, int tile_rows, float eps,
                cudaStream_t st) {
  const int n_tiles = (S + tile_rows - 1) / tile_rows;
  ln_mod_bwd_kernel<T, TM><<<dim3(n_tiles, B), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const TM*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx), dscale_part,
      dshift_part, S, d, scale_stride, tile_rows, n_tiles, eps);
}

}  // namespace

// x, out: (B, S, d) contiguous in x_dtype; scale, shift: (B, d) in
// mod_dtype with unit stride along d and row strides scale_stride,
// shift_stride. x_dtype / mod_dtype: 0 fp32, 1 bf16. d % 4 == 0.
extern "C" int rt_ln_modulate_fwd(const void* x, const void* scale,
                                  const void* shift, void* out, int B, int S,
                                  int d, long long scale_stride,
                                  long long shift_stride, float eps,
                                  int x_dtype, int mod_dtype, void* stream) {
  if (d % 4 != 0 || B < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * S;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + mod_dtype) {
    case 0: launch_fwd<float, float>(x, scale, shift, out, rows, S, d, scale_stride, shift_stride, eps, st); break;
    case 1: launch_fwd<float, __nv_bfloat16>(x, scale, shift, out, rows, S, d, scale_stride, shift_stride, eps, st); break;
    case 2: launch_fwd<__nv_bfloat16, float>(x, scale, shift, out, rows, S, d, scale_stride, shift_stride, eps, st); break;
    case 3: launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, scale, shift, out, rows, S, d, scale_stride, shift_stride, eps, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, g, dx: (B, S, d) contiguous in x_dtype; scale (B, d) in mod_dtype with
// row stride scale_stride; dscale_part, dshift_part: (B, ceil(S /
// tile_rows), d) fp32. 1 <= tile_rows <= 64, d % 4 == 0.
extern "C" int rt_ln_modulate_bwd(const void* x, const void* scale,
                                  const void* g, void* dx, void* dscale_part,
                                  void* dshift_part, int B, int S, int d,
                                  long long scale_stride, int tile_rows,
                                  float eps, int x_dtype, int mod_dtype,
                                  void* stream) {
  if (d % 4 != 0 || B < 1 || S < 1 || tile_rows < 1 ||
      tile_rows > kMaxTileRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* psc = static_cast<float*>(dscale_part);
  float* psh = static_cast<float*>(dshift_part);
  switch (x_dtype * 2 + mod_dtype) {
    case 0: launch_bwd<float, float>(x, scale, g, dx, psc, psh, B, S, d, scale_stride, tile_rows, eps, st); break;
    case 1: launch_bwd<float, __nv_bfloat16>(x, scale, g, dx, psc, psh, B, S, d, scale_stride, tile_rows, eps, st); break;
    case 2: launch_bwd<__nv_bfloat16, float>(x, scale, g, dx, psc, psh, B, S, d, scale_stride, tile_rows, eps, st); break;
    case 3: launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, scale, g, dx, psc, psh, B, S, d, scale_stride, tile_rows, eps, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
