// Gated residual, out = res + branch * (1 + gate), and its backward, for
// sm_90a. Replaces the Pallas TPU kernels src/repro/kernels/fused_adaln.py:137
// (_gate_res_kernel) and :143 (_gate_res_bwd_kernel), called through
// fused_gate_residual at :203.
//
// What bounds them: bytes. The forward reads res and branch (B, S, d),
// reads the per-example gate (B, d), writes out (B, S, d), and does 2 flops
// per element; the backward reads the cotangent g and branch, writes
// d_branch = g * (1 + gate) and per-tile sums of g * branch for d_gate. The
// TPU kernels tiled rows into VMEM. The gate is read through a row stride,
// so a column slice of the AdaLN head's (B, 6d) output needs no copy.
// Elementwise math is fp32 with explicit round-to-nearest adds and
// multiplies (no fused multiply-add), the same roundings as the plain
// PyTorch versions; outputs are written in the streams' dtype.
//
// The forward runs on every layer of serving's probes, at (8, 1, 2048):
// 16,384 elements, where a launch lasts about a microsecond and what a
// thread does before its first load is not hidden. So it does little: the
// grid (row tile, example, column block) gives the example index with no
// division; offsets inside a row are 32-bit from a 64-bit row base; each
// thread takes V elements of one row with 16-byte loads and a 16-byte
// store (V = 8 in bf16, 4 in fp32; 8 bytes for bf16 rows of a d that is
// not a multiple of 8) and reads its V gate values as one vector (a scalar
// path for a gate slice that is not aligned to it). A thread takes no more
// rows: the probe has one row an example, and where S is larger the
// neighbouring rows' threads find the gate vector in cache.
//
// The backward's d_gate is a sum over the rows of one example. A block owns
// one tile of tile_rows rows of one example and loops over them per column,
// so no tile crosses examples and no atomics are needed: it writes its fp32
// column sums to partials[b, tile, :], and the caller sums the tiles (the
// TPU kernel's (B, n_tiles, d) partials, summed outside it).
#include <stdint.h>

#include <algorithm>

#include "rowwise.cuh"

namespace {

using rowwise::to_f;
using rowwise::Vec4;

constexpr int kThreads = 256;     // backward
constexpr int kFwdThreads = 128;  // forward: a block of cx x ry threads

// V elements of T at p (8, 16 or 32 bytes, aligned to min(16, that)) as
// floats; bf16 widened exactly (its bits are the top half of an fp32).
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[V]) {
  constexpr int W = V * static_cast<int>(sizeof(T)) / 4;  // 32-bit words
  static_assert(W == 2 || W % 4 == 0, "8-byte or 16-byte pieces");
  uint32_t w[W];
  if constexpr (W == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if constexpr (sizeof(T) == 4) {
      o[j] = __uint_as_float(w[j]);
    } else {
      o[2 * j] = __uint_as_float(w[j] << 16);
      o[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// The V floats v stored at p as T (bf16 rounded to nearest), as load_vec.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  constexpr int W = V * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if constexpr (sizeof(T) == 4) {
      w[j] = __float_as_uint(v[j]);
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < W / 4; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
}

// grid (tiles, B, column blocks), block (cx, ry): block (x, b, z) owns rows
// [x * ry, x * ry + ry) of example b and the column vectors
// [z * cx, z * cx + cx); thread (tx, ty) takes one vector of row x * ry + ty.
template <typename T, typename TG, int V, bool GVEC>
__global__ void gate_residual_kernel(const T* __restrict__ res,
                                     const T* __restrict__ branch,
                                     const TG* __restrict__ gate,
                                     T* __restrict__ out, int S, int d,
                                     long long gate_stride) {
  const int b = blockIdx.y;
  const int s = blockIdx.x * blockDim.y + threadIdx.y;
  const int c = (blockIdx.z * blockDim.x + threadIdx.x) * V;
  if (s >= S || c >= d) return;
  const long long row = (static_cast<long long>(b) * S + s) * d;
  float g1[V], r[V], x[V];
  const TG* gp = gate + b * gate_stride + c;
  if constexpr (GVEC) {
    load_vec<TG, V>(gp, g1);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) g1[j] = to_f(gp[j]);
  }
  load_vec<T, V>(res + row + c, r);
  load_vec<T, V>(branch + row + c, x);
#pragma unroll
  for (int j = 0; j < V; ++j)
    r[j] = __fadd_rn(r[j], __fmul_rn(x[j], __fadd_rn(1.f, g1[j])));
  store_vec<T, V>(out + row + c, r);
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

template <typename T, typename TG, int V>
void launch_v(const void* res, const void* branch, const void* gate,
              void* out, int B, int S, int d, long long gate_stride,
              cudaStream_t st) {
  // the gate as one vector a thread where its slice allows
  constexpr int kAlign = V * sizeof(TG) < 16 ? V * sizeof(TG) : 16;
  const bool gvec = reinterpret_cast<uintptr_t>(gate) % kAlign == 0 &&
                    gate_stride * static_cast<long long>(sizeof(TG)) %
                            kAlign == 0;
  const int dv = d / V;                       // column vectors a row
  const int cx = std::min((dv + 31) / 32 * 32, kFwdThreads);
  const int ry = std::max(1, std::min(kFwdThreads / cx, S));
  const dim3 block(cx, ry);
  // gridDim.y holds at most 65535 examples: larger batches in chunks
  constexpr int kMaxGridY = 65535;
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const dim3 grid((S + ry - 1) / ry, std::min(B - b0, kMaxGridY),
                    (dv + cx - 1) / cx);
    const long long off = static_cast<long long>(b0) * S * d;
    const T* r = static_cast<const T*>(res) + off;
    const T* x = static_cast<const T*>(branch) + off;
    const TG* g = static_cast<const TG*>(gate) + b0 * gate_stride;
    T* o = static_cast<T*>(out) + off;
    if (gvec)
      gate_residual_kernel<T, TG, V, true><<<grid, block, 0, st>>>(
          r, x, g, o, S, d, gate_stride);
    else
      gate_residual_kernel<T, TG, V, false><<<grid, block, 0, st>>>(
          r, x, g, o, S, d, gate_stride);
  }
}

// 16-byte vectors (8 bf16 or 4 fp32 elements); bf16 rows whose d is not a
// multiple of 8 are not 16-byte aligned, and take 8-byte vectors.
template <typename T, typename TG>
void launch(const void* res, const void* branch, const void* gate, void* out,
            int B, int S, int d, long long gate_stride, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (d % 8 == 0) {
      launch_v<T, TG, 8>(res, branch, gate, out, B, S, d, gate_stride, st);
      return;
    }
  }
  launch_v<T, TG, 4>(res, branch, gate, out, B, S, d, gate_stride, st);
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

// x_dtype / gate_dtype: 0 fp32, 1 bf16. rows = B*S; d % 4 == 0; the
// streams 16-byte aligned and contiguous.
extern "C" int rt_gate_residual(const void* res, const void* branch,
                                const void* gate, void* out, long long rows,
                                int S, int d, long long gate_stride,
                                int x_dtype, int gate_dtype, void* stream) {
  if (d % 4 != 0 || S < 1 || rows % S != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int B = static_cast<int>(rows / S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + gate_dtype) {
    case 0: launch<float, float>(res, branch, gate, out, B, S, d, gate_stride, st); break;
    case 1: launch<float, __nv_bfloat16>(res, branch, gate, out, B, S, d, gate_stride, st); break;
    case 2: launch<__nv_bfloat16, float>(res, branch, gate, out, B, S, d, gate_stride, st); break;
    case 3: launch<__nv_bfloat16, __nv_bfloat16>(res, branch, gate, out, B, S, d, gate_stride, st); break;
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
