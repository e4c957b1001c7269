// Gated residual, out = res + branch * (1 + gate), and its backward, for
// sm_90a. Replaces the Pallas TPU kernels src/repro/kernels/fused_adaln.py:137
// (_gate_res_kernel) and :143 (_gate_res_bwd_kernel), called through
// fused_gate_residual at :203.
//
// What bounds them: bytes. The forward reads res and branch (B, S, d),
// reads the per-example gate (B, d), writes out (B, S, d), and does 2 flops
// per element; the backward reads the cotangent g and branch, writes
// d_branch = g * (1 + gate) and d_gate = the sum over rows of g * branch.
// The TPU kernels tiled rows into VMEM. The gate is read through a row stride,
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
// The backward's d_gate is a sum over the rows of one example. A block is
// (cx, ry) threads, laid out as the forward's: thread (tx, ty) owns column
// vector tx of the block's span of cx vectors (16 bytes; 8 for bf16 rows
// of a d that is not a multiple of 8) and walks rows ty, ty + ry, ... with
// 4 rows' loads issued at once, keeping its sums of g * branch in
// registers; the gate is read once per thread, and each byte of g and
// branch once. Where the (example, span) pairs fill 90% of a wave at spans
// as narrow as 8 vectors (128 bytes of a row), a block takes every row of
// its pair and sums its row groups in shared memory: no block sums
// another's columns (the two-pass path's (8, 512, 2048) at 8 vectors,
// DiT-S/2's (256, 256, 384) fp32 at (96, 2), where no thread idles). Else
// a block takes a tile of rows of a span of up to 128 vectors, and the
// tiles' sums go through rowwise::column_sums (rowwise.cuh: a cluster of
// tiles in shared memory, then an atomic ticket, in a fixed order). Either
// way d_gate is written by this launch, in the gate's dtype, bit-equal
// from call to call.
#include <stdint.h>

#include <algorithm>

#include "rowwise.cuh"

namespace {

using rowwise::load_mod;
using rowwise::load_raw;
using rowwise::load_vec;
using rowwise::store_vec;
using rowwise::to_f;
using rowwise::unpack;

constexpr int kFwdThreads = 128;  // forward: a block of cx x ry threads
constexpr int kBwdThreads = 256;  // backward: a block of cx x ry threads
constexpr int kMaxGridY = 65535;

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

// grid (n_tiles, B, spans) in clusters of (cl, 1, 1), block (cx, ry):
// block (tile, b, z) owns rows [tile * tile_rows, ...) of example b and the
// column vectors [z * cx, z * cx + cx). dgate (B, d) in TG.
template <typename T, typename TG, int V>
__global__ void __launch_bounds__(kBwdThreads)
    gate_residual_bwd_kernel(const T* __restrict__ branch,
                             const TG* __restrict__ gate,
                             const T* __restrict__ g,
                             T* __restrict__ dbranch, TG* __restrict__ dgate,
                             float* __restrict__ scratch,
                             unsigned* __restrict__ tickets, int S, int d,
                             long long gate_stride, int tile_rows,
                             int n_clusters, bool gvec) {
  constexpr int U = 4;  // rows a thread loads at once
  constexpr int W = rowwise::kWords<T, V>;
  extern __shared__ __align__(16) float sm[];
  const int cx = blockDim.x, ry = blockDim.y;
  const int b = blockIdx.y;
  const int col0 = blockIdx.z * cx * V;
  const int c = col0 + threadIdx.x * V;
  const bool on = c < d;
  const int row0 = blockIdx.x * tile_rows;
  const int nrows = on ? max(0, min(tile_rows, S - row0)) : 0;
  const long long base = (static_cast<long long>(b) * S + row0) * d + c;
  float g1[V] = {}, acc[1][1][V] = {};
  if (on) load_mod<TG, V>(gate + b * gate_stride + c, gvec, g1);
#pragma unroll
  for (int j = 0; j < V; ++j) g1[j] = __fadd_rn(1.f, g1[j]);
  for (int r0 = threadIdx.y; r0 < nrows; r0 += ry * U) {
    uint32_t gw[U][W], bw[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * ry;
      if (r < nrows) {
        const long long off = base + static_cast<long long>(r) * d;
        load_raw<T, V>(g + off, gw[u]);
        load_raw<T, V>(branch + off, bw[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * ry;
      if (r >= nrows) break;
      float gv[V], bv[V], o[V];
      unpack<T, V>(gw[u], gv);
      unpack<T, V>(bw[u], bv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o[j] = __fmul_rn(gv[j], g1[j]);
        acc[0][0][j] = fmaf(gv[j], bv[j], acc[0][0][j]);
      }
      store_vec<T, V>(dbranch + base + static_cast<long long>(r) * d, o);
    }
  }
  const int cl = gridDim.x / n_clusters;
  const rowwise::ColumnSums<TG> cs{
      dgate, 0, scratch,
      tickets + (static_cast<long long>(b) * gridDim.z + blockIdx.z) * cl, d,
      b, col0, min(d - col0, cx * V), n_clusters};
  rowwise::column_sums<1, 1, V>(acc, sm, cs);
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

struct BwdArgs {
  const void *branch, *gate, *g;
  void *dbranch, *dgate;
  float* scratch;
  unsigned* tickets;
  int B, S, d;
  long long gate_stride;
  cudaStream_t st;
};

// The backward's plan for these shapes; with sizes, only report it
// (rowwise::report), else launch.
template <typename T, typename TG, int V>
cudaError_t run_bwd(const BwdArgs& a, long long* sizes) {
  constexpr int U = 4;
  constexpr int kMaxSpan = 128, kMinSpan = 8;  // column vectors a block
  auto kernel = gate_residual_bwd_kernel<T, TG, V>;
  const int dv = a.d / V, dv32 = (dv + 31) / 32 * 32;
  const int bc = std::min(a.B, kMaxGridY);
  // A block takes all rows of its (example, span) where those pairs fill
  // 90% of a wave: the widest span that does, so no block sums another's
  // columns. Else tiles of rows, at the widest span.
  const long long wave = static_cast<long long>(rowwise::sm_count()) *
                         rowwise::kBlocksPerSM;
  int whole = 0;
  for (int w = kMaxSpan; w >= kMinSpan && whole == 0; w /= 2) {
    const int c = std::min(w, dv32);
    if (10LL * bc * ((dv + c - 1) / c) >= 9 * wave) whole = c;
  }
  rowwise::Plan p;
  p.cx = whole ? whole : std::min(dv32, kMaxSpan);
  p.ry = std::max(1, kBwdThreads / p.cx);
  p.smem = sizeof(float) * p.ry * p.cx * V;
  cudaError_t e = rowwise::allow_smem(kernel, p.smem);
  if (e != cudaSuccess) return e;
  const int spans = (dv + p.cx - 1) / p.cx;
  if (whole) {
    p.cl = p.n_tiles = 1;
    p.tile_rows = a.S;
    if (rowwise::wave_blocks(kernel, p, 1) < 1)
      return cudaErrorInvalidConfiguration;
  } else if (!rowwise::plan_tiles(kernel, p, bc, a.S, spans, p.ry * U)) {
    return cudaErrorInvalidConfiguration;
  }
  const int ncl = p.n_clusters();
  if (sizes != nullptr) {
    rowwise::report(p, ncl > 1 ? static_cast<long long>(bc) * ncl * a.d : 0,
                    static_cast<long long>(bc) * spans * p.cl, sizes);
    return cudaSuccess;
  }
  // the gate as one vector a thread where its slice allows
  constexpr int kAlign = V * sizeof(TG) < 16 ? V * sizeof(TG) : 16;
  const bool gvec = reinterpret_cast<uintptr_t>(a.gate) % kAlign == 0 &&
                    a.gate_stride * static_cast<long long>(sizeof(TG)) %
                            kAlign == 0;
  for (int b0 = 0; b0 < a.B; b0 += kMaxGridY) {
    const int nb = std::min(a.B - b0, kMaxGridY);
    const long long off = static_cast<long long>(b0) * a.S * a.d;
    e = rowwise::launch_clusters(
        kernel, dim3(p.n_tiles, nb, spans), dim3(p.cx, p.ry, 1), p.smem,
        p.cl, a.st, static_cast<const T*>(a.branch) + off,
        static_cast<const TG*>(a.gate) + b0 * a.gate_stride,
        static_cast<const T*>(a.g) + off, static_cast<T*>(a.dbranch) + off,
        static_cast<TG*>(a.dgate) + static_cast<long long>(b0) * a.d,
        a.scratch, a.tickets, a.S, a.d, a.gate_stride, p.tile_rows, ncl,
        gvec);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename T, typename TG>
cudaError_t run_bwd_t(const BwdArgs& a, long long* sizes) {
  if constexpr (sizeof(T) == 2) {
    if (a.d % 8 == 0) return run_bwd<T, TG, 8>(a, sizes);
  }
  return run_bwd<T, TG, 4>(a, sizes);
}

cudaError_t dispatch_bwd(const BwdArgs& a, int x_dtype, int gate_dtype,
                         long long* sizes) {
  if (a.d % 4 != 0 || a.B < 1 || a.S < 1) return cudaErrorInvalidValue;
  switch (x_dtype * 2 + gate_dtype) {
    case 0: return run_bwd_t<float, float>(a, sizes);
    case 1: return run_bwd_t<float, __nv_bfloat16>(a, sizes);
    case 2: return run_bwd_t<__nv_bfloat16, float>(a, sizes);
    case 3: return run_bwd_t<__nv_bfloat16, __nv_bfloat16>(a, sizes);
    default: return cudaErrorInvalidValue;
  }
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

// The backward's plan for these shapes on the current device, into
// sizes[rowwise::kPlanFields]: fp32 scratch elements, unsigned tickets
// (zero before the first launch; each launch leaves them zero), cx, ry,
// tile_rows, n_tiles, cl.
extern "C" int rt_gate_residual_bwd_plan(int B, int S, int d, int x_dtype,
                                         int gate_dtype, long long* sizes) {
  BwdArgs a = {};
  a.B = B;
  a.S = S;
  a.d = d;
  return static_cast<int>(dispatch_bwd(a, x_dtype, gate_dtype, sizes));
}

// branch, g, dbranch: (B, S, d) contiguous in x_dtype; gate (B, d) in
// gate_dtype with row stride gate_stride; dgate (B, d) in gate_dtype;
// scratch and tickets as rt_gate_residual_bwd_plan sizes them. d % 4 == 0.
extern "C" int rt_gate_residual_bwd(const void* branch, const void* gate,
                                    const void* g, void* dbranch,
                                    void* dgate, void* scratch,
                                    void* tickets, int B, int S, int d,
                                    long long gate_stride, int x_dtype,
                                    int gate_dtype, void* stream) {
  const BwdArgs a = {branch, gate, g, dbranch, dgate,
                     static_cast<float*>(scratch),
                     static_cast<unsigned*>(tickets), B, S, d, gate_stride,
                     static_cast<cudaStream_t>(stream)};
  const cudaError_t e = dispatch_bwd(a, x_dtype, gate_dtype, nullptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
