// Non-parametric LayerNorm followed by the AdaLN modulation,
// out = LN(x) * (1 + scale) + shift, and its backward, for sm_90a. Replaces
// the Pallas TPU kernels src/repro/kernels/fused_adaln.py:43 (_ln_mod_kernel)
// and :53 (_ln_mod_bwd_kernel), called through fused_ln_modulate.
//
// What bounds them: bytes. The forward reads x (B, S, d) and the
// per-example scale and shift (B, d) and writes out (B, S, d), a few flops
// per element; the backward reads x and the cotangent g and writes dx and
// the (B, d) sums d_scale and d_shift. The TPU kernels kept a (rows x d)
// tile in VMEM.
//
// Statistics are the reference's two-pass form: mean = sum(x) / d, then
// var = sum((x - mean)^2) / d (never E[x^2] - mean^2), rstd =
// rsqrt(var + eps), all in fp32. scale and shift are read through row
// strides, so column slices of the AdaLN head's (B, 6d) output need no copy.
//
// Forward: a block owns a tile of rows of one example and is (cx, ry)
// threads: thread (tx, ty) owns the 16-byte column vectors tx + p * cx of
// every row (8 bf16 or 4 fp32 elements; 8 bytes for bf16 rows of a d that
// is not a multiple of 8; PV vectors where d is wider than 512 vectors),
// reads its columns of scale and shift once for the tile, and walks the
// tile's rows ty, ty + ry, ..., U = 8 / PV rows a step (4 / PV where the
// example has too few rows for 8-row steps to fill one wave of the card:
// more bytes in flight a thread, against more tiles). A step's rows are
// loaded into registers once, the next step's loads issued before this
// step reduces; the mean, then the sum of squared deviations from those
// registers, each a reduce-scatter over the row group (group_sum, below)
// for the step's rows at once; then out is written once. Each byte of x is
// read once, and the tiles are sized so that one wave fills the card
// (rowwise::plan_tiles, no clusters: the forward has no column sums).
//
// Backward: dy = g * (1 + scale), xhat = (x - mean) * rstd,
// dx = rstd * (dy - mean(dy) - xhat * mean(dy * xhat)),
// d_scale = sum over rows of g * xhat, d_shift = sum over rows of g. A block
// owns a tile of rows of one example and is (cx, ry) threads: thread (tx,
// ty) owns the 16-byte column vectors tx + p * cx of every row (8 bf16 or 4
// fp32 elements; 8 bytes for bf16 rows of a d that is not a multiple of 8;
// PV vectors where d is wider than 512 vectors) and walks the tile's rows
// ty, ty + ry, ..., U = 4 / PV rows a step. Each byte of x and g is read
// from memory once: cp.async copies the rows into a ring of 2 steps in
// shared memory, the next step in flight while one reduces, and a step
// reads its rows into registers once, as floats. A step sums its rows over the row group's
// threads in two rounds, each a reduce-scatter of warp shuffles and, where
// a row spans several warps, one barrier: sum(x) and sum(dy), then
// sum((x - mean)^2) and sum(dy (x - mean)); then dx is written once. The
// column sums of g * xhat and g stay in registers for the whole tile and
// go through rowwise::column_sums (rowwise.cuh): across the row groups and
// a cluster of tiles in shared memory, across clusters by a ticket, in a
// fixed order, so the (B, d) results are written by this launch and are
// bit-equal from call to call. The launch sizes the tiles so that one wave
// fills the card (rowwise::plan_tiles).
#include "mma.cuh"
#include "rowwise.cuh"

namespace {

using rowwise::load_mod;
using rowwise::load_raw;
using rowwise::load_vec;
using rowwise::store_vec;
using rowwise::unpack;

constexpr int kMaxThreads = 512;        // a block: cx * ry threads
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxGridY = 65535;
constexpr int kStages = 2;  // backward: steps of rows in the shared ring

__host__ __device__ constexpr int ilog2(int n) {
  return n > 1 ? 1 + ilog2(n / 2) : 0;
}

// The N values v (N a power of two, at most 32) summed over the cx threads
// of this thread's row group (blockDim.x threads, a multiple of 32). In the
// warp a reduce-scatter: each exchange halves the values a lane keeps, so
// lane l ends with value l >> (5 - log2 N) in N - 1 + 5 - log2 N shuffles
// (5 N for a butterfly a value). Where a row group spans several warps, one
// round through red and one barrier, each lane adding its value over the
// group's warps; then the N sums go back to every lane. Every thread of
// the block calls it.
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N],
                                          float (&red)[kMaxWarps][N]) {
  constexpr int kShift = 5 - ilog2(N);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = N, o = 16; n > 1; n >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float s = v[0];
#pragma unroll
  for (int o = (1 << kShift) >> 1; o > 0; o >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  const int cx = blockDim.x;
  if (cx > 32) {
    const int warp = (threadIdx.y * cx + threadIdx.x) >> 5;
    if ((lane & ((1 << kShift) - 1)) == 0) red[warp][lane >> kShift] = s;
    __syncthreads();
    const int nw = cx >> 5, w0 = threadIdx.y * nw;
    s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[w0 + w][lane >> kShift];
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = __shfl_sync(0xffffffffu, s, i << kShift);
}

// grid (n_tiles, B), block (cx, ry): block (tile, b) owns rows
// [tile * tile_rows, ...) of example b, U rows a step. smod: scale and
// shift each read as one vector a thread (bit 0: scale, bit 1: shift)
// where the slice allows.
template <typename T, typename TM, int V, int PV, int U>
__global__ void __launch_bounds__(kMaxThreads)
    ln_mod_fwd_kernel(const T* __restrict__ x, const TM* __restrict__ scale,
                      const TM* __restrict__ shift, T* __restrict__ out,
                      int S, int d, long long scale_stride,
                      long long shift_stride, int tile_rows, int smod,
                      float eps) {
  constexpr int W = rowwise::kWords<T, V>;
  __shared__ float red[2][kMaxWarps][U];
  const int cx = blockDim.x, ry = blockDim.y;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * tile_rows;
  const int nrows = max(0, min(tile_rows, S - row0));
  const long long base = (static_cast<long long>(b) * S + row0) * d;
  const float inv_d = 1.f / static_cast<float>(d);

  int col[PV];
  bool on[PV];
  float s1[PV][V], sh[PV][V];  // 1 + scale, shift
#pragma unroll
  for (int p = 0; p < PV; ++p) {
    col[p] = (threadIdx.x + p * cx) * V;
    on[p] = col[p] < d;
#pragma unroll
    for (int j = 0; j < V; ++j) s1[p][j] = sh[p][j] = 0.f;
    if (on[p]) {
      load_mod<TM, V>(scale + b * scale_stride + col[p], smod & 1, s1[p]);
      load_mod<TM, V>(shift + b * shift_stride + col[p], smod & 2, sh[p]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) s1[p][j] += 1.f;
  }

  // slot u of step it is row (it * U + u) * ry + ty of the tile
  const int rstep = ry * U;
  const int n_it = (nrows + rstep - 1) / rstep;  // the same for the block
  auto load = [&](int it, uint32_t (&w)[U][PV][W]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = (it * U + u) * ry + threadIdx.y;
#pragma unroll
      for (int p = 0; p < PV; ++p) {
        if (r < nrows && on[p]) {
          load_raw<T, V>(x + base + static_cast<long long>(r) * d + col[p],
                         w[u][p]);
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k) w[u][p][k] = 0u;
        }
      }
    }
  };

  uint32_t cur[U][PV][W], nxt[U][PV][W];
  if (n_it > 0) load(0, cur);
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load(it + 1, nxt);  // in flight while this reduces
    float xf[U][PV][V], v[U], mean[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float sx = 0.f;
#pragma unroll
      for (int p = 0; p < PV; ++p) {
        unpack<T, V>(cur[u][p], xf[u][p]);
#pragma unroll
        for (int j = 0; j < V; ++j) sx += xf[u][p][j];
      }
      v[u] = sx;
    }
    group_sum<U>(v, red[0]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      mean[u] = v[u] * inv_d;
      float sq = 0.f;
#pragma unroll
      for (int p = 0; p < PV; ++p) {
        if (!on[p]) continue;  // its zeros are not (0 - mean)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float c = xf[u][p][j] - mean[u];
          sq = fmaf(c, c, sq);
        }
      }
      v[u] = sq;
    }
    group_sum<U>(v, red[1]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float rstd = rsqrtf(fmaf(v[u], inv_d, eps));
      const int r = (it * U + u) * ry + threadIdx.y;
      if (r >= nrows) continue;
#pragma unroll
      for (int p = 0; p < PV; ++p) {
        if (!on[p]) continue;
        float y[V];
#pragma unroll
        for (int j = 0; j < V; ++j)
          y[j] = fmaf((xf[u][p][j] - mean[u]) * rstd, s1[p][j], sh[p][j]);
        store_vec<T, V>(out + base + static_cast<long long>(r) * d + col[p],
                        y);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int p = 0; p < PV; ++p)
#pragma unroll
        for (int k = 0; k < W; ++k) cur[u][p][k] = nxt[u][p][k];
  }
}

// grid (n_tiles, B) in clusters of (cl, 1, 1); block (tile, b) owns rows
// [tile * tile_rows, ...) of example b. dsums: d_scale then d_shift, each
// (B, d) in TM, out_stream elements apart.
template <typename T, typename TM, int V, int PV>
__global__ void __launch_bounds__(kMaxThreads)
    ln_mod_bwd_kernel(const T* __restrict__ x, const TM* __restrict__ scale,
                      const T* __restrict__ g, T* __restrict__ dx,
                      TM* __restrict__ dsums, long long out_stream,
                      float* __restrict__ scratch,
                      unsigned* __restrict__ tickets, int S, int d,
                      long long scale_stride, int tile_rows, int n_clusters,
                      bool svec, float eps) {
  constexpr int U = 4 / PV;
  extern __shared__ __align__(16) float sm[];
  // one buffer a round, so a round's writes never meet the other's reads
  __shared__ float red[2][kMaxWarps][2 * U];
  const int cx = blockDim.x, ry = blockDim.y;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * tile_rows;
  const int nrows = max(0, min(tile_rows, S - row0));
  const long long base = (static_cast<long long>(b) * S + row0) * d;
  const float inv_d = 1.f / static_cast<float>(d);

  int col[PV];
  bool on[PV];
  float s1[PV][V];  // 1 + scale
  float acc[2][PV][V];  // sums of g * xhat and of g
#pragma unroll
  for (int p = 0; p < PV; ++p) {
    col[p] = (threadIdx.x + p * cx) * V;
    on[p] = col[p] < d;
    float m[V];
    if (on[p]) {
      load_mod<TM, V>(scale + b * scale_stride + col[p], svec, m);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) m[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1[p][j] = 1.f + m[j];
      acc[0][p][j] = 0.f;
      acc[1][p][j] = 0.f;
    }
  }

  // The tile's rows stream through a ring of kStages steps in shared
  // memory: kStages - 1 steps of copies in flight while a step reduces.
  // Slot u of step it is row (it * U + u) * ry + ty of the tile; a thread
  // reads back only the vectors it copied, so the ring needs no barrier.
  constexpr int kBytes = V * static_cast<int>(sizeof(T));  // a vector
  const int rstep = ry * U;
  const int n_it = (nrows + rstep - 1) / rstep;  // the same for the block
  auto slot = [&](int stage, int u, int stream, int p) {
    return reinterpret_cast<char*>(sm) +
           ((((stage * U + u) * 2 + stream) * PV + p) * ry * cx +
            threadIdx.y * cx + threadIdx.x) * kBytes;
  };
  auto issue = [&](int it) {
    if (it < n_it) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = (it * U + u) * ry + threadIdx.y;
#pragma unroll
        for (int p = 0; p < PV; ++p) {
          const bool ok = r < nrows && on[p];
          const long long off =
              ok ? base + static_cast<long long>(r) * d + col[p] : 0;
#pragma unroll
          for (int stream = 0; stream < 2; ++stream) {
            const uint32_t dst =
                rtmma::smem_addr(slot(it % kStages, u, stream, p));
            const T* src = (stream == 0 ? x : g) + off;
            if constexpr (kBytes == 16)
              rtmma::cp_async_16(dst, src, ok);
            else
              rtmma::cp_async_8(dst, src, ok);
          }
        }
      }
    }
    rtmma::cp_async_commit();  // empty past the tile: the count stays even
  };

  // one step: its rows as floats, each read once from the ring
  auto step = [&](const float (&xf)[U][PV][V], const float (&gf)[U][PV][V],
                  int it) {
    float v[2 * U], mean[U], mdy[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float sx = 0.f, sdy = 0.f;
#pragma unroll
      for (int p = 0; p < PV; ++p) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sx += xf[u][p][j];
          sdy = fmaf(gf[u][p][j], s1[p][j], sdy);
        }
      }
      v[2 * u] = sx;
      v[2 * u + 1] = sdy;
    }
    group_sum<2 * U>(v, red[0]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      mean[u] = v[2 * u] * inv_d;
      mdy[u] = v[2 * u + 1] * inv_d;
      float sq = 0.f, sdyx = 0.f;
#pragma unroll
      for (int p = 0; p < PV; ++p) {
        if (!on[p]) continue;  // its zeros are not (0 - mean)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float t = xf[u][p][j] - mean[u];
          sq = fmaf(t, t, sq);
          sdyx = fmaf(gf[u][p][j] * s1[p][j], t, sdyx);
        }
      }
      v[2 * u] = sq;
      v[2 * u + 1] = sdyx;
    }
    group_sum<2 * U>(v, red[1]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // dx = rstd dy + (-rstd mean(dy xhat)) xhat + (-rstd mean(dy))
      const float rstd = rsqrtf(fmaf(v[2 * u], inv_d, eps));
      const float c1 = -(v[2 * u + 1] * inv_d * rstd) * rstd;
      const float c0 = -mdy[u] * rstd;
      const int r = (it * U + u) * ry + threadIdx.y;
#pragma unroll
      for (int p = 0; p < PV; ++p) {
        if (!on[p]) continue;
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xhat = (xf[u][p][j] - mean[u]) * rstd;
          o[j] = fmaf(gf[u][p][j] * s1[p][j], rstd, fmaf(xhat, c1, c0));
          acc[0][p][j] = fmaf(gf[u][p][j], xhat, acc[0][p][j]);
          acc[1][p][j] += gf[u][p][j];
        }
        if (r < nrows)
          store_vec<T, V>(dx + base + static_cast<long long>(r) * d + col[p],
                          o);
      }
    }
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int it = 0; it < n_it; ++it) {
    rtmma::cp_async_wait<kStages - 2>();  // step it has landed
    issue(it + kStages - 1);              // into the slot step it - 1 left
    float xf[U][PV][V], gf[U][PV][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int p = 0; p < PV; ++p) {
        load_vec<T, V>(reinterpret_cast<const T*>(slot(it % kStages, u, 0, p)),
                       xf[u][p]);
        load_vec<T, V>(reinterpret_cast<const T*>(slot(it % kStages, u, 1, p)),
                       gf[u][p]);
      }
    step(xf, gf, it);
  }
  rtmma::cp_async_wait<0>();
  __syncthreads();  // the ring's memory becomes the epilogue's

  const int cl = gridDim.x / n_clusters;
  const rowwise::ColumnSums<TM> cs{dsums, out_stream, scratch,
                                   tickets + b * cl, d, b, 0, d, n_clusters};
  rowwise::column_sums<2, PV, V>(acc, sm, cs);
}

struct FwdArgs {
  const void *x, *scale, *shift;
  void* out;
  int B, S, d;
  long long scale_stride, shift_stride;
  float eps;
  cudaStream_t st;
};

// The row-wise kernels' thread shape for a row of dv vectors, PV a thread:
// cx threads along the row (whole warps), ry row groups, 256 threads where
// the row is narrower than that.
inline void row_shape(rowwise::Plan& p, int dv, int PV) {
  p.cx = ((dv + PV - 1) / PV + 31) / 32 * 32;
  p.ry = p.cx >= 256 ? 1 : 256 / p.cx;
}

// Whether a (B, d) vector at p with row stride `stride` elements can be
// read as one V-element vector a thread (V * sizeof(TM) bytes, at most 16).
template <typename TM, int V>
bool mod_vec(const void* p, long long stride) {
  constexpr int kAlign = V * sizeof(TM) < 16 ? V * sizeof(TM) : 16;
  return reinterpret_cast<uintptr_t>(p) % kAlign == 0 &&
         stride * static_cast<long long>(sizeof(TM)) % kAlign == 0;
}

// Tiles for steps of U rows, then the launch (or, with sizes, the plan).
template <typename T, typename TM, int V, int PV, int U>
cudaError_t launch_fwd(const FwdArgs& a, rowwise::Plan& p, int bc,
                       long long* sizes) {
  auto kernel = ln_mod_fwd_kernel<T, TM, V, PV, U>;
  if (!rowwise::plan_tiles(kernel, p, bc, a.S, 1, p.ry * U, 1))
    return cudaErrorInvalidConfiguration;
  if (sizes != nullptr) {
    rowwise::report(p, 0, 0, sizes);
    return cudaSuccess;
  }
  const int smod = (mod_vec<TM, V>(a.scale, a.scale_stride) ? 1 : 0) |
                   (mod_vec<TM, V>(a.shift, a.shift_stride) ? 2 : 0);
  for (int b0 = 0; b0 < a.B; b0 += kMaxGridY) {
    const int nb = a.B - b0 < kMaxGridY ? a.B - b0 : kMaxGridY;
    const long long off = static_cast<long long>(b0) * a.S * a.d;
    kernel<<<dim3(p.n_tiles, nb, 1), dim3(p.cx, p.ry, 1), 0, a.st>>>(
        static_cast<const T*>(a.x) + off,
        static_cast<const TM*>(a.scale) + b0 * a.scale_stride,
        static_cast<const TM*>(a.shift) + b0 * a.shift_stride,
        static_cast<T*>(a.out) + off, a.S, a.d, a.scale_stride,
        a.shift_stride, p.tile_rows, smod, a.eps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The forward's plan for these shapes; with sizes, only report it
// (rowwise::report: no scratch, no tickets, cl 1), else launch. Steps of
// 8 / PV rows where the example's steps give every block of a wave one
// (timed faster at the two-pass path's (8, 512, 2048): PERF.md), else of
// 4 / PV rows, which fill the card at fewer rows (S = 130).
template <typename T, typename TM, int V, int PV>
cudaError_t run_fwd(const FwdArgs& a, long long* sizes) {
  constexpr int U8 = 8 / PV, U4 = 4 / PV;
  rowwise::Plan p;
  row_shape(p, a.d / V, PV);
  p.smem = 0;
  const int bc = a.B < kMaxGridY ? a.B : kMaxGridY;
  const long long steps8 = (a.S + p.ry * U8 - 1) / (p.ry * U8);
  if (steps8 * bc >=
      rowwise::wave_blocks(ln_mod_fwd_kernel<T, TM, V, PV, U8>, p, 1))
    return launch_fwd<T, TM, V, PV, U8>(a, p, bc, sizes);
  return launch_fwd<T, TM, V, PV, U4>(a, p, bc, sizes);
}

// PV column vectors a thread: one up to 512 vectors a row, else 2 or 4.
template <typename T, typename TM, int V>
cudaError_t run_fwd_v(const FwdArgs& a, long long* sizes) {
  const int dv = a.d / V;
  if (dv <= kMaxThreads) return run_fwd<T, TM, V, 1>(a, sizes);
  if (dv <= 2 * kMaxThreads) return run_fwd<T, TM, V, 2>(a, sizes);
  if (dv <= 4 * kMaxThreads) return run_fwd<T, TM, V, 4>(a, sizes);
  return cudaErrorInvalidValue;
}

// 16-byte vectors; bf16 rows whose d is not a multiple of 8 take 8 bytes.
template <typename T, typename TM>
cudaError_t run_fwd_t(const FwdArgs& a, long long* sizes) {
  if constexpr (sizeof(T) == 2) {
    if (a.d % 8 == 0) return run_fwd_v<T, TM, 8>(a, sizes);
  }
  return run_fwd_v<T, TM, 4>(a, sizes);
}

cudaError_t dispatch_fwd(const FwdArgs& a, int x_dtype, int mod_dtype,
                         long long* sizes) {
  if (a.d % 4 != 0 || a.B < 1 || a.S < 1) return cudaErrorInvalidValue;
  switch (x_dtype * 2 + mod_dtype) {
    case 0: return run_fwd_t<float, float>(a, sizes);
    case 1: return run_fwd_t<float, __nv_bfloat16>(a, sizes);
    case 2: return run_fwd_t<__nv_bfloat16, float>(a, sizes);
    case 3: return run_fwd_t<__nv_bfloat16, __nv_bfloat16>(a, sizes);
    default: return cudaErrorInvalidValue;
  }
}

struct BwdArgs {
  const void *x, *scale, *g;
  void *dx, *dsums;
  float* scratch;
  unsigned* tickets;
  int B, S, d;
  long long scale_stride;
  float eps;
  cudaStream_t st;
};

// The backward's plan for these shapes; with sizes, only report it
// (rowwise::report), else launch.
template <typename T, typename TM, int V, int PV>
cudaError_t run_bwd(const BwdArgs& a, long long* sizes) {
  constexpr int U = 4 / PV;
  auto kernel = ln_mod_bwd_kernel<T, TM, V, PV>;
  rowwise::Plan p;
  row_shape(p, a.d / V, PV);
  const size_t ring = static_cast<size_t>(kStages) * U * 2 * PV * p.ry *
                      p.cx * V * sizeof(T);
  const size_t sums = sizeof(float) * p.ry * 2 * p.cx * PV * V;
  p.smem = ring > sums ? ring : sums;
  cudaError_t e = rowwise::allow_smem(kernel, p.smem);
  if (e != cudaSuccess) return e;
  const int bc = a.B < kMaxGridY ? a.B : kMaxGridY;
  if (!rowwise::plan_tiles(kernel, p, bc, a.S, 1, p.ry * U))
    return cudaErrorInvalidConfiguration;
  const int ncl = p.n_clusters();
  if (sizes != nullptr) {
    rowwise::report(p, ncl > 1 ? 2LL * bc * ncl * a.d : 0,
                    static_cast<long long>(bc) * p.cl, sizes);
    return cudaSuccess;
  }
  // the scale as one vector a thread where its slice allows
  const bool svec = mod_vec<TM, V>(a.scale, a.scale_stride);
  const long long out_stream = static_cast<long long>(a.B) * a.d;
  for (int b0 = 0; b0 < a.B; b0 += kMaxGridY) {
    const int nb = a.B - b0 < kMaxGridY ? a.B - b0 : kMaxGridY;
    const long long off = static_cast<long long>(b0) * a.S * a.d;
    e = rowwise::launch_clusters(
        kernel, dim3(p.n_tiles, nb, 1), dim3(p.cx, p.ry, 1), p.smem, p.cl,
        a.st, static_cast<const T*>(a.x) + off,
        static_cast<const TM*>(a.scale) + b0 * a.scale_stride,
        static_cast<const T*>(a.g) + off, static_cast<T*>(a.dx) + off,
        static_cast<TM*>(a.dsums) + static_cast<long long>(b0) * a.d,
        out_stream, a.scratch, a.tickets, a.S, a.d, a.scale_stride,
        p.tile_rows, ncl, svec, a.eps);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// PV column vectors a thread: one up to 512 vectors a row, else 2 or 4.
template <typename T, typename TM, int V>
cudaError_t run_bwd_v(const BwdArgs& a, long long* sizes) {
  const int dv = a.d / V;
  if (dv <= kMaxThreads) return run_bwd<T, TM, V, 1>(a, sizes);
  if (dv <= 2 * kMaxThreads) return run_bwd<T, TM, V, 2>(a, sizes);
  if (dv <= 4 * kMaxThreads) return run_bwd<T, TM, V, 4>(a, sizes);
  return cudaErrorInvalidValue;
}

// 16-byte vectors (8 bf16 or 4 fp32 elements); bf16 rows whose d is not a
// multiple of 8 are not 16-byte aligned, and take 8-byte vectors.
template <typename T, typename TM>
cudaError_t run_bwd_t(const BwdArgs& a, long long* sizes) {
  if constexpr (sizeof(T) == 2) {
    if (a.d % 8 == 0) return run_bwd_v<T, TM, 8>(a, sizes);
  }
  return run_bwd_v<T, TM, 4>(a, sizes);
}

cudaError_t dispatch_bwd(const BwdArgs& a, int x_dtype, int mod_dtype,
                         long long* sizes) {
  if (a.d % 4 != 0 || a.B < 1 || a.S < 1) return cudaErrorInvalidValue;
  switch (x_dtype * 2 + mod_dtype) {
    case 0: return run_bwd_t<float, float>(a, sizes);
    case 1: return run_bwd_t<float, __nv_bfloat16>(a, sizes);
    case 2: return run_bwd_t<__nv_bfloat16, float>(a, sizes);
    case 3: return run_bwd_t<__nv_bfloat16, __nv_bfloat16>(a, sizes);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (B, S, d) contiguous in x_dtype; scale, shift: (B, d) in
// mod_dtype with unit stride along d and row strides scale_stride,
// shift_stride. x_dtype / mod_dtype: 0 fp32, 1 bf16. d % 4 == 0, d at
// most 2048 vectors.
extern "C" int rt_ln_modulate_fwd(const void* x, const void* scale,
                                  const void* shift, void* out, int B, int S,
                                  int d, long long scale_stride,
                                  long long shift_stride, float eps,
                                  int x_dtype, int mod_dtype, void* stream) {
  const FwdArgs a = {x, scale, shift, out, B, S, d, scale_stride,
                     shift_stride, eps, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_fwd(a, x_dtype, mod_dtype, nullptr));
}

// The forward's plan for these shapes on the current device, into
// sizes[rowwise::kPlanFields], as rt_ln_modulate_bwd_plan reports the
// backward's (scratch and tickets 0, cl 1).
extern "C" int rt_ln_modulate_fwd_plan(int B, int S, int d, int x_dtype,
                                       int mod_dtype, long long* sizes) {
  FwdArgs a = {};
  a.B = B;
  a.S = S;
  a.d = d;
  return static_cast<int>(dispatch_fwd(a, x_dtype, mod_dtype, sizes));
}

// The backward's plan for these shapes on the current device, into
// sizes[rowwise::kPlanFields]: fp32 scratch elements, unsigned tickets
// (zero before the first launch; each launch leaves them zero), cx, ry,
// tile_rows, n_tiles, cl.
extern "C" int rt_ln_modulate_bwd_plan(int B, int S, int d, int x_dtype,
                                       int mod_dtype, long long* sizes) {
  BwdArgs a = {};
  a.B = B;
  a.S = S;
  a.d = d;
  return static_cast<int>(dispatch_bwd(a, x_dtype, mod_dtype, sizes));
}

// x, g, dx: (B, S, d) contiguous in x_dtype; scale (B, d) in mod_dtype with
// row stride scale_stride; dsums (2, B, d) in mod_dtype: d_scale, d_shift.
// scratch and tickets as rt_ln_modulate_bwd_plan sizes them. d % 4 == 0,
// d at most 2048 vectors.
extern "C" int rt_ln_modulate_bwd(const void* x, const void* scale,
                                  const void* g, void* dx, void* dsums,
                                  void* scratch, void* tickets, int B, int S,
                                  int d, long long scale_stride, float eps,
                                  int x_dtype, int mod_dtype, void* stream) {
  const BwdArgs a = {x, scale, g, dx, dsums, static_cast<float*>(scratch),
                     static_cast<unsigned*>(tickets), B, S, d, scale_stride,
                     eps, static_cast<cudaStream_t>(stream)};
  const cudaError_t e = dispatch_bwd(a, x_dtype, mod_dtype, nullptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
