// Helpers shared by the row-wise elementwise kernels (gate_residual.cu,
// ln_modulate.cu, edm_loss.cu, euler.cu): fp32 widening, V-wide vector
// loads and stores (8, 16 or 32 bytes a thread, so a warp's access is
// coalesced), warp / block sums in fp32, and what the two AdaLN backwards
// share: the tiling of an example's rows over the card and the sum of the
// per-example (B, d) column sums across tiles.
#pragma once

#include <stdint.h>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rowwise {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 32-bit words that V elements of T take (2: one 8-byte access; 4 or 8:
// one or two 16-byte accesses).
template <typename T, int V>
constexpr int kWords = V * static_cast<int>(sizeof(T)) / 4;

// V elements of T at p (8, 16 or 32 bytes, aligned to min(16, that)), as
// they lie in memory.
template <typename T, int V>
__device__ __forceinline__ void load_raw(const T* p,
                                         uint32_t (&w)[kWords<T, V>]) {
  constexpr int W = kWords<T, V>;
  static_assert(W == 2 || W % 4 == 0, "8-byte or 16-byte pieces");
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
}

// The words of load_raw as floats; bf16 widened exactly (its bits are the
// top half of an fp32).
template <typename T, int V>
__device__ __forceinline__ void unpack(const uint32_t (&w)[kWords<T, V>],
                                       float (&o)[V]) {
#pragma unroll
  for (int j = 0; j < kWords<T, V>; ++j) {
    if constexpr (sizeof(T) == 4) {
      o[j] = __uint_as_float(w[j]);
    } else {
      o[2 * j] = __uint_as_float(w[j] << 16);
      o[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[V]) {
  uint32_t w[kWords<T, V>];
  load_raw<T, V>(p, w);
  unpack<T, V>(w, o);
}

// The V floats v stored at p as T (bf16 rounded to nearest), as load_vec.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  constexpr int W = kWords<T, V>;
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

// V elements of a per-example (B, d) vector at p: one vector load where
// the slice allows it (vec), else V scalar loads. Once per thread.
template <typename T, int V>
__device__ __forceinline__ void load_mod(const T* p, bool vec,
                                         float (&o)[V]) {
  if (vec) {
    load_vec<T, V>(p, o);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = to_f(p[j]);
  }
}

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

// ---------------------------------------------------------------------------
// The AdaLN backwards' (B, d) column sums over an example's S rows.
//
// A block owns a tile of rows of one example and a span of columns; its
// threads are (cx, ry): thread (tx, ty) owns the column vectors tx + p * cx
// (p < PV) of the span and walks rows ty, ty + ry, ... of the tile, so its
// sums of each column stay in registers. The tiles of one (example, column
// span) form n_tiles / cl clusters of cl consecutive tiles. The epilogue:
//   1. each block puts its threads' sums in shared memory, [ty][s][column],
//      and adds its row groups' sums, in group order;
//   2. block rank k of a cluster sums column chunk k over the cluster's
//      blocks (distributed shared memory), in rank order;
//   3. with one cluster the result is the output; else each rank-k block
//      writes its chunk to scratch[b][cluster][s][column], and the last of
//      the rank-k blocks to arrive (an atomic ticket it then resets, so the
//      ticket array is zero again after every launch and the launch can be
//      replayed from a CUDA graph) sums the clusters' chunks in cluster
//      order.
// Every sum runs in a fixed order, so two launches give bit-equal results;
// no float atomics. (The TPU kernels wrote (B, n_tiles, d) partials that
// the caller summed outside them.)
// ---------------------------------------------------------------------------

// A launch plan: grid (n_tiles, B, column spans) in clusters of (cl, 1, 1),
// blocks of (cx, ry) threads walking tile_rows rows each.
struct Plan {
  int cx, ry, tile_rows, n_tiles, cl;
  size_t smem;  // dynamic shared memory a block
  int n_clusters() const { return n_tiles / cl; }
};

// SMs of the current device, asked once per device.
inline int sm_count() {
  static int cache[64];
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < 64;
  if (cached && cache[dev] > 0) return cache[dev];
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (cached) cache[dev] = n;
  return n > 0 ? n : 1;
}

// Blocks a launch plans on each SM: two, so that one block's loads are in
// flight while the other reduces. Clusters of at most 2: clusters of 4 fit
// fewer blocks a wave and were slower at the two-pass path's shapes
// (PERF.md, PR 21).
constexpr int kBlocksPerSM = 2;
constexpr int kMaxCluster = 2;

// Blocks of kernel with p's shape that fit the card at once in clusters of
// cl (clusters are placed whole, so fewer may fit than blocks alone),
// capped at kBlocksPerSM an SM.
template <typename... Params>
int wave_blocks(void (*kernel)(Params...), const Plan& p, int cl) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1, 1);
  cfg.blockDim = dim3(p.cx, p.ry, 1);
  cfg.dynamicSmemBytes = p.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();  // clear it: the caller tries a smaller cluster
    return 0;
  }
  const int cap = sm_count() * kBlocksPerSM;
  return clusters * cl < cap ? clusters * cl : cap;
}

// Tiles of an example's S rows for B x spans (example, column span) pairs,
// each block stepping rstep rows at a time: as many tiles as one wave of
// the card holds (kernel's own occupancy, in clusters of max_cl where each
// pair gets at least one, else of half that, down to 1), rounded down to a
// multiple of the cluster, then rows spread evenly in whole steps. Returns
// false if no block fits an SM.
template <typename... Params>
bool plan_tiles(void (*kernel)(Params...), Plan& p, int B, int S, int spans,
                int rstep, int max_cl = kMaxCluster) {
  const int steps = (S + rstep - 1) / rstep;
  int n = 0;
  for (p.cl = max_cl;; p.cl /= 2) {
    const int cap = wave_blocks(kernel, p, p.cl);
    n = cap / (B * spans) < steps ? cap / (B * spans) : steps;
    if (n >= p.cl) break;
    if (p.cl == 1) {
      if (cap < 1) return false;
      n = 1;  // more pairs than a wave holds: a tile each, several waves
      break;
    }
  }
  n = n / p.cl * p.cl;
  const int per = (S + n - 1) / n;
  p.tile_rows = (per + rstep - 1) / rstep * rstep;
  const int used = (S + p.tile_rows - 1) / p.tile_rows;
  p.n_tiles = (used + p.cl - 1) / p.cl * p.cl;
  return true;
}

// What a backward's plan function reports: the fp32 scratch elements and
// tickets a launch needs, then the plan (cx, ry, tile_rows, n_tiles, cl).
constexpr int kPlanFields = 7;
inline void report(const Plan& p, long long scratch, long long tickets,
                   long long* out) {
  const long long f[kPlanFields] = {scratch, tickets, p.cx, p.ry,
                                    p.tile_rows, p.n_tiles, p.cl};
  for (int i = 0; i < kPlanFields; ++i) out[i] = f[i];
}

// Let kernel take smem bytes of dynamic shared memory: past 40 KB it must
// ask, as dynamic and static shared memory together may pass the default
// 48 KB.
template <typename... Params>
cudaError_t allow_smem(void (*kernel)(Params...), size_t smem) {
  if (smem <= 40 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launch kernel on grid in clusters of (cl, 1, 1) (allow_smem first).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, dim3 block,
                            size_t smem, int cl, cudaStream_t st,
                            Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Where the epilogue puts the sums of column span [col0, col0 + ncols) of
// example b: out + s * out_stream + b * d + column (NS streams, in TO);
// scratch (B, n_clusters, NS, d) fp32 and the span's cl tickets, used when
// there is more than one cluster.
template <typename TO>
struct ColumnSums {
  TO* out;
  long long out_stream;
  float* scratch;
  unsigned* tickets;
  int d, b, col0, ncols, n_clusters;
};

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float4& v) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  store_vec<T, 4>(p, f);
}

// Clusters whose chunks the ticket's last block loads at once.
constexpr int kScratchBatch = 8;

// The epilogue above for this thread's sums acc[s][p][j] of stream s,
// column (tx + p * cx) * V + j of the span. sm: the block's dynamic shared
// memory, ry * NS * cx * PV * V floats. Every thread of every block of the
// cluster calls it. Columns move as float4s (d and the span are multiples
// of 4), and each stage issues all its loads before it adds.
template <int NS, int PV, int V, typename TO>
__device__ __forceinline__ void column_sums(const float (&acc)[NS][PV][V],
                                            float* sm,
                                            const ColumnSums<TO>& cs) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cx = blockDim.x, ry = blockDim.y;
  const int span4 = cx * PV * V / 4;  // float4s a row of sm
  const int q4 = cs.ncols / 4;        // float4 columns of the span
  const int tid = threadIdx.y * cx + threadIdx.x, nthr = cx * ry;
  float4* sm4 = reinterpret_cast<float4*>(sm);
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int p = 0; p < PV; ++p) {
      const int c = (threadIdx.x + p * cx) * V;
      if (c < cs.ncols) {
#pragma unroll
        for (int j = 0; j < V; j += 4)
          sm4[(threadIdx.y * NS + s) * span4 + (c + j) / 4] = make_float4(
              acc[s][p][j], acc[s][p][j + 1], acc[s][p][j + 2],
              acc[s][p][j + 3]);
      }
    }
  if (ry > 1) {  // the row groups summed into group 0, in group order
    __syncthreads();
    for (int k = tid; k < NS * q4; k += nthr) {
      const int s = k / q4, c = k - s * q4;
      float4 v = sm4[s * span4 + c];
      for (int y = 1; y < ry; ++y) add4(v, sm4[(y * NS + s) * span4 + c]);
      sm4[s * span4 + c] = v;
    }
  }
  cluster.sync();

  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int chunk = (q4 + cl - 1) / cl;
  const int lo = rank * chunk;
  const int hi = min(q4, lo + chunk);
  const int cluster_id = blockIdx.x / cl;
  const long long row_b = static_cast<long long>(cs.b) * cs.d + cs.col0;
  auto scratch4 = [&](int q, int s, int c) {
    return reinterpret_cast<float4*>(
               cs.scratch + ((static_cast<long long>(cs.b) * cs.n_clusters +
                              q) * NS + s) * cs.d + cs.col0) + c;
  };
  for (int c = lo + tid; c < hi; c += nthr) {
    float4 part[kMaxCluster][NS];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < cl) {
        const float4* peer = cluster.map_shared_rank(sm4, r);
#pragma unroll
        for (int s = 0; s < NS; ++s) part[r][s] = peer[s * span4 + c];
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float4 v = part[0][s];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (r < cl) add4(v, part[r][s]);
      if (cs.n_clusters == 1)
        store4(cs.out + s * cs.out_stream + row_b + 4 * c, v);
      else
        *scratch4(cluster_id, s, c) = v;
    }
  }
  // This block has read its peers' sums; it leaves only once they have
  // read its own (the wait below), and does the ticket's work in between.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (cs.n_clusters > 1) {
    // The block's scratch writes reach the ticket's last block through one
    // acquire-release atomic of thread 0, after a barrier: release and
    // acquire are cumulative over the barrier, so no thread fences alone (a
    // fence of every thread waits for all its dx stores to drain).
    __shared__ bool last;
    __syncthreads();
    if (tid == 0) {
      unsigned* t = cs.tickets + rank;
      unsigned old;
      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                   : "=r"(old)
                   : "l"(t)
                   : "memory");
      last = old == static_cast<unsigned>(cs.n_clusters - 1);
      if (last) *t = 0u;
    }
    __syncthreads();
    if (last) {
      for (int c = lo + tid; c < hi; c += nthr) {
        float4 v[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) v[s] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q0 = 0; q0 < cs.n_clusters; q0 += kScratchBatch) {
          float4 t[kScratchBatch][NS];
#pragma unroll
          for (int k = 0; k < kScratchBatch; ++k) {
            if (q0 + k < cs.n_clusters) {
#pragma unroll
              for (int s = 0; s < NS; ++s)
                t[k][s] = __ldcg(scratch4(q0 + k, s, c));
            }
          }
#pragma unroll
          for (int k = 0; k < kScratchBatch; ++k) {
            if (q0 + k < cs.n_clusters) {
#pragma unroll
              for (int s = 0; s < NS; ++s) add4(v[s], t[k][s]);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < NS; ++s)
          store4(cs.out + s * cs.out_stream + row_b + 4 * c, v[s]);
      }
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace rowwise
