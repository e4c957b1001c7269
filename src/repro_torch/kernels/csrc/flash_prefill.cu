// Chunked-prefill attention over a paged KV pool (a chunk of C query tokens
// per slot, G grouped heads each, so C*G rows per KV head), for sm_90a.
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill.py:52
// (_prefill_kernel, called through flash_prefill at :114). Design and
// bounds: see paged_attention.cuh.
//
// One block of 8 warps per (slot, kv_head, tile of rows): each warp owns 8
// rows; up to 4 warps split the rows and the others split the keys. The
// block stops at the last key its last row can see, lengths[b] + i_last.
#include "paged_attention.cuh"

extern "C" int rt_flash_prefill(const void* q, int q_bf16,
                                const void* k_pages, const void* v_pages,
                                const void* k_scale, const void* v_scale,
                                const void* page_table, const void* lengths,
                                void* out, int B, int C, int KV, int G, int hd,
                                int npg, int psz, int window, float scale,
                                int page_dtype, void* stream) {
  constexpr int R = 8;
  constexpr int nwarps = 8;
  const int rows = C * G;
  const int nrg = rows <= R ? 1 : rows <= 2 * R ? 2 : 4;
  const int grid_y = (rows + R * nrg - 1) / (R * nrg);
  rtk::PagedArgs a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.page_table = static_cast<const int*>(page_table);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.lse = nullptr;
  a.q_bf16 = q_bf16;
  a.C = C;
  a.KV = KV;
  a.G = G;
  a.npg = npg;
  a.psz = psz;
  a.window = window;
  a.scale = scale;
  a.nrg = nrg;
  return rtk::launch_paged<true>(a, B, hd, page_dtype, R, nwarps, grid_y,
                                 static_cast<cudaStream_t>(stream));
}
