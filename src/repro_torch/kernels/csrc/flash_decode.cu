// Flash-decode over a paged KV pool (one query token per slot, G grouped
// query heads per KV head), for sm_90a. Replaces the Pallas TPU kernel
// src/repro/kernels/flash_decode.py:51 (_decode_kernel, called through
// flash_decode at :114). Design and bounds: see paged_attention.cuh.
//
// One block of 8 warps per (slot, kv_head); the 8 warps split the slot's
// committed keys in interleaved 32-key tiles and merge at the end, which
// keeps B*KV blocks of latency-bound page reads in flight. The G rows are
// handled together, padded to R = 1, 2, 4 or 8 rows per warp.
#include "paged_attention.cuh"

extern "C" int rt_flash_decode(const void* q, int q_bf16, const void* k_pages,
                               const void* v_pages, const void* k_scale,
                               const void* v_scale, const void* page_table,
                               const void* lengths, void* out, void* lse,
                               int B, int KV, int G, int hd, int npg, int psz,
                               int window, float scale, int page_dtype,
                               void* stream) {
  int R = 1;
  while (R < G) R *= 2;
  if (R > 8) return static_cast<int>(cudaErrorInvalidValue);
  rtk::PagedArgs a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.page_table = static_cast<const int*>(page_table);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.q_bf16 = q_bf16;
  a.C = 1;
  a.KV = KV;
  a.G = G;
  a.npg = npg;
  a.psz = psz;
  a.window = window;
  a.scale = scale;
  a.nrg = 1;
  return rtk::launch_paged<false>(a, B, hd, page_dtype, R, /*nwarps=*/8,
                                  /*grid_y=*/1,
                                  static_cast<cudaStream_t>(stream));
}
