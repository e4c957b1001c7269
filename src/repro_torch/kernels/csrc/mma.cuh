// Tensor-core building blocks for sm_80+ kernels (used on sm_90a): warp-wide
// bf16 matrix products (mma.sync m16n8k16, fp32 accumulators), tf32 ones
// (m16n8k8) with the 3xTF32 split that keeps fp32 accuracy, ldmatrix
// fragment loads from shared memory, cp.async 16-, 8- and 4-byte copies from
// global to shared memory with zero-fill, and the XOR swizzle that keeps
// ldmatrix's row reads free of bank conflicts.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 x b32: a[0] = (g, 2t..2t+1),
//     a[1] = (g + 8, 2t..), a[2] = (g, 2t + 8..), a[3] = (g + 8, 2t + 8..);
//   B (16 x 8, k x n), 2 x b32: b[0] = (k 2t..2t+1, n g), b[1] = (k 2t + 8..,
//     n g);
//   C/D (16 x 8, fp32), 4 floats: c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8,
//     2t..2t+1).
// So two adjacent n8 accumulator tiles, packed to bf16 pairs, are an A
// fragment of the next product (the score-to-probability register reuse of
// FlashAttention-2).
//
// m16n8k8 with tf32 inputs (one 32-bit register an element):
//   A (16 x 8): a[0] = (g, t), a[1] = (g + 8, t), a[2] = (g, t + 4),
//     a[3] = (g + 8, t + 4);
//   B (8 x 8, k x n): b[0] = (k t, n g), b[1] = (k t + 4, n g);
//   C/D as above.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rtmma {

// D = A * B + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and register j receives matrix j's (row g, columns 2t..2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, transposed: register j receives matrix j's (rows 2t..2t+1,
// column g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Copy 16 bytes from global to shared memory without passing through
// registers; with `valid` false nothing is read and the 16 bytes are zeroed
// (src-size 0), so a tile's rows past the sequence end are zeros.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

// Copy 8 bytes (cp.async.ca); both addresses 8-byte aligned. With `valid`
// false nothing is read and the 8 bytes are zeroed.
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 8 : 0));
}

// Copy 4 bytes from global to shared memory (cp.async.ca: the 4- and
// 8-byte sizes go through L1); both addresses 4-byte aligned. With `valid`
// false nothing is read and the 4 bytes are zeroed.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Offset in 2-byte elements of 16-byte chunk `chunk` of row `row` in a
// shared tile of rows CHUNKS x 16 bytes wide (CHUNKS a multiple of 8): the
// chunk index is XORed with row % 8, so the eight rows one ldmatrix phase
// reads at the same logical chunk fall in eight different bank groups.
template <int CHUNKS>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  static_assert(CHUNKS % 8 == 0, "rows of whole 128-byte lines");
  return (row * CHUNKS + (chunk ^ (row & 7))) * 8;
}

// 2^x by the special-function unit (max relative error about 2^-22;
// results below 2^-126 flush to 0, so 2^-1e30 is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as a bf16 pair (x in the low half), as a b32 fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats as two bf16 pairs whose sum keeps ~16 bits of mantissa:
// hi = bf16(x), lo = bf16(x - hi). A product with hi and one with lo, into
// one fp32 accumulator, gives x times a bf16 operand to ~2^-17 relative,
// where hi alone is off by up to 2^-9.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// Two adjacent n8 accumulator tiles (c0: columns 0..7, c1: 8..15 of a
// 16 x 16 fp32 tile) as the hi and lo bf16 A fragments of the next product.
__device__ __forceinline__ void split_a_frag(const float (&c0)[4],
                                             const float (&c1)[4],
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// d0 += (hi + lo) b[0..1] and d1 += (hi + lo) b[2..3]: the split A operand
// times the two n8 B fragments that one ldmatrix_x4(_trans) gives.
__device__ __forceinline__ void mma_bf16_split(float (&d0)[4], float (&d1)[4],
                                               const uint32_t (&hi)[4],
                                               const uint32_t (&lo)[4],
                                               const uint32_t (&b)[4]) {
  mma_bf16(d0, hi, b[0], b[1]);
  mma_bf16(d0, lo, b[0], b[1]);
  mma_bf16(d1, hi, b[2], b[3]);
  mma_bf16(d1, lo, b[2], b[3]);
}

// D = A * B + D, tf32 inputs (fp32 bit patterns; the low 13 mantissa bits
// are ignored), fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as big + small for a 3xTF32 product. The tensor cores read a tf32
// operand's top 19 bits and ignore its low 13 (ptxas's own expansion of
// cvt.rna.tf32.f32 hands them x + 0x1000 unmasked). So big is x plus half a
// tf32 ulp, which they read as x rounded to nearest (ties away), and small
// is x - that rounded value (exact in fp32), which they read truncated to
// tf32: big + small keeps ~21 bits of x's mantissa, where big alone keeps
// 11. Three instructions; cvt.rna of both also guards each value against
// Inf and NaN, which finite operands never need, and the splits are most
// of a 3xTF32 kernel's instructions.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// d += A B at fp32 accuracy from split operands (3xTF32): the two cross
// terms first, then big * big; small * small (~2^-22 relative) is dropped.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           uint32_t b0_big, uint32_t b1_big,
                                           uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32(d, a_small, b0_big, b1_big);
  mma_tf32(d, a_big, b0_small, b1_small);
  mma_tf32(d, a_big, b0_big, b1_big);
}

}  // namespace rtmma
