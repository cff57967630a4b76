// Tensor-core building blocks for the hand-written Hopper kernels:
// 16-byte asynchronous copies into shared memory (cp.async), 8 x 8 tile
// loads from shared memory into mma fragments (ldmatrix, plain and
// transposed, and plain on fp32 data for the TF32 fragments), the bf16
// m16n8k16 product and the TF32 m16n8k8 one in a 3xTF32 split, both with
// fp32 accumulators (mma.sync).
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of two bf16: a0 (row g, cols 2t and
//     2t+1), a1 (row g+8, the same cols), a2 (row g, cols 2t+8, 2t+9), a3
//     (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, k by n), 2 registers: b0 (k 2t, 2t+1; col g), b1 (k 2t+8,
//     2t+9; col g);
//   C (16 x 8 fp32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So two n8 accumulator tiles side by side, packed to bf16, are one k16 A
// fragment (the flash kernels feed P and dS to the next product this way).
//
// The TF32 product, mma.sync.m16n8k8 (.tf32 operands, fp32 accumulators),
// has the same C layout; its operands hold one 32-bit value a register:
//   A (16 x 8), 4 registers: a0 (row g, col t), a1 (row g+8, col t), a2
//     (row g, col t+4), a3 (row g+8, col t+4);
//   B (8 x 8, k by n), 2 registers: b0 (k t, col g), b1 (k t+4, col g).
// A product sums over k, so k may be renumbered alike in A and B: the fp32
// flash forward takes k = t as element 2t and k = t+4 as element 2t+1 of
// each group of 8, so a0/a2 (and b0/b1 of a [n][k] tile) are one 8-byte
// pair, and an n8 accumulator tile's (c0, c2, c1, c3) is an A fragment over
// its 8 columns. The 3xTF32 split keeps fp32 accuracy on these units: each
// operand x = hi + lo, hi = x rounded to the nearest TF32 (10 explicit
// mantissa bits, ties away from zero, as cvt.rna.tf32.f32 rounds), lo =
// x - hi (exact in fp32) truncated to TF32, and a b = hi hi + hi lo + lo
// hi in fp32, the dropped lo lo term below 2^-22 of |a b|.
//
// ldmatrix_x4 loads four 8 x 8 b16 tiles; lanes 8i..8i+7 give the row
// addresses of tile i, and each lane receives (row g, cols 2t, 2t+1) of
// each tile: tiles (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k
// 8-15), (rows 8-15, k 8-15) of a row-major operand make an A fragment.
// ldmatrix_x4_trans delivers each tile transposed, (rows 2t, 2t+1; col g):
// the B operand of a product whose reduction dimension runs down the rows
// of shared memory (P V reads V stored [key][d] so).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace pt {

// 16 bytes from global to shared memory, bypassing L1; pred false fills
// the 16 bytes with zeros (gmem must still be a valid address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a * b on the tensor cores: a 16 x 16, b 16 x 8 (bf16), d 16 x 8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------ TF32 (3xTF32) ---------------------------------

// x rounded to the nearest TF32, ties away from zero, as a 32-bit operand:
// the results of cvt.rna.tf32.f32 for every x that is not a NaN, in two
// integer operations (half a unit of the 13 dropped bits added to the
// magnitude, then the bits cleared), which the card issues faster than
// the cvt. A NaN does not survive it (the carry turns the card's
// canonical NaN 0x7fffffff into -0): `split_tf32` keeps it in lo.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 operand (see the layout comment above): hi is
// x rounded to the nearest, lo the rest x - hi (exact in fp32) with its
// low 13 bits cleared, one integer operation. Truncating lo costs a bit
// of the small term (|lo| <= 2^-11 |x|, so lo's error stays below
// 2^-21 |x|) and keeps a NaN: x - hi is NaN for a NaN x whatever hi
// became, and clearing low bits leaves the card's NaN 0x7fffffff a NaN,
// so every product with that operand is NaN. (A select for NaN in
// `tf32_rna` instead, tried, slowed the fp32 flash forward by 58 %: its
// splits are issue-bound on integer operations.)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a * b on the tensor cores: a 16 x 8, b 8 x 8 (TF32), d 16 x 8 fp32.
// A 3xTF32 product is three of these on one accumulator (lo hi, hi lo,
// then hi hi: the small terms first); a caller issues each of the three
// over all its tiles in turn, so no product waits on the one before it.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the split A fragment, in the renumbered k order above, from the pair of
// fp32 elements (2t, 2t+1) of a k8 group in row g (r0) and row g+8 (r8)
__device__ __forceinline__ void split_a_pairs(unsigned (&hi)[4],
                                              unsigned (&lo)[4],
                                              float2 r0, float2 r8) {
  split_tf32(r0.x, hi[0], lo[0]);
  split_tf32(r8.x, hi[1], lo[1]);
  split_tf32(r0.y, hi[2], lo[2]);
  split_tf32(r8.y, hi[3], lo[3]);
}

// a fragment's four fp32 values (x0..x3 for registers 0..3) split into
// hi and lo
__device__ __forceinline__ void split4(float x0, float x1, float x2, float x3,
                                       unsigned (&hi)[4], unsigned (&lo)[4]) {
  split_tf32(x0, hi[0], lo[0]);
  split_tf32(x1, hi[1], lo[1]);
  split_tf32(x2, hi[2], lo[2]);
  split_tf32(x3, hi[3], lo[3]);
}

// the same for fragment registers loaded as raw bits (ldmatrix)
__device__ __forceinline__ void split4(const unsigned (&x)[4],
                                       unsigned (&hi)[4], unsigned (&lo)[4]) {
  split4(__uint_as_float(x[0]), __uint_as_float(x[1]), __uint_as_float(x[2]),
         __uint_as_float(x[3]), hi, lo);
}

// d += a b in 3xTF32: lo hi, hi lo, then hi hi (b0/b1 hi in bh0/bh1, lo in
// bl0/bl1); ptxas interleaves the calls on independent accumulators
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4],
                                           unsigned bh0, unsigned bh1,
                                           unsigned bl0, unsigned bl1) {
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

// ldmatrix on fp32 data: an 8 x 8 b16 tile is 8 rows of 4 floats, and
// lane (g, t) receives float (row g, col t) of it, the TF32 fragments'
// own (unrenumbered) k order. With rows of LD floats, LD = 4 mod 8, the
// 8 rows of a tile fall on distinct banks.
// The A fragment (16 x 8) of rows row0.., cols k0.. of a row-major fp32
// tile: tiles (rows 0-7, k 0-3), (rows 8-15, k 0-3), (rows 0-7, k 4-7),
// (rows 8-15, k 4-7) are a0..a3.
template <int LD>
__device__ __forceinline__ void load_a_f32(unsigned (&r)[4], const float* s,
                                           int row0, int k0, int lane) {
  const int i = lane >> 3;
  ldmatrix_x4(r, s + (row0 + (lane & 7) + (i & 1) * 8) * LD + k0 +
                     (i >> 1) * 4);
}

// the B fragments of two n8 tiles (n0..n0+15), k0..k0+7, from an fp32
// tile stored [n][k]: r[0], r[1] (b0, b1) for n0..n0+7 and r[2], r[3] for
// n0+8..n0+15
template <int LD>
__device__ __forceinline__ void load_b_f32(unsigned (&r)[4], const float* s,
                                           int n0, int k0, int lane) {
  const int i = lane >> 3;
  ldmatrix_x4(r, s + (n0 + (lane & 7) + (i >> 1) * 8) * LD + k0 +
                     (i & 1) * 4);
}

// the designs a launcher reports to its wrapper (`int* design` of the
// flash entries; the wrapper's `DESIGNS` names them in this order)
enum Design { kCudaCore = 0, kMmaBf16 = 1, kMma3xTf32 = 2 };

// two fp32 values as one register of two bf16, lo in the low half (the
// lower column of an mma fragment)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ROWS rows of D elements of T (D * sizeof(T) a multiple of 16), from row0
// of a global array with a row stride of `stride` elements, into shared
// rows of LD elements, by cp.async; rows at or past `rows` are zero-filled.
// THREADS threads share the copy. The global rows must be 16-byte aligned.
template <int ROWS, int D, int LD, int THREADS, typename T>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src,
                                                int64_t stride, int row0,
                                                int rows, int tid) {
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int kChunks = D / kVec;     // chunks a row
  static_assert((ROWS * kChunks) % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / kChunks, c = (idx % kChunks) * kVec;
    const int gr = row0 + r;
    const bool in = gr < rows;
    cp_async16(dst + r * LD + c, in ? src + gr * stride + c : src, in);
  }
}

// the A fragment of rows row0..row0+15, cols k0..k0+15 of a row-major
// shared tile with rows of LD elements
template <int LD>
__device__ __forceinline__ void load_a(unsigned (&r)[4],
                                       const __nv_bfloat16* s, int row0,
                                       int k0, int lane) {
  ldmatrix_x4(r, s + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + k0 +
                     (lane >> 4) * 8);
}

// the same A fragment from a shared tile stored [k][row] (each k's rows
// contiguous), through ldmatrix.trans: tile i of the four is (rows
// row0 + 8 (i & 1), k0 + 8 (i >> 1))
template <int LD>
__device__ __forceinline__ void load_a_trans(unsigned (&r)[4],
                                             const __nv_bfloat16* s, int row0,
                                             int k0, int lane) {
  ldmatrix_x4_trans(r, s + (k0 + (lane & 7) + (lane >> 4) * 8) * LD + row0 +
                           ((lane >> 3) & 1) * 8);
}

// the B fragments of two n8 tiles (n0..n0+15), k0..k0+15, from a shared
// tile stored [n][k] (each n's k contiguous): r[0], r[1] for n0..n0+7 and
// r[2], r[3] for n0+8..n0+15
template <int LD>
__device__ __forceinline__ void load_b(unsigned (&r)[4],
                                       const __nv_bfloat16* s, int n0,
                                       int k0, int lane) {
  ldmatrix_x4(r, s + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 +
                     ((lane >> 3) & 1) * 8);
}

// the same two B fragments from a shared tile stored [k][n] (each k's n
// contiguous), through ldmatrix.trans
template <int LD>
__device__ __forceinline__ void load_b_trans(unsigned (&r)[4],
                                             const __nv_bfloat16* s, int n0,
                                             int k0, int lane) {
  ldmatrix_x4_trans(r, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           n0 + (lane >> 4) * 8);
}

// true when a [B, L, H, D] array of `elem` bytes an element, read through
// (sb, sl, sh) element strides, starts every row on a 16-byte boundary
inline bool rows_aligned16(const void* p, int64_t sb, int64_t sl, int64_t sh,
                           int elem) {
  return aligned16(p) && sb * elem % 16 == 0 && sl * elem % 16 == 0 &&
         sh * elem % 16 == 0;
}

}  // namespace pt
