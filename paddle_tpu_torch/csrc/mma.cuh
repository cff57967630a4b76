// Tensor-core building blocks for the hand-written Hopper kernels:
// 16-byte asynchronous copies into shared memory (cp.async), 8 x 8 tile
// loads from shared memory into mma fragments (ldmatrix, plain and
// transposed), and the bf16 m16n8k16 product with fp32 accumulators
// (mma.sync).
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

// two fp32 values as one register of two bf16, lo in the low half (the
// lower column of an mma fragment)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ROWS rows of D bf16 (D a multiple of 8), from row0 of a global array
// with a row stride of `stride` elements, into shared rows of LD elements,
// by cp.async; rows at or past `rows` are zero-filled. THREADS threads
// share the copy. The global rows must be 16-byte aligned.
template <int ROWS, int D, int LD, int THREADS>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int64_t stride, int row0,
                                                int rows, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static_assert((ROWS * kChunks) % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
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

// true when a [B, L, H, D] bf16 array read through (sb, sl, sh) element
// strides starts every row on a 16-byte boundary
inline bool rows_aligned16(const void* p, int64_t sb, int64_t sl,
                           int64_t sh) {
  return aligned16(p) && sb % 8 == 0 && sl % 8 == 0 && sh % 8 == 0;
}

}  // namespace pt
