// Hopper's asynchronous building blocks for the hand-written kernels:
// warpgroup matrix products (wgmma) from shared memory, the Tensor Memory
// Accelerator (TMA) for tile copies between device and shared memory,
// mbarriers, named barriers and register reallocation (setmaxnreg). Plain
// PTX, as csrc/mma.cuh is; sm_90a only (wgmma and setmaxnreg).
//
// Tiles in shared memory: K-major (the reduction dimension contiguous),
// rows of 64 bf16 (or 32 fp32) = 128 bytes, written by TMA with the
// 128-byte swizzle:
// within each group of 8 rows (1024 bytes, 1024-byte aligned) the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8), so the 8 rows' chunk c fall
// on 8 different bank groups. A wgmma descriptor names such a tile by its
// start address (>> 4), the leading byte offset (16 bytes: unused by the
// swizzled K-major layout), the stride byte offset (1024 bytes, from one
// 8-row group to the next) and the layout (1: 128-byte swizzle). The k16
// slices of a 64-wide row are 32 bytes apart: the descriptor of slice s
// is the tile's plus 2 s (the swizzle is applied to the address, so the
// start may move inside the 128-byte row).
//
// wgmma.m64nNk16 (bf16 in, fp32 accumulators): a warpgroup of 4 warps
// multiplies a 64 x 16 A tile by a 16 x N B tile; warp w of the group
// holds rows 16w..16w+15 of the 64 x N result, as N / 8 mma accumulator
// tiles (csrc/mma.cuh): registers 4i .. 4i+3 of lane (g, t) = lane / 4,
// lane % 4 are (row 16w + g, cols 8i + 2t, 8i + 2t + 1) and (row 16w + g
// + 8, the same cols). Both operands K-major is the "TN" case wgmma reads
// directly (transpose flags 0).
//
// mbarrier phases: a barrier completes a phase when its expected arrivals
// (and, for TMA, its expected bytes) are in; `mbar_wait(bar, parity)`
// returns once the phase of that parity has completed. A producer waits
// on an empty barrier with parity 1 first (passes at once: the ring starts
// empty), a consumer on a full barrier with parity 0; each flips its
// parity whenever its stage index wraps.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---------------------------------- wgmma ------------------------------------

// the descriptor of a K-major tile with 128-byte rows and the 128-byte
// swizzle, starting at p (1024-byte aligned, or a k16 slice inside it)
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{16 >> 4} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A B^T for a 64 x 16 A tile and an N x 16 B tile, both K-major in
// shared memory (descriptors da, db); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "the widths the kernels use");
  if constexpr (N == 64) wgmma_m64n64k16(d, da, db, scale_d);
  else wgmma_m64n128k16(d, da, db, scale_d);
}

// The TF32 products, wgmma.m64nNk8 .tf32 (fp32 accumulators), with A from
// registers: warp w of the group holds rows 16w..16w+15 of the 64 x 8 A
// tile as the TF32 A fragment of mma.sync.m16n8k8 (csrc/mma.cuh, in its
// own k order: a0 (row g, k t), a1 (row g + 8, k t), a2 (row g, k t + 4),
// a3 (row g + 8, k t + 4)); B is an N x 8 TF32 tile, K-major in shared
// memory. A k8 slice of an fp32 row is 32 bytes, as a k16 slice of bf16
// is, so the descriptors step as the bf16 ones do. TF32 takes no
// transpose flags (both operands K-major).
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32],
                                                    const unsigned (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     const unsigned (&a)[4],
                                                     uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const unsigned (&a)[4],
                                           uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "the widths the kernels use");
  if constexpr (N == 64) wgmma_m64n64k8_tf32(d, a, db, scale_d);
  else wgmma_m64n128k8_tf32(d, a, db, scale_d);
}

// -------------------------------- mbarriers ----------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also expects `bytes` more of TMA transfers
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a wait that outlasts ~2^35 cycles (some 17 s) traps: a copy that never
// lands is a fault, and the launch then fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned addr = smem_u32(bar);
  const long long t0 = clock64();
  unsigned done = 0;
  while (!done) {
    if (clock64() - t0 > (1ll << 35)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ----------------------------------- TMA -------------------------------------

// the box at (c0 inner, c1 outer) of a 2-D tensor map into shared memory;
// completion (the box's bytes, out-of-bounds elements zero-filled and
// counted) is reported to `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// shared memory to the box at (c0, c1); elements out of bounds are not
// written. Commit with bulk_commit.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N of this thread's committed stores have yet to read their
// shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// this thread's committed stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes become visible to TMA (the async
// proxy) once a barrier orders them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------ barriers and registers -----------------------------

// named barrier `id` (1-15; 0 is __syncthreads) for `count` threads
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}


template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------ host: tensor maps ----------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the CUDA runtime (no
// link against libcuda); nullptr where libcuda has none
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a row-major [rows, cols] array of `type` (`bytes` an element; row pitch
// `cols` elements, a multiple of 16 bytes) cut into boxes of box_rows x
// box_cols, 128-byte swizzle (box_cols * bytes <= 128), out-of-bounds
// elements read as zero
inline CUresult tensor_map_2d(CUtensorMap* map, const void* base,
                              CUtensorMapDataType type, uint32_t bytes,
                              uint64_t rows, uint64_t cols,
                              uint32_t box_rows, uint32_t box_cols) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

inline CUresult tensor_map_bf16(CUtensorMap* map, const void* base,
                                uint64_t rows, uint64_t cols,
                                uint32_t box_rows, uint32_t box_cols) {
  return tensor_map_2d(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows,
                       cols, box_rows, box_cols);
}

inline CUresult tensor_map_f32(CUtensorMap* map, const void* base,
                               uint64_t rows, uint64_t cols,
                               uint32_t box_rows, uint32_t box_cols) {
  return tensor_map_2d(map, base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, rows,
                       cols, box_rows, box_cols);
}

}  // namespace pt
