// Shared helpers for the hand-written Hopper kernels of paddle_tpu_torch.
//
// Every kernel file exposes one `extern "C"` entry that takes raw device
// pointers, sizes, strides and the CUDA stream, launches on that stream,
// never synchronises or allocates, and returns cudaGetLastError() so the
// Python wrapper (bound with ctypes) can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VEC consecutive elements at p (16-byte aligned when VEC > 1) as floats.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_f32(e[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<T>(in[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(in[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Raise a kernel's dynamic shared-memory cap when it needs more than the
// default 48 KB (Hopper allows up to 227 KB per block).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Call f(std::true_type) when the optional mask pointer m is set, else
// f(std::false_type): an entry launches the instance of its kernel with
// the mask operand compiled in (kMask) only for a call that passes one.
template <class F>
inline cudaError_t with_mask(const void* m, F f) {
  return m ? f(std::true_type{}) : f(std::false_type{});
}

}  // namespace pt
