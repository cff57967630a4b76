// Softmax cross-entropy forward and backward for Hopper (hard labels).
//
// Replaces: paddle_tpu/ops/pallas/softmax_ce.py `_ce_fwd_pallas` (online
// logsumexp and label pick over vocab blocks, kernel `_ce_fwd_kernel` l.121)
// and `_ce_bwd_pallas` (dlogits = (softmax - onehot) * dnll in the logits'
// type, kernel `_ce_bwd_kernel` l.167).
//
// What bounds them on the H100: bytes. The forward reads the [N, V] logits
// once for ~3 FLOPs and one exp an element; the backward reads them once and
// writes dlogits once. At the LM head (N = 8192, V = 50304, bf16) that is
// 824 MB and 1.65 GB.
//
// Design: one block of 256 threads per row, in both kernels. Loads are 16
// bytes a thread (8 bf16 or 4 fp32) when the row allows it (V a multiple of
// the vector and the base 16-byte aligned), else one element a thread.
// - forward: each thread keeps an online max and sum in fp32 over its share
//   of the row (one rescale per vector, not per element); warps merge the
//   (max, sum) pairs with shuffles and the first warp merges the warps'.
//   The label's logit is read directly where 0 <= label < V; an
//   out-of-range label (ignore_index -100, or V) reads nothing and gives
//   nll = lse, as the TPU kernel's column compare does. Outputs nll, lse
//   [N] fp32.
// - backward: one elementwise pass, (exp(x - lse) - [col == label]) * dnll
//   computed in fp32 and written in the logits' type, so no fp32 [N, V]
//   array exists.
// Row offsets are int64: row * V passes 2^31 at larger batches.
#include <float.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using pt::load_vec;
using pt::store_vec;

// merge the running (max, sum of exp(x - max)) pair (m, s) with (m2, s2);
// maxima start at -FLT_MAX, so no -inf - -inf can arise
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                  float* __restrict__ nll, float* __restrict__ lse,
                  int64_t V) {
  __shared__ float sm[kWarps], ss[kWarps];
  const int64_t row = blockIdx.x;
  const T* x = logits + row * V;
  float m = -FLT_MAX, s = 0.f;
  for (int64_t i = static_cast<int64_t>(threadIdx.x) * VEC; i < V;
       i += static_cast<int64_t>(kThreads) * VEC) {
    float vals[VEC];
    load_vec<T, VEC>(x + i, vals);
    float mx = vals[0];
#pragma unroll
    for (int j = 1; j < VEC; ++j) mx = fmaxf(mx, vals[j]);
    if (mx > m) {
      s *= expf(m - mx);
      m = mx;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) s += expf(vals[j] - m);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? sm[lane] : -FLT_MAX;
    s = lane < kWarps ? ss[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      const float l = m + logf(fmaxf(s, 1e-30f));
      const int lab = labels[row];
      const float picked =
          (lab >= 0 && lab < V) ? pt::to_f32(x[lab]) : 0.f;
      lse[row] = l;
      nll[row] = l - picked;
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                  const float* __restrict__ lse,
                  const float* __restrict__ dnll, T* __restrict__ dlogits,
                  int64_t V) {
  const int64_t row = blockIdx.x;
  const T* x = logits + row * V;
  T* y = dlogits + row * V;
  const int64_t lab = labels[row];
  const float l = lse[row];
  const float g = dnll[row];
  for (int64_t i = static_cast<int64_t>(threadIdx.x) * VEC; i < V;
       i += static_cast<int64_t>(kThreads) * VEC) {
    float vals[VEC];
    load_vec<T, VEC>(x + i, vals);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float onehot = (i + j == lab) ? 1.f : 0.f;
      vals[j] = (expf(vals[j] - l) - onehot) * g;
    }
    store_vec<T, VEC>(y + i, vals);
  }
}

// 16-byte vectors when every row starts 16-byte aligned, else scalars
template <typename T>
bool vectorised(const void* p, const void* q, int64_t V) {
  constexpr int kVec = 16 / sizeof(T);
  return V % kVec == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

template <typename T>
cudaError_t fwd(const void* logits, const int* labels, float* nll, float* lse,
                int64_t N, int64_t V, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(logits);
  if (vectorised<T>(logits, logits, V))
    ce_fwd_kernel<T, kVec><<<N, kThreads, 0, s>>>(x, labels, nll, lse, V);
  else
    ce_fwd_kernel<T, 1><<<N, kThreads, 0, s>>>(x, labels, nll, lse, V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* logits, const int* labels, const float* lse,
                const float* dnll, void* dlogits, int64_t N, int64_t V,
                cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(logits);
  T* y = static_cast<T*>(dlogits);
  if (vectorised<T>(logits, dlogits, V))
    ce_bwd_kernel<T, kVec><<<N, kThreads, 0, s>>>(x, labels, lse, dnll, y, V);
  else
    ce_bwd_kernel<T, 1><<<N, kThreads, 0, s>>>(x, labels, lse, dnll, y, V);
  return cudaGetLastError();
}

}  // namespace

// logits [N, V] contiguous (fp32 or bf16), labels [N] int32; nll and lse
// [N] fp32. N >= 1.
extern "C" int pt_softmax_ce_fwd(const void* logits, const int* labels,
                                 float* nll, float* lse, int64_t N, int64_t V,
                                 int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? fwd<__nv_bfloat16>(logits, labels, nll, lse, N, V, s)
              : fwd<float>(logits, labels, nll, lse, N, V, s);
  return static_cast<int>(err);
}

// logits and dlogits [N, V] contiguous, one type; labels [N] int32; lse and
// dnll [N] fp32 contiguous. N >= 1.
extern "C" int pt_softmax_ce_bwd(const void* logits, const int* labels,
                                 const float* lse, const float* dnll,
                                 void* dlogits, int64_t N, int64_t V,
                                 int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16
          ? bwd<__nv_bfloat16>(logits, labels, lse, dnll, dlogits, N, V, s)
          : bwd<float>(logits, labels, lse, dnll, dlogits, N, V, s);
  return static_cast<int>(err);
}
