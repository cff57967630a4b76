// Deterministic column sums of fp32 partials, shared by the kernels that
// reduce over rows in two passes (csrc/fused_bn.cu, csrc/fused_conv_bn.cu,
// csrc/layer_norm.cu's backward):
// each block of the first pass writes one row of partial sums, and this
// kernel adds the rows in a fixed order.
#pragma once

#include "common.cuh"

namespace pt {

// out[j] = sum over i of part[i * ncols + j], for the fp32 partial sums
// [nrows, ncols] a reduction kernel wrote one row per block: blocks of
// 32 x 32 threads, thread (tx, ty) sums rows ty, ty + 32, ... of column
// blockIdx.x * 32 + tx, then thread ty = 0 adds the 32 sums in order, so
// the result does not depend on scheduling; it is written in TO's type
// (rounded from the fp32 sum). `Tag` only names the caller in the kernel's
// symbol, so a profile can tell the callers' passes apart. nrows = 0
// writes zeros.
template <typename Tag, typename TO>
__global__ void __launch_bounds__(1024)
    column_sums_kernel(const float* __restrict__ part, TO* __restrict__ out,
                       int64_t nrows, int64_t ncols) {
  __shared__ float sh[32][33];
  const int64_t col = static_cast<int64_t>(blockIdx.x) * 32 + threadIdx.x;
  float s0 = 0.f, s1 = 0.f;
  if (col < ncols) {
    int64_t i = threadIdx.y;
    for (; i + 32 < nrows; i += 64) {
      s0 += part[i * ncols + col];
      s1 += part[(i + 32) * ncols + col];
    }
    if (i < nrows) s0 += part[i * ncols + col];
  }
  sh[threadIdx.y][threadIdx.x] = s0 + s1;
  __syncthreads();
  if (threadIdx.y == 0 && col < ncols) {
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < 32; ++k) s += sh[k][threadIdx.x];
    out[col] = from_f32<TO>(s);
  }
}

template <typename Tag, typename TO>
inline void launch_column_sums(const float* part, TO* out, int64_t nrows,
                               int64_t ncols, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((ncols + 31) / 32));
  column_sums_kernel<Tag, TO><<<grid, dim3(32, 32), 0, stream>>>(
      part, out, nrows, ncols);
}

}  // namespace pt
