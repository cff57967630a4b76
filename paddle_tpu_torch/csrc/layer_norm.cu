// Layer-norm forward for Hopper.
//
// Replaces: paddle_tpu/ops/pallas/layer_norm.py `_ln_fwd_pallas` (the
// Pallas row-block kernel; body at l.53). Same arithmetic: fp32 sums,
// var = E[x^2] - mean^2, y = (x - mean) * rsqrt(var + eps) * gamma + beta,
// written in x's type.
//
// What bounds it on the H100: bytes. Each element is read once for the
// statistics and once for the output and written once, for 2 FLOPs or so;
// far below the ~20 FLOP/byte (fp32 CUDA cores) the card needs to be
// compute-bound.
//
// Design: one warp per row and four rows per block. Lanes stride the row
// so every load and store is coalesced; the two sums reduce with warp
// shuffles, so no shared memory and no block-wide barrier. The second
// pass re-reads the row, which a 768-wide row keeps in L1/L2. Any R >= 1
// and any N work (no tiling constraint). The TPU path took R >= 256 and
// N % 128 == 0 only; decode rows (R <= 32) come here too.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename TX, typename TW>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_fwd_kernel(const TX* __restrict__ x,
                          const TW* __restrict__ gamma,
                          const TW* __restrict__ beta, TX* __restrict__ y,
                          int64_t rows, int n, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const TX* xr = x + row * n;
  float s = 0.f, ss = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float v = pt::to_f32(xr[i]);
    s += v;
    ss += v * v;
  }
  s = pt::warp_sum(s);
  ss = pt::warp_sum(ss);
  const float mean = s / n;
  const float var = ss / n - mean * mean;
  const float rstd = rsqrtf(var + eps);
  TX* yr = y + row * n;
  for (int i = lane; i < n; i += 32) {
    const float v = (pt::to_f32(xr[i]) - mean) * rstd;
    yr[i] = pt::from_f32<TX>(v * pt::to_f32(gamma[i]) + pt::to_f32(beta[i]));
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* g, const void* b, void* y,
            int64_t rows, int n, float eps, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
  layer_norm_fwd_kernel<TX, TW><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(g),
      static_cast<const TW*>(b), static_cast<TX*>(y), rows, n, eps);
}

}  // namespace

// x, y: [rows, n] contiguous; gamma, beta: [n] contiguous, of one type.
// x_bf16 / w_bf16: 1 for bfloat16, 0 for float32.
extern "C" int pt_layer_norm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, int64_t rows,
                                 int n, float eps, int x_bf16, int w_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (w_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, rows, n, eps, s);
    else
      launch<__nv_bfloat16, float>(x, gamma, beta, y, rows, n, eps, s);
  } else {
    if (w_bf16)
      launch<float, __nv_bfloat16>(x, gamma, beta, y, rows, n, eps, s);
    else
      launch<float, float>(x, gamma, beta, y, rows, n, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// No kernel of a path: an empty kernel, one block of one warp, for timing
// the card's floor for any launch (the layer norm at decode and serving
// shapes sits near it; chip_smoke.py's launch_floor_ms).
__global__ void empty_kernel() {}

extern "C" int pt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
