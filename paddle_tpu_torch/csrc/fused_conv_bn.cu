// 1x1 convolution with BatchNorm statistics for Hopper: y = x @ w^T over a
// channels-last [R = N*H*W, Cin] view, plus the per-channel sum and sum of
// squares of y as stored.
//
// Replaces: paddle_tpu/ops/pallas/fused_conv_bn.py `_conv1x1_stats_pallas`
// (l.103, kernel `_conv1x1_stats_kernel` l.73).
//
//   y[r, o]  = sum_i x[r, i] * w[o, i]      (fp32 accumulation, stored in
//                                            x's type)
//   sum[o]   = sum_r Y[r, o],  sumsq[o] = sum_r Y[r, o]^2
//   with Y the value as stored, rounded to x's type (reference l.92-94)
//
// w is the conv weight (Cout, Cin, 1, 1) read as [Cout, Cin]: each output
// channel's Cin inputs are contiguous, the "col" operand of the tensor-core
// product, so no transpose is made.
//
// What bounds it on the H100: at the ResNet-50 shapes the product sits near
// the card's ridge (layer2, R = 100,352, 512 -> 128 in bf16: 13.2 GFLOP and
// 128 MB, 0.013 ms at 989 TFLOP/s against 0.038 ms at 3.35 TB/s), so bytes
// by a little; at 1024 -> 256 and up, operations.
//
// Design, bf16: a block computes a 128 x 128 tile of y with 8 warps, each a
// 32 x 64 tile of m16n8k16 tensor-core products (`mma.sync`, fp32
// accumulators in registers), fed by `ldmatrix` from a 3-stage ring of
// 128 x 32 tiles of x and w in shared memory that `cp.async` fills ahead of
// use (rows padded to 80 bytes, so `ldmatrix` is free of bank conflicts).
// fp32 takes the same tiling on CUDA cores (64 x 64 tiles, 4 x 4 outputs a
// thread, fp32 FMA), so a card-against-CPU check computes the same function.
// The TPU grid walks (Cout stripes, row blocks) with the stripe outermost,
// so it reads x once per stripe; here the grid is linear with the Cout
// stripe fastest, so the blocks of one row tile run side by side and x
// comes from device memory once (the other stripes find it in L2), while w
// (at most 2048 x 2048) stays in L2 throughout. The epilogue rounds each
// accumulator to x's type, stores it, and sums the rounded values and their
// squares per column: over the thread's rows, across the lanes of a column
// by shuffles, across the block's warps in shared memory, into one row of
// fp32 partials per row tile [tiles, 2, Cout]; column_sums.cuh then adds
// the tiles' rows in a fixed order (no atomics, the same result every run).
// Edges: rows past R and columns past Cout are zero-filled on load and
// masked on store; Cin and Cout must be multiples of 8 (16-byte vectors)
// and x, w 16-byte aligned, which the wrapper checks.
#include "column_sums.cuh"
#include "common.cuh"
#include "mma.cuh"

// names this file's second pass in its column_sums_kernel symbol, so a
// profile can tell it from the other caller's
struct conv1x1_sums;

namespace {

constexpr int kThreads = 256;

using pt::cp_async16;
using pt::cp_async_commit;
using pt::cp_async_wait;
using pt::ldmatrix_x4;
using pt::mma_bf16;

// ----------------------------- bf16, tensor cores ----------------------------

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
constexpr int LDS = BK + 8;  // padded row, in elements (80 bytes)
constexpr size_t kSmemBf16 =
    static_cast<size_t>(STAGES) * (BM + BN) * LDS * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(kThreads)
    conv1x1_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ y,
                        float* __restrict__ part, int64_t R, int Cin,
                        int Cout, int tiles_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + STAGES * BM * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 64
  const int64_t tile_m = blockIdx.x / tiles_n;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int64_t m0 = tile_m * BM;
  const int ktiles = (Cin + BK - 1) / BK;

  // one stage: BM rows of x and BN rows of w, BK columns each, as 16-byte
  // chunks (4 a row); two chunks of each a thread
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int chunk = tid + i * kThreads;
      const int r = chunk >> 2, kc = (chunk & 3) * 8;
      const int gk = k0 + kc;
      const int64_t gr = m0 + r;
      const bool pa = gr < R && gk < Cin;
      cp_async16(As + (stage * BM + r) * LDS + kc,
                 pa ? x + gr * Cin + gk : x, pa);
      const int gn = n0 + r;
      const bool pb = gn < Cout && gk < Cin;
      cp_async16(Bs + (stage * BN + r) * LDS + kc,
                 pb ? w + static_cast<int64_t>(gn) * Cin + gk : w, pb);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is free again
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_stage(next % STAGES, next);
    cp_async_commit();
    const __nv_bfloat16* a_s = As + (kt % STAGES) * BM * LDS;
    const __nv_bfloat16* b_s = Bs + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[2][4], b[4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(a[mt], a_s + row * LDS + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int n = wn * 64 + np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(b[np], b_s + n * LDS + kk + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                   b[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is reused for the column sums below

  // epilogue: round, store, and sum the stored values per column
  const int g = lane >> 2, t = lane & 3;
  float cs[8][2], css[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    cs[nt][0] = cs[nt][1] = css[nt][0] = css[nt][1] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = m0 + wm * 32 + mt * 16 + g + half * 8;
      if (row >= R) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn * 64 + nt * 8 + 2 * t;
        if (col >= Cout) continue;  // Cout % 8 == 0: col + 1 < Cout too
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
        *reinterpret_cast<__nv_bfloat162*>(y + row * Cout + col) = v;
        const float f0 = __low2float(v), f1 = __high2float(v);
        cs[nt][0] += f0;
        cs[nt][1] += f1;
        css[nt][0] += f0 * f0;
        css[nt][1] += f1 * f1;
      }
    }
  }
  // lanes sharing t hold the same columns: add over g (lane bits 2-4)
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        cs[nt][j] += __shfl_xor_sync(0xffffffffu, cs[nt][j], o);
        css[nt][j] += __shfl_xor_sync(0xffffffffu, css[nt][j], o);
      }
  float* red = reinterpret_cast<float*>(smem);  // [2][4 warps in m][BN]
  if (lane < 4) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 64 + nt * 8 + 2 * lane + j;
        red[(0 * 4 + wm) * BN + c] = cs[nt][j];
        red[(1 * 4 + wm) * BN + c] = css[nt][j];
      }
  }
  __syncthreads();
  float* out = part + tile_m * 2 * Cout;
  for (int i = tid; i < 2 * BN; i += kThreads) {
    const int which = i / BN, c = i % BN;
    if (n0 + c >= Cout) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) s += red[(which * 4 + q) * BN + c];
    out[which * Cout + n0 + c] = s;
  }
}

// ------------------------------ fp32, CUDA cores -----------------------------

constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(kThreads)
    conv1x1_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ y, float* __restrict__ part,
                       int64_t R, int Cin, int Cout, int tiles_n) {
  __shared__ float As[FBK][FBM + 4];  // k-major: a thread's rows side by side
  __shared__ float Bs[FBK][FBN + 4];
  __shared__ float red[2][16][FBN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t tile_m = blockIdx.x / tiles_n;
  const int n0 = (blockIdx.x % tiles_n) * FBN;
  const int64_t m0 = tile_m * FBM;
  // loads: one float4 of x and one of w a thread (64 rows x 16 columns)
  const int lr = tid >> 2, lk = (tid & 3) * 4;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < Cin; k0 += FBK) {
    const int gk = k0 + lk;
    const int64_t gr = m0 + lr;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (gr < R && gk < Cin)
      av = *reinterpret_cast<const float4*>(x + gr * Cin + gk);
    const int gn = n0 + lr;
    if (gn < Cout && gk < Cin)
      bv = *reinterpret_cast<const float4*>(
          w + static_cast<int64_t>(gn) * Cin + gk);
    As[lk + 0][lr] = av.x;
    As[lk + 1][lr] = av.y;
    As[lk + 2][lr] = av.z;
    As[lk + 3][lr] = av.w;
    Bs[lk + 0][lr] = bv.x;
    Bs[lk + 1][lr] = bv.y;
    Bs[lk + 2][lr] = bv.z;
    Bs[lk + 3][lr] = bv.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float cs[4] = {}, css[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = m0 + ty + 16 * i;
    if (row >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= Cout) continue;
      y[row * Cout + col] = acc[i][j];
      cs[j] += acc[i][j];
      css[j] += acc[i][j] * acc[i][j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx + 16 * j] = cs[j];
    red[1][ty][tx + 16 * j] = css[j];
  }
  __syncthreads();
  float* out = part + tile_m * 2 * Cout;
  if (tid < 2 * FBN) {
    const int which = tid / FBN, c = tid % FBN;
    if (n0 + c < Cout) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 16; ++q) s += red[which][q][c];
      out[which * Cout + n0 + c] = s;
    }
  }
}

}  // namespace

// y [R, Cout] in x's type (bf16 != 0: bfloat16, else float32); part: fp32
// scratch [tiles, 2, Cout] with tiles = ceil(R / 128) for bf16 and
// ceil(R / 64) for fp32 (the wrapper's count, checked here); out: fp32
// [2, Cout] = (sum, sumsq).
extern "C" int pt_conv1x1_stats(const void* x, const void* w, void* y,
                                float* part, float* out, int64_t R, int Cin,
                                int Cout, int64_t tiles, int bf16,
                                cudaStream_t stream) {
  const int bm = bf16 ? BM : FBM, bn = bf16 ? BN : FBN;
  if (tiles != (R + bm - 1) / bm || Cin % 8 || Cout % 8 || Cin <= 0 ||
      Cout <= 0 || !pt::aligned16(x) || !pt::aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_n = (Cout + bn - 1) / bn;
  const int64_t blocks = tiles * tiles_n;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    const cudaError_t err = pt::allow_smem(conv1x1_bf16_kernel, kSmemBf16);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv1x1_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBf16,
                          stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
        part, R, Cin, Cout, tiles_n);
  } else {
    conv1x1_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(static_cast<const float*>(x),
                                   static_cast<const float*>(w),
                                   static_cast<float*>(y), part, R, Cin,
                                   Cout, tiles_n);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pt::launch_column_sums<conv1x1_sums>(
      part, out, tiles, 2 * static_cast<int64_t>(Cout), stream);
  return static_cast<int>(cudaGetLastError());
}
