// Layer norm for Hopper: the forward and the backward.
//
// Replaces: paddle_tpu/ops/pallas/layer_norm.py `_ln_fwd_pallas` (the
// Pallas row-block kernel; body at l.53) and, for the backward,
// `_fused_ln_bwd` (l.193), which XLA fuses on the TPU into one loop of the
// same shape. Same arithmetic as both: fp32 sums over each row,
// var = E[x^2] - mean^2, rstd = rsqrt(var + eps), x^ = (x - mean) * rstd;
//   forward   y  = x^ * gamma + beta, written in x's type;
//   backward  dx = rstd * (dy*gamma - mean(dy*gamma) - x^ * mean(dy*gamma*x^))
//             in x's type, dgamma = sum over rows of dy * x^ and
//             dbeta = sum of dy, fp32 sums written in gamma's type.
//
// What bounds it on the H100: bytes. The forward reads x and writes y, the
// backward reads x and dy and writes dx, for some 8 and 16 fp32 operations
// an element: far below the ~20 FLOP/byte the CUDA cores need to be
// compute-bound. At decode's few rows only the latency of one row's loads
// and the launch remain.
//
// Design: one warp a row, in a persistent grid (as many blocks as fit on
// the card at once, each warp walking rows warp, warp + warps in the grid,
// ...). The "hold" instances keep the row in registers, read through
// 16-byte loads: the lane owns 16-byte chunks lane, lane + 32, ... (NV of
// them), so x (and dy) is read once and both sums of a row come from
// registers; the forward loads gamma and beta once a warp and the
// backward gamma once a block, into shared memory, not once a row. Few
// rows (at most 8 an SM) take one-warp blocks, spread over the most SMs.
// A row wider than 8 chunks a lane (N > 1,024 in fp32, 2,048 in bf16; in
// the backward, which also keeps column sums, 32 columns a lane: N >
// 1,024) runs the "stream" instance, which re-reads the row from L1/L2
// in each pass; a row whose width is not a multiple of the vector or a
// pointer off a 16-byte boundary runs the stream instance with 1-element
// chunks. Every R >= 1 and every N run a kernel; nothing falls back to a
// plain version.
//
// The backward's column sums (dgamma, dbeta) take no atomics, so a run
// repeats bit for bit: each lane keeps fp32 running sums for the columns
// it owns over the rows its warp walks, in shared memory (in registers
// they would cap the card at 8 warps an SM: ptxas gave the first design
// 164 registers at bf16 N 768); a block adds its warps' sums in warp
// order and writes one row of 2N fp32 partials ([dgamma | dbeta]);
// column_sums.cuh adds the blocks' rows in a fixed order and writes them
// in gamma's type. The stream instance (one warp a block) keeps its
// running sums in its own partial row instead.
#include <algorithm>

#include "column_sums.cuh"
#include "common.cuh"

// names this file's second pass in its column_sums_kernel symbol, so a
// profile can tell it from the other callers'
struct layer_norm_bwd_sums;

namespace {

constexpr int kFwdThreads = 128;  // at most 4 warps a block
// the backward's hold blocks: 16 warps, one block an SM at N 768, so the
// column sums add one partial row an SM (8 warps and two blocks an SM
// took 0.0188 ms against 0.0166 at R 8,192 N 768 bf16 on an H100)
constexpr int kBwdThreads = 512;
constexpr int kMaxHold = 8;       // most 16-byte chunks a lane holds

// VEC consecutive elements, loaded and stored in accesses of up to 16
// bytes: the chunk's address must be aligned to min(16, VEC * sizeof(T)).
template <typename T, int VEC>
struct alignas(VEC * sizeof(T) < 16 ? VEC * sizeof(T) : 16) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> ld(const T* p) {
  Pack<T, VEC> r;
  constexpr int kBytes = VEC * sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k)
      reinterpret_cast<uint4*>(&r)[k] =
          __ldg(reinterpret_cast<const uint4*>(p) + k);
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(&r) = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[j] = p[j];
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void st(T* p, const Pack<T, VEC>& r) {
  constexpr int kBytes = VEC * sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k)
      reinterpret_cast<uint4*>(p)[k] = reinterpret_cast<const uint4*>(&r)[k];
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = r.v[j];
  }
}

// the row's statistics from its fp32 sums, as _ln_stats_xla forms them
__device__ __forceinline__ void row_stats(float s, float ss, int n, float eps,
                                          float& mean, float& rstd) {
  s = pt::warp_sum(s);
  ss = pt::warp_sum(ss);
  mean = s / n;
  rstd = rsqrtf(ss / n - mean * mean + eps);
}

// ------------------------------- forward -----------------------------------

template <typename TX, typename TW, int VEC, int NV>
__global__ void __launch_bounds__(kFwdThreads)
    layer_norm_fwd_hold_kernel(const TX* __restrict__ x,
                               const TW* __restrict__ gamma,
                               const TW* __restrict__ beta,
                               TX* __restrict__ y, int64_t rows, int n,
                               float eps) {
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * wpb + (threadIdx.x >> 5);
  const int64_t step = static_cast<int64_t>(gridDim.x) * wpb;
  if (first >= rows) return;  // whole warp leaves together
  const int chunks = n / VEC;
  Pack<TW, VEC> g[NV], b[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * 32 + lane;
    if (c < chunks) {
      g[i] = ld<TW, VEC>(gamma + c * VEC);
      b[i] = ld<TW, VEC>(beta + c * VEC);
    }
  }
  for (int64_t row = first; row < rows; row += step) {
    const TX* xr = x + row * n;
    Pack<TX, VEC> v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < chunks) v[i] = ld<TX, VEC>(xr + c * VEC);
    }
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < chunks) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float f = pt::to_f32(v[i].v[j]);
          s += f;
          ss += f * f;
        }
      }
    }
    float mean, rstd;
    row_stats(s, ss, n, eps, mean, rstd);
    TX* yr = y + row * n;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < chunks) {
        Pack<TX, VEC> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = pt::from_f32<TX>(
              (pt::to_f32(v[i].v[j]) - mean) * rstd * pt::to_f32(g[i].v[j]) +
              pt::to_f32(b[i].v[j]));
        st<TX, VEC>(yr + c * VEC, o);
      }
    }
  }
}

template <typename TX, typename TW, int VEC>
__global__ void __launch_bounds__(kFwdThreads)
    layer_norm_fwd_stream_kernel(const TX* __restrict__ x,
                                 const TW* __restrict__ gamma,
                                 const TW* __restrict__ beta,
                                 TX* __restrict__ y, int64_t rows, int n,
                                 float eps) {
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * wpb + (threadIdx.x >> 5);
  const int64_t step = static_cast<int64_t>(gridDim.x) * wpb;
  const int chunks = n / VEC;
  for (int64_t row = first; row < rows; row += step) {
    const TX* xr = x + row * n;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      const Pack<TX, VEC> v = ld<TX, VEC>(xr + c * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = pt::to_f32(v.v[j]);
        s += f;
        ss += f * f;
      }
    }
    float mean, rstd;
    row_stats(s, ss, n, eps, mean, rstd);
    TX* yr = y + row * n;
    for (int c = lane; c < chunks; c += 32) {
      const Pack<TX, VEC> v = ld<TX, VEC>(xr + c * VEC);
      const Pack<TW, VEC> g = ld<TW, VEC>(gamma + c * VEC);
      const Pack<TW, VEC> b = ld<TW, VEC>(beta + c * VEC);
      Pack<TX, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = pt::from_f32<TX>(
            (pt::to_f32(v.v[j]) - mean) * rstd * pt::to_f32(g.v[j]) +
            pt::to_f32(b.v[j]));
      st<TX, VEC>(yr + c * VEC, o);
    }
  }
}

// ------------------------------- backward ----------------------------------

// Shared memory (fp32): gamma, then each warp's running sums of dy * x^
// and dy, kCols = NV * VEC * 32 slots each (they cover n). Element j of
// the lane's i-th chunk (column (i * 32 + lane) * VEC + j) sits at
// hold_slot: 16 bytes for each (i, j / 4, lane), so the warp's 32 lanes
// read and write 512 consecutive bytes with one 16-byte access each.
template <int VEC, int NV>
__host__ __device__ constexpr int hold_cols() {
  return NV * VEC * 32;
}

template <int VEC>
__device__ __forceinline__ int hold_slot(int i, int j, int lane) {
  return ((i * (VEC / 4) + j / 4) * 32 + lane) * 4 + j % 4;
}

template <typename TX, typename TW, int VEC, int NV>
__global__ void __launch_bounds__(kBwdThreads)
    layer_norm_bwd_hold_kernel(const TX* __restrict__ x,
                               const TX* __restrict__ dy,
                               const TW* __restrict__ gamma,
                               TX* __restrict__ dx, float* __restrict__ part,
                               int64_t rows, int n, float eps) {
  static_assert(VEC % 4 == 0, "the hold instances take 16-byte chunks");
  constexpr int kCols = hold_cols<VEC, NV>();
  extern __shared__ float4 sm4[];  // [gamma | wpb x (dg sums, db sums)]
  float* sm = reinterpret_cast<float*>(sm4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int64_t step = static_cast<int64_t>(gridDim.x) * wpb;
  const int chunks = n / VEC;
  float* sg = sm;
  float* acc = sm + kCols + warp * 2 * kCols;
  for (int k = threadIdx.x; k < kCols; k += blockDim.x) {
    const int iq = k / 128, l = k / 4 % 32;
    const int col = (iq / (VEC / 4) * 32 + l) * VEC + iq % (VEC / 4) * 4 +
                    k % 4;
    sg[k] = col < n ? pt::to_f32(gamma[col]) : 0.f;
  }
  for (int k = lane; k < 2 * kCols / 4; k += 32)
    reinterpret_cast<float4*>(acc)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * wpb + warp;
       row < rows; row += step) {
    const TX* xr = x + row * n;
    const TX* dyr = dy + row * n;
    Pack<TX, VEC> xv[NV], dv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < chunks) {
        xv[i] = ld<TX, VEC>(xr + c * VEC);
        dv[i] = ld<TX, VEC>(dyr + c * VEC);
      }
    }
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < chunks) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float f = pt::to_f32(xv[i].v[j]);
          s += f;
          ss += f * f;
        }
      }
    }
    float mean, rstd;
    row_stats(s, ss, n, eps, mean, rstd);
    float a = 0.f, bb = 0.f;  // sums of dy*gamma and dy*gamma*x^
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < chunks) {
#pragma unroll
        for (int q = 0; q < VEC; q += 4) {
          const int k = hold_slot<VEC>(i, q, lane);
          const float4 g4 = *reinterpret_cast<const float4*>(sg + k);
          float4 dg4 = *reinterpret_cast<float4*>(acc + k);
          float4 db4 = *reinterpret_cast<float4*>(acc + kCols + k);
          const float* g = &g4.x;
          float* pg = &dg4.x;
          float* pb = &db4.x;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xh = (pt::to_f32(xv[i].v[q + e]) - mean) * rstd;
            const float d = pt::to_f32(dv[i].v[q + e]);
            const float dxh = d * g[e];
            pg[e] += d * xh;
            pb[e] += d;
            a += dxh;
            bb += dxh * xh;
          }
          *reinterpret_cast<float4*>(acc + k) = dg4;
          *reinterpret_cast<float4*>(acc + kCols + k) = db4;
        }
      }
    }
    a = pt::warp_sum(a);
    bb = pt::warp_sum(bb);
    const float m1 = a / n, m2 = bb / n;
    TX* dxr = dx + row * n;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < chunks) {
        Pack<TX, VEC> o;
#pragma unroll
        for (int q = 0; q < VEC; q += 4) {
          const float4 g4 =
              *reinterpret_cast<const float4*>(sg + hold_slot<VEC>(i, q, lane));
          const float* g = &g4.x;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xh = (pt::to_f32(xv[i].v[q + e]) - mean) * rstd;
            const float dxh = pt::to_f32(dv[i].v[q + e]) * g[e];
            o.v[q + e] = pt::from_f32<TX>(rstd * (dxh - m1 - xh * m2));
          }
        }
        st<TX, VEC>(dxr + c * VEC, o);
      }
    }
  }
  __syncthreads();
  // the block's partial row [dgamma | dbeta]: warp 0's sums, then warp
  // 1's added, ...
  float* pr = part + static_cast<int64_t>(blockIdx.x) * 2 * n;
  for (int k = threadIdx.x; k < 2 * n; k += blockDim.x) {
    const int half = k >= n, col = k - half * n;
    const int c = col / VEC;
    const int slot = half * kCols + hold_slot<VEC>(c / 32, col % VEC, c % 32);
    float t = 0.f;
    for (int w = 0; w < wpb; ++w) t += sm[kCols + w * 2 * kCols + slot];
    pr[k] = t;
  }
}

// One warp a block; its running column sums live in its own partial row.
template <typename TX, typename TW, int VEC>
__global__ void __launch_bounds__(32)
    layer_norm_bwd_stream_kernel(const TX* __restrict__ x,
                                 const TX* __restrict__ dy,
                                 const TW* __restrict__ gamma,
                                 TX* __restrict__ dx,
                                 float* __restrict__ part, int64_t rows,
                                 int n, float eps) {
  const int lane = threadIdx.x;
  const int chunks = n / VEC;
  float* pg = part + static_cast<int64_t>(blockIdx.x) * 2 * n;
  float* pb = pg + n;
  // each lane reads and writes only the columns of its own chunks
  for (int c = lane; c < chunks; c += 32) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) pg[c * VEC + j] = pb[c * VEC + j] = 0.f;
  }
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const TX* xr = x + row * n;
    const TX* dyr = dy + row * n;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      const Pack<TX, VEC> v = ld<TX, VEC>(xr + c * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = pt::to_f32(v.v[j]);
        s += f;
        ss += f * f;
      }
    }
    float mean, rstd;
    row_stats(s, ss, n, eps, mean, rstd);
    float a = 0.f, bb = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      const Pack<TX, VEC> v = ld<TX, VEC>(xr + c * VEC);
      const Pack<TX, VEC> d = ld<TX, VEC>(dyr + c * VEC);
      const Pack<TW, VEC> g = ld<TW, VEC>(gamma + c * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (pt::to_f32(v.v[j]) - mean) * rstd;
        const float df = pt::to_f32(d.v[j]);
        const float dxh = df * pt::to_f32(g.v[j]);
        pg[c * VEC + j] += df * xh;
        pb[c * VEC + j] += df;
        a += dxh;
        bb += dxh * xh;
      }
    }
    a = pt::warp_sum(a);
    bb = pt::warp_sum(bb);
    const float m1 = a / n, m2 = bb / n;
    TX* dxr = dx + row * n;
    for (int c = lane; c < chunks; c += 32) {
      const Pack<TX, VEC> v = ld<TX, VEC>(xr + c * VEC);
      const Pack<TX, VEC> d = ld<TX, VEC>(dyr + c * VEC);
      const Pack<TW, VEC> g = ld<TW, VEC>(gamma + c * VEC);
      Pack<TX, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (pt::to_f32(v.v[j]) - mean) * rstd;
        const float dxh = pt::to_f32(d.v[j]) * pt::to_f32(g.v[j]);
        o.v[j] = pt::from_f32<TX>(rstd * (dxh - m1 - xh * m2));
      }
      st<TX, VEC>(dxr + c * VEC, o);
    }
  }
}

// ------------------------------- launchers ---------------------------------

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// blocks of the persistent grid: one warp a row at most, no more blocks
// than fit on the card at once, and at most `cap`
template <typename K>
int64_t grid_for(K kernel, int threads, size_t smem, int64_t rows,
                 int64_t cap) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const int64_t wpb = threads / 32;
  int64_t g = (rows + wpb - 1) / wpb;
  g = std::min<int64_t>(g, static_cast<int64_t>(std::max(per_sm, 1)) *
                               sm_count());
  return std::min<int64_t>(g, cap);
}

// 16-byte chunks a lane holds for a row of n, at most kMax (0: the row
// takes the stream instance)
template <int kMax>
int hold_chunks(int n, int vec, bool aligned) {
  if (!aligned || n % vec) return 0;
  const int per_lane = (n / vec + 31) / 32;
  if (per_lane > kMax) return 0;
  if (per_lane <= 4) return per_lane;
  return per_lane <= 6 ? 6 : 8;
}

// Call f(std::integral_constant<int, NV>) for the hold instance NV (from
// hold_chunks<kMax>); only instances up to kMax are compiled.
template <int kMax, class F>
void with_hold(int nv, F f) {
  using std::integral_constant;
  if (nv == 1) f(integral_constant<int, 1>{});
  if (nv == 2) f(integral_constant<int, 2>{});
  if (nv == 3) f(integral_constant<int, 3>{});
  if (nv == 4) f(integral_constant<int, 4>{});
  if constexpr (kMax >= 6) {
    if (nv == 6) f(integral_constant<int, 6>{});
  }
  if constexpr (kMax >= 8) {
    if (nv == 8) f(integral_constant<int, 8>{});
  }
}

template <typename TX, typename TW>
void launch_fwd(const void* x, const void* g, const void* b, void* y,
                int64_t rows, int n, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool aligned = pt::aligned16(x) && pt::aligned16(y) &&
                       pt::aligned16(g) && pt::aligned16(b);
  const int nv = hold_chunks<kMaxHold>(n, kVec, aligned);
  // few rows: one-warp blocks spread them over the most SMs
  const int threads = rows <= 8 * static_cast<int64_t>(sm_count())
                          ? 32 : kFwdThreads;
  auto go = [&](auto kernel) {
    const int64_t grid = grid_for(kernel, threads, 0, rows, INT32_MAX);
    kernel<<<static_cast<unsigned>(grid), threads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(g),
        static_cast<const TW*>(b), static_cast<TX*>(y), rows, n, eps);
  };
  if (nv > 0) {
    with_hold<kMaxHold>(nv, [&](auto c) {
      go(layer_norm_fwd_hold_kernel<TX, TW, kVec, decltype(c)::value>);
    });
  } else if (aligned && n % kVec == 0) {
    go(layer_norm_fwd_stream_kernel<TX, TW, kVec>);
  } else {
    go(layer_norm_fwd_stream_kernel<TX, TW, 1>);
  }
}

template <typename TX, typename TW>
cudaError_t launch_bwd(const void* x, const void* dy, const void* g, void* dx,
                       float* part, TW* dgb, int64_t rows, int n,
                       int64_t max_parts, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  // at most 32 columns a lane: gamma and 16 warps' running sums take at
  // most 135 KB of shared memory, one block an SM
  constexpr int kMax = 32 / kVec;
  const bool aligned = pt::aligned16(x) && pt::aligned16(dy) &&
                       pt::aligned16(dx) && pt::aligned16(g);
  const int nv = hold_chunks<kMax>(n, kVec, aligned);
  int64_t parts = 0;
  auto go = [&](auto kernel, int threads, size_t smem) {
    cudaError_t err = pt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    parts = grid_for(kernel, threads, smem, rows, max_parts);
    kernel<<<static_cast<unsigned>(parts), threads, smem, stream>>>(
        static_cast<const TX*>(x), static_cast<const TX*>(dy),
        static_cast<const TW*>(g), static_cast<TX*>(dx), part, rows, n, eps);
    return cudaGetLastError();
  };
  cudaError_t err = cudaSuccess;
  if (rows > 0) {
    if (nv > 0) {
      with_hold<kMax>(nv, [&](auto c) {
        constexpr int kCols = hold_cols<kVec, decltype(c)::value>();
        err = go(
            layer_norm_bwd_hold_kernel<TX, TW, kVec, decltype(c)::value>,
            kBwdThreads,
            (1 + 2 * kBwdThreads / 32) * kCols * sizeof(float));
      });
    } else if (aligned && n % kVec == 0) {
      err = go(layer_norm_bwd_stream_kernel<TX, TW, kVec>, 32, 0);
    } else {
      err = go(layer_norm_bwd_stream_kernel<TX, TW, 1>, 32, 0);
    }
    if (err != cudaSuccess) return err;
  }
  // R = 0 adds no partial rows: dgamma and dbeta come out 0
  pt::launch_column_sums<layer_norm_bwd_sums>(part, dgb, parts,
                                              2 * static_cast<int64_t>(n),
                                              stream);
  return cudaGetLastError();
}

}  // namespace

// x, y: [rows, n] contiguous; gamma, beta: [n] contiguous, of one type.
// x_bf16 / w_bf16: 1 for bfloat16, 0 for float32.
extern "C" int pt_layer_norm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, int64_t rows,
                                 int n, float eps, int x_bf16, int w_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || n == 0) return 0;
  if (x_bf16) {
    if (w_bf16)
      launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, rows, n,
                                               eps, s);
    else
      launch_fwd<__nv_bfloat16, float>(x, gamma, beta, y, rows, n, eps, s);
  } else {
    if (w_bf16)
      launch_fwd<float, __nv_bfloat16>(x, gamma, beta, y, rows, n, eps, s);
    else
      launch_fwd<float, float>(x, gamma, beta, y, rows, n, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: [rows, n] contiguous, of one type; gamma: [n] contiguous;
// part: fp32 [max_parts, 2n] scratch (max_parts >= 1 when rows >= 1);
// dgb: [2n] in gamma's type, written with dgamma then dbeta.
extern "C" int pt_layer_norm_bwd(const void* x, const void* dy,
                                 const void* gamma, void* dx, void* part,
                                 void* dgb, int64_t rows, int n,
                                 int64_t max_parts, float eps, int x_bf16,
                                 int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  float* p = static_cast<float*>(part);
  cudaError_t err;
  if (x_bf16) {
    if (w_bf16)
      err = launch_bwd<__nv_bfloat16, __nv_bfloat16>(
          x, dy, gamma, dx, p, static_cast<__nv_bfloat16*>(dgb), rows, n,
          max_parts, eps, s);
    else
      err = launch_bwd<__nv_bfloat16, float>(
          x, dy, gamma, dx, p, static_cast<float*>(dgb), rows, n, max_parts,
          eps, s);
  } else {
    if (w_bf16)
      err = launch_bwd<float, __nv_bfloat16>(
          x, dy, gamma, dx, p, static_cast<__nv_bfloat16*>(dgb), rows, n,
          max_parts, eps, s);
    else
      err = launch_bwd<float, float>(x, dy, gamma, dx, p,
                                     static_cast<float*>(dgb), rows, n,
                                     max_parts, eps, s);
  }
  return static_cast<int>(err);
}

// No kernel of a path: an empty kernel, one block of one warp, for timing
// the card's floor for any launch (the layer norm at decode and serving
// shapes sits near it; chip_smoke.py's launch_floor_ms).
__global__ void empty_kernel() {}

extern "C" int pt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
