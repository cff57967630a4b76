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
// 824 MB and 1.65 GB. At the small heads (ResNet's N 128 V 1000, BERT's
// N 256 V 2) the bytes take a fraction of a microsecond and the launch and
// one round trip to memory are the time.
//
// Outputs: the forward nll, lse [N] fp32; the backward
// (exp(x - lse) - [col == label]) * dnll, computed in fp32 and written in
// the logits' type, so no fp32 [N, V] array exists. An out-of-range label
// (ignore_index -100, or V) reads nothing and gives nll = lse, as the TPU
// kernel's column compare does. The forward's exponentials are ex2.approx
// of (x - m) * log2(e): the subtraction first keeps exp(0) exact (a V 1 row
// has lse = x, as the plain version has) and -inf logits give 0; the
// backward's are expf, as the plain version's (grad_chunk). A NaN in a row
// reaches that row's sum, so its lse, nll and dlogits, and no other row's
// (the max skips it; the sum, at least 1 otherwise, goes to logf
// unclamped).
//
// Two designs, by the row's length alone (the launcher's choice is
// reported through `design`; ops/kernels/softmax_ce.py fwd_design /
// bwd_design is its twin):
// - "ce-warp-rows" (rows of at most PT_CE_FWD_HOLD_MAX classes in the
//   forward, PT_CE_BWD_HOLD_MAX in the backward): a group of G lanes (1-32,
//   a power of two, the fewest that hold the row) owns a row and holds all
//   of it in registers: lane l of the group owns the row's chunks l,
//   l + G, ... (K of them; 16-byte vectors, or single elements where V or
//   a pointer is off the vector). Every load of a lane, and the row's
//   label (and, in the backward, its lse and dnll), is issued before any
//   arithmetic. The forward takes each lane's max and its sum of
//   exponentials, then one max tree over the group, one rescale and one
//   sum tree (two shuffle trees), and the lane that holds the label's
//   logit in its registers writes nll: no load depends on the reduction,
//   and the row makes one round trip to memory. The backward computes and
//   stores from the same registers.
// - "ce-stream" (longer rows). The forward: one block of 256 threads a
//   row, in sweeps of kUnroll 16-byte loads a thread (one, where one sweep
//   covers the row) with two sweeps in flight: while a thread works on one
//   sweep, the next one's loads are out, so a row's short last sweep
//   overlaps the one before it, and the blocks resident on an SM overlap
//   one row's reduction with other rows' loads. It keeps a running (max,
//   sum) a thread, rescaled once a sweep, not once a vector, picks the
//   label's logit in-stream (the label is read before the first sweep's
//   loads), and the block merges the row's (max, sum, logit) triples in a
//   fixed order at its end. The backward, elementwise once lse is known:
//   one block a segment of 256 chunks of a row (a 2-D grid), one 16-byte
//   load a thread issued with the row's scalars.
// The crossings are measured on the card (tools/ab_ce_designs.py,
// PERF.md): a warp holding a wider row does a lane's exponentials (its
// elements, in the backward) in series and loses to a block a row at a
// few hundred rows (ResNet's N 128 V 1,000); the backward, which needs no
// reduction across the block, gains from the spread sooner. Held rows of
// up to 4 KB win from some 512 (forward) and 1,024 (backward) rows on,
// but no path sends that many rows that wide, so the rule reads V alone.
// No atomics: every sum is taken in a fixed order, so runs repeat bit for
// bit. Row offsets are int64: row * V passes 2^31 at larger batches.
#include <float.h>
#include <math.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

// the widest rows (classes) that "ce-warp-rows" holds, by direction
#ifndef PT_CE_FWD_HOLD_MAX
#define PT_CE_FWD_HOLD_MAX 512
#endif
#ifndef PT_CE_BWD_HOLD_MAX
#define PT_CE_BWD_HOLD_MAX 256
#endif

namespace {

// the codes `design` reports (ops/kernels/softmax_ce.py DESIGNS)
enum Design { kWarpRows = 0, kStream = 1 };

constexpr int kRowsThreads = 128;    // "ce-warp-rows" blocks (few rows: 32)
constexpr int kStreamThreads = 256;  // "ce-stream" blocks
constexpr int kUnroll = 4;  // the forward's 16-byte loads a sweep, long rows
constexpr float kLog2e = 1.4426950408889634f;

// 2^x; flushes results below 2^-126 to 0 (terms that add nothing to a
// sum of at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// VEC consecutive elements: one 16-byte access, or VEC == 1
template <typename T, int VEC>
struct alignas(VEC * sizeof(T) == 16 ? 16 : alignof(T)) Chunk {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "16 bytes or 1");
  T v[VEC];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (VEC == 1)
      v[0] = p[0];
    else
      *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (VEC == 1)
      p[0] = v[0];
    else
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  }
  __device__ __forceinline__ float f(int j) const { return pt::to_f32(v[j]); }
};

// dlogits of the VEC elements at column e0: (expf(x - l) - [col == lab])
// * g, as the plain version computes them. expf, as its torch.exp: where p
// is near 1, p - 1 keeps only the bits the two exponentials share
// (ex2.approx's 2 ulp would leave 1e-3 of p - 1 at p = 1 - 1e-4); in this
// bytes-bound pass it costs nothing measurable.
template <typename T, int VEC>
__device__ __forceinline__ Chunk<T, VEC> grad_chunk(const Chunk<T, VEC>& c,
                                                    int64_t e0, int lab,
                                                    float l, float g) {
  Chunk<T, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    o.v[j] = pt::from_f32<T>(
        (expf(c.f(j) - l) - (e0 + j == lab ? 1.f : 0.f)) * g);
  return o;
}

// ------------------------------ ce-warp-rows --------------------------------

// the row a lane's group owns; groups are G consecutive lanes
template <int G>
__device__ __forceinline__ int64_t group_row() {
  return (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
}

template <typename T, int VEC, int G, int K>
__global__ void __launch_bounds__(kRowsThreads)
    ce_fwd_rows_kernel(const T* __restrict__ logits,
                       const int* __restrict__ labels,
                       float* __restrict__ nll, float* __restrict__ lse,
                       int64_t N, int V) {
  const int gl = threadIdx.x & (G - 1);
  const int64_t row = group_row<G>();
  const bool live = row < N;
  const int chunks = V / VEC;
  const int lab = live ? labels[row] : -1;
  const T* x = logits + row * V;
  Chunk<T, VEC> c[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (live && k * G + gl < chunks) c[k].load(x + (k * G + gl) * VEC);
  // the lane's own max and sum first, so its exponentials need no
  // shuffle; then one max tree, one rescale and one sum tree
  float m = -FLT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (live && k * G + gl < chunks)
#pragma unroll
      for (int j = 0; j < VEC; ++j) m = fmaxf(m, c[k].f(j));
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (live && k * G + gl < chunks)
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += ex2((c[k].f(j) - m) * kLog2e);
  float p = 0.f;
  bool own = false;  // this lane holds the label's logit
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e0 = (k * G + gl) * VEC;
    if (live && k * G + gl < chunks) {
      if (static_cast<unsigned>(lab - e0) < VEC) {
        own = true;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (e0 + j == lab) p = c[k].f(j);
      }
    }
  }
  float gm = m;
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, o));
  s *= ex2((m - gm) * kLog2e);
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (live) {
    // every lane of the group has the sum: the owner writes nll, lane 0
    // lse (and nll for a label out of range)
    const float l = gm + logf(s);
    if (gl == 0) lse[row] = l;
    if (own)
      nll[row] = l - p;
    else if (gl == 0 && !(lab >= 0 && lab < V))
      nll[row] = l;
  }
}

template <typename T, int VEC, int G, int K>
__global__ void __launch_bounds__(kRowsThreads)
    ce_bwd_rows_kernel(const T* __restrict__ logits,
                       const int* __restrict__ labels,
                       const float* __restrict__ lse,
                       const float* __restrict__ dnll,
                       T* __restrict__ dlogits, int64_t N, int V) {
  const int gl = threadIdx.x & (G - 1);
  const int64_t row = group_row<G>();
  if (row >= N) return;  // no shuffles below
  const int chunks = V / VEC;
  const int lab = labels[row];
  const float l = lse[row];
  const float g = dnll[row];
  const T* x = logits + row * V;
  T* y = dlogits + row * V;
  Chunk<T, VEC> c[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k * G + gl < chunks) c[k].load(x + (k * G + gl) * VEC);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e0 = (k * G + gl) * VEC;
    if (k * G + gl < chunks) grad_chunk(c[k], e0, lab, l, g).store(y + e0);
  }
}

// -------------------------------- ce-stream ---------------------------------

// (max, sum of exp(x - max), label's logit) of a row, merged over the block
// in a fixed order (shuffle trees in each warp, then the warps in order)
// through red [3][warps]. Thread 0 writes lse and nll.
__device__ __forceinline__ void block_finish(float m, float s, float p,
                                             float (*red)[kStreamThreads / 32],
                                             float* nll, float* lse,
                                             int64_t row) {
  constexpr int kWarps = kStreamThreads / 32;
  float wm = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, o));
  s *= ex2((m - wm) * kLog2e);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    p += __shfl_xor_sync(0xffffffffu, p, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = wm;
    red[1][warp] = s;
    red[2][warp] = p;
  }
  __syncthreads();
  // thread 0 merges the warps' triples in warp order (a shuffle tree in
  // warp 0 instead was slower at the small heads on an H100)
  if (threadIdx.x == 0) {
    float bm = red[0][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) bm = fmaxf(bm, red[0][w]);
    float bs = 0.f, bp = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      bs += red[1][w] * ex2((red[0][w] - bm) * kLog2e);
      bp += red[2][w];
    }
    const float l = bm + logf(bs);
    lse[row] = l;
    nll[row] = l - bp;
  }
}

// a thread's share of one sweep: chunks base + tid + u * kStreamThreads,
// u < U
template <typename T, int VEC, int U>
__device__ __forceinline__ void sweep_load(Chunk<T, VEC> (&c)[U],
                                           const T* x, int64_t base,
                                           int64_t chunks) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t ci = base + threadIdx.x + u * kStreamThreads;
    if (ci < chunks) c[u].load(x + ci * VEC);
  }
}

// fold VEC elements starting at column e0 into a running (max-relative)
// sum and pick the label's logit
template <typename T, int VEC>
__device__ __forceinline__ void fold(const Chunk<T, VEC>& c, int64_t e0,
                                     int lab, float m, float& s, float& p) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) s += ex2((c.f(j) - m) * kLog2e);
  if (static_cast<uint64_t>(lab - e0) < VEC) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (e0 + j == lab) p = c.f(j);
  }
}

// U: the 16-byte loads of a sweep a thread (1 where one sweep covers the
// row, else kUnroll). Two sweeps in flight: each named buffer (an array of
// buffers indexed at run time would leave registers) is reloaded two
// sweeps ahead as soon as it is consumed.
template <typename T, int VEC, int U>
__global__ void __launch_bounds__(kStreamThreads)
    ce_fwd_stream_kernel(const T* __restrict__ logits,
                         const int* __restrict__ labels,
                         float* __restrict__ nll, float* __restrict__ lse,
                         int V) {
  __shared__ float red[3][kStreamThreads / 32];
  constexpr int64_t kSweep = static_cast<int64_t>(U) * kStreamThreads;
  const int64_t row = blockIdx.x;
  const int64_t chunks = V / VEC;
  const int lab = labels[row];
  const T* x = logits + row * V;
  Chunk<T, VEC> a[U], b[U];
  sweep_load(a, x, 0, chunks);
  if (kSweep < chunks) sweep_load(b, x, kSweep, chunks);
  float m = -FLT_MAX, s = 0.f, p = 0.f;
  // fold one sweep, rescaled once to the max of the sweep's values
  auto consume = [&](const Chunk<T, VEC>(&c)[U], int64_t base) {
    float cm = -FLT_MAX;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + threadIdx.x + u * kStreamThreads < chunks)
#pragma unroll
        for (int j = 0; j < VEC; ++j) cm = fmaxf(cm, c[u].f(j));
    const float mn = fmaxf(m, cm);
    s *= ex2((m - mn) * kLog2e);
    m = mn;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t ci = base + threadIdx.x + u * kStreamThreads;
      if (ci < chunks) fold(c[u], ci * VEC, lab, m, s, p);
    }
  };
  for (int64_t base = 0; base < chunks; base += 2 * kSweep) {
    consume(a, base);
    if (base + 2 * kSweep < chunks)
      sweep_load(a, x, base + 2 * kSweep, chunks);
    if (base + kSweep < chunks) {
      consume(b, base + kSweep);
      if (base + 3 * kSweep < chunks)
        sweep_load(b, x, base + 3 * kSweep, chunks);
    }
  }
  block_finish(m, s, p, red, nll, lse, row);
}

// The backward of a long row: a block of kStreamThreads threads takes one
// segment of kStreamThreads chunks of a row (blockIdx.x the segment,
// blockIdx.y the row, + gridDim.y past 65,535 rows: no division), one
// 16-byte load a thread issued with the row's label, lse and dnll before
// any arithmetic: the elementwise pattern, with the most blocks in flight.
template <typename T, int VEC>
__global__ void __launch_bounds__(kStreamThreads)
    ce_bwd_stream_kernel(const T* __restrict__ logits,
                         const int* __restrict__ labels,
                         const float* __restrict__ lse,
                         const float* __restrict__ dnll,
                         T* __restrict__ dlogits, int64_t N, int V) {
  const int ci = blockIdx.x * kStreamThreads + threadIdx.x;
  if (ci >= V / VEC) return;
  for (int64_t row = blockIdx.y; row < N; row += gridDim.y) {
    const int lab = labels[row];
    const float l = lse[row];
    const float g = dnll[row];
    Chunk<T, VEC> c;
    c.load(logits + row * V + ci * VEC);
    grad_chunk(c, static_cast<int64_t>(ci) * VEC, lab, l, g)
        .store(dlogits + row * V + ci * VEC);
  }
}

// -------------------------------- launchers ---------------------------------

int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// a held row is at most 32 elements a lane (the ladder in with_rows)
static_assert(PT_CE_FWD_HOLD_MAX <= 1024 && PT_CE_BWD_HOLD_MAX <= 1024,
              "a held row fits a warp's registers");

// Call f(G, K) (as integral constants) for the "ce-warp-rows" instance of a
// row of `chunks` chunks of at most `kHold` elements: the fewest lanes G
// that hold it one chunk a lane, else a warp with K (a power of two)
// chunks a lane.
template <int kHold, int VEC, class F>
void with_rows(int chunks, F f) {
  using std::integral_constant;
  constexpr int kMaxK = (kHold / VEC + 31) / 32;  // a lane's chunks, at most
  if (chunks <= 1) return f(integral_constant<int, 1>{},
                            integral_constant<int, 1>{});
  if (chunks <= 2) return f(integral_constant<int, 2>{},
                            integral_constant<int, 1>{});
  if (chunks <= 4) return f(integral_constant<int, 4>{},
                            integral_constant<int, 1>{});
  if (chunks <= 8) return f(integral_constant<int, 8>{},
                            integral_constant<int, 1>{});
  if (chunks <= 16) return f(integral_constant<int, 16>{},
                             integral_constant<int, 1>{});
  auto warp = [&](auto k) {
    if constexpr (decltype(k)::value / 2 < kMaxK)
      f(integral_constant<int, 32>{}, k);
  };
  const int per_lane = (chunks + 31) / 32;
  if (per_lane <= 1) return warp(integral_constant<int, 1>{});
  if (per_lane <= 2) return warp(integral_constant<int, 2>{});
  if (per_lane <= 4) return warp(integral_constant<int, 4>{});
  if (per_lane <= 8) return warp(integral_constant<int, 8>{});
  if (per_lane <= 16) return warp(integral_constant<int, 16>{});
  return warp(integral_constant<int, 32>{});
}

// the "ce-warp-rows" launch of a row-held kernel, `kernel(G, K)` the
// instance, for rows of at most kHold elements
template <int kHold, int VEC, class MakeKernel, class... Args>
void launch_rows(MakeKernel kernel, int64_t N, int V, cudaStream_t s,
                 Args... args) {
  with_rows<kHold, VEC>(V / VEC, [&](auto G, auto K) {
    constexpr int kG = decltype(G)::value;
    const int64_t lanes = N * kG;
    // few rows: one-warp blocks spread them over the most SMs
    const int threads =
        lanes <= 32 * 4 * static_cast<int64_t>(sm_count()) ? 32
                                                           : kRowsThreads;
    const int64_t grid = (lanes + threads - 1) / threads;
    const auto k = kernel(G, K);
    k<<<static_cast<unsigned>(grid), threads, 0, s>>>(args..., N, V);
  });
}

template <typename T>
cudaError_t fwd(const void* logits, const int* labels, float* nll, float* lse,
                int64_t N, int V, int* design, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(logits);
  const bool vec = V % kVec == 0 && pt::aligned16(logits);
  if (V <= PT_CE_FWD_HOLD_MAX) {
    *design = kWarpRows;
    auto go = [&](auto v) {
      constexpr int VEC = decltype(v)::value;
      launch_rows<PT_CE_FWD_HOLD_MAX, VEC>(
          [](auto G, auto K) {
            return ce_fwd_rows_kernel<T, VEC, decltype(G)::value,
                                      decltype(K)::value>;
          },
          N, V, s, x, labels, nll, lse);
    };
    if (vec)
      go(std::integral_constant<int, kVec>{});
    else
      go(std::integral_constant<int, 1>{});
  } else {
    *design = kStream;
    // one block a row (N < 2^31)
    auto go = [&](auto kernel) {
      kernel<<<static_cast<unsigned>(N), kStreamThreads, 0, s>>>(
          x, labels, nll, lse, V);
    };
    // one sweep covers a row of at most kStreamThreads chunks: one load a
    // thread, no predicated spares
    const int chunks = V / (vec ? kVec : 1);
    if (vec)
      chunks <= kStreamThreads ? go(ce_fwd_stream_kernel<T, kVec, 1>)
                               : go(ce_fwd_stream_kernel<T, kVec, kUnroll>);
    else
      chunks <= kStreamThreads ? go(ce_fwd_stream_kernel<T, 1, 1>)
                               : go(ce_fwd_stream_kernel<T, 1, kUnroll>);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* logits, const int* labels, const float* lse,
                const float* dnll, void* dlogits, int64_t N, int V,
                int* design, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(logits);
  T* y = static_cast<T*>(dlogits);
  const bool vec =
      V % kVec == 0 && pt::aligned16(logits) && pt::aligned16(dlogits);
  if (V <= PT_CE_BWD_HOLD_MAX) {
    *design = kWarpRows;
    auto go = [&](auto v) {
      constexpr int VEC = decltype(v)::value;
      launch_rows<PT_CE_BWD_HOLD_MAX, VEC>(
          [](auto G, auto K) {
            return ce_bwd_rows_kernel<T, VEC, decltype(G)::value,
                                      decltype(K)::value>;
          },
          N, V, s, x, labels, lse, dnll, y);
    };
    if (vec)
      go(std::integral_constant<int, kVec>{});
    else
      go(std::integral_constant<int, 1>{});
  } else {
    *design = kStream;
    const int chunks = V / (vec ? kVec : 1);
    const dim3 grid((chunks + kStreamThreads - 1) / kStreamThreads,
                    static_cast<unsigned>(std::min<int64_t>(N, 65535)));
    if (vec)
      ce_bwd_stream_kernel<T, kVec><<<grid, kStreamThreads, 0, s>>>(
          x, labels, lse, dnll, y, N, V);
    else
      ce_bwd_stream_kernel<T, 1><<<grid, kStreamThreads, 0, s>>>(
          x, labels, lse, dnll, y, N, V);
  }
  return cudaGetLastError();
}

}  // namespace

// logits [N, V] contiguous (fp32 or bf16), labels [N] int32; nll and lse
// [N] fp32. N >= 1, 1 <= V < 2^31. `design` receives the Design launched.
extern "C" int pt_softmax_ce_fwd(const void* logits, const int* labels,
                                 float* nll, float* lse, int64_t N, int64_t V,
                                 int is_bf16, int* design, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = static_cast<int>(V);
  cudaError_t err =
      is_bf16 ? fwd<__nv_bfloat16>(logits, labels, nll, lse, N, v, design, s)
              : fwd<float>(logits, labels, nll, lse, N, v, design, s);
  return static_cast<int>(err);
}

// logits and dlogits [N, V] contiguous, one type; labels [N] int32; lse and
// dnll [N] fp32 contiguous. N >= 1, 1 <= V < 2^31. `design` receives the
// Design launched.
extern "C" int pt_softmax_ce_bwd(const void* logits, const int* labels,
                                 const float* lse, const float* dnll,
                                 void* dlogits, int64_t N, int64_t V,
                                 int is_bf16, int* design, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = static_cast<int>(V);
  cudaError_t err =
      is_bf16 ? bwd<__nv_bfloat16>(logits, labels, lse, dnll, dlogits, N, v,
                                   design, s)
              : bwd<float>(logits, labels, lse, dnll, dlogits, N, v, design,
                           s);
  return static_cast<int>(err);
}
