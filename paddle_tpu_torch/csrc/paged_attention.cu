// Paged decode attention for Hopper: one query token per sequence over a
// paged K/V pool.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_paged_attn_pallas`
// (kernel `_paged_attn_kernel` l.103): the block table picks each page,
// online softmax runs across pages, pages past context_lens are never read,
// and ctx == 0 gives exactly 0.
//
// What bounds it on the H100: bytes. Each live K/V element is read once
// for 2 FLOPs; the query, the block-table row and the output are tiny. So
// the design keeps as many loads in flight as it can, and lets no token
// wait for the one before it.
//
// Design (flash-decoding): each lane's context is cut into partitions of
// `part_pages` pages (256 tokens at page 16), a number the host knows from
// pages_per_seq and page_size alone, so context_lens is never read on the
// host. Two kernels:
// - `paged_attn_part_kernel`, one block of 4 warps per (head, sequence,
//   partition). A partition past the lane's live pages writes an empty
//   state (m = -inf, l = 0) and exits. Otherwise the block copies its
//   block-table slice to shared memory, then
//   1. scores: each lane group of G lanes reads one token's K row as
//      16-byte loads (G = the row's 16-byte chunks rounded up to a power
//      of two, at least 8: 16 lanes at D 64 fp32, 8 at bf16), 8 tokens a
//      group in flight, and reduces its dot product with shuffles inside
//      the group; the scores go to shared memory;
//   2. the partition's max and sum of exp over the block, in a fixed order;
//   3. P V: the groups read the V rows the same way and each lane adds its
//      chunk of the weighted rows; the groups' sums meet through shuffles,
//      the warps' through shared memory, and the block writes the
//      partition's (acc, m, l), acc not yet divided by l, to an fp32
//      workspace [B, H, S, D + 2].
//   Rows that are not 16-byte aligned (D * sizeof(T) % 16 != 0 or a pool
//   off 16 bytes) take scalar loads, 32 lanes a row.
// - `paged_attn_merge_kernel`, one block per (head, sequence): thread d
//   merges the S partial states in partition order with the online-softmax
//   merge (each rescaled by exp(m_s - max m)), skipping empty ones, and
//   writes out = acc / l; all empty gives exactly 0.
// No atomics and fixed reduction orders: runs repeat bit for bit.
//
// Contract (checked by the wrapper): pools are [P, page, H, D] contiguous;
// block_tables [B, pages_per_seq] int32 holds valid page ids in every slot
// the walk reaches (the serving allocator only writes ids it handed out,
// and the null page 0 elsewhere); context_lens [B] int32. A context longer
// than pages_per_seq * page is cut to it, as the TPU grid was.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kDMax = 128;
constexpr int kUnroll = 8;  // tokens a lane group has in flight

// max (kMax) or sum of v over the block, the same value in every thread,
// reduced in a fixed order; red holds kWarps floats
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  __syncthreads();  // red is free: the last reduction's reads are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = kMax ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// VEC elements of T as they were loaded: 16 bytes, or one element. Rows
// stay in this form until they are used (8 bf16 in 4 registers, not 8).
template <typename T, int VEC>
using Chunk = typename std::conditional<VEC == 1, T, uint4>::type;

template <typename T, int VEC>
__device__ __forceinline__ float elem(const Chunk<T, VEC>& c, int j) {
  if constexpr (VEC == 1)
    return pt::to_f32(c);
  else
    return pt::to_f32(reinterpret_cast<const T*>(&c)[j]);
}

// T elements, VEC a load (16 bytes, or 1 element), G lanes a row, C loads
// a lane
template <typename T, int VEC, int G, int C>
__global__ void __launch_bounds__(kThreads) paged_attn_part_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, float* __restrict__ ws,
    int64_t sqb, int64_t sqh, int H, int D, int page_size, int pages_per_seq,
    int part_pages, float scale) {
  constexpr int kGroups = kThreads / G;  // lane groups a block
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  __shared__ float acc_w[kWarps][kDMax];
  const int part_tokens = part_pages * page_size;
  float* logit = smem;                                      // [part_tokens]
  int* pages = reinterpret_cast<int*>(smem + part_tokens);  // [part_pages]

  const int hh = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = tid / G, gl = tid % G;
  const int ctx_cut =
      min(max(context_lens[b], 0), pages_per_seq * page_size);
  const int n_tok = min(part_tokens, ctx_cut - s * part_tokens);
  float* st = ws + ((static_cast<int64_t>(b) * H + hh) * gridDim.z + s) *
                       (D + 2);
  if (n_tok <= 0) {  // past the lane's live pages: an empty state
    if (tid == 0) {
      st[D] = -INFINITY;
      st[D + 1] = 0.f;
    }
    return;
  }
  const int* bt = block_tables + static_cast<int64_t>(b) * pages_per_seq +
                  s * part_pages;
  for (int i = tid; i * page_size < n_tok; i += kThreads) pages[i] = bt[i];

  float qv[C][VEC];
  const T* qr = q + b * sqb + hh * sqh;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int d = (gl + c * G) * VEC + j;
      qv[c][j] = d < D ? pt::to_f32(qr[d]) : 0.f;
    }
  __syncthreads();

  const int64_t tok_stride = static_cast<int64_t>(H) * D;
  // kUnroll tokens of lane group grp's stride, from `base`, into r (zeros
  // past the partition or the row)
  auto load_rows = [&](const T* pool, int base,
                       Chunk<T, VEC> (&r)[kUnroll][C]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tok = base + u * kGroups;
      const int pg = tok / page_size;
      const T* row = pool + hh * D +
                     (static_cast<int64_t>(tok < n_tok ? pages[pg] : 0) *
                          page_size +
                      (tok - pg * page_size)) *
                         tok_stride;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d0 = (gl + c * G) * VEC;
        r[u][c] = tok < n_tok && d0 < D
                      ? *reinterpret_cast<const Chunk<T, VEC>*>(row + d0)
                      : Chunk<T, VEC>{};
      }
    }
  };

  // 1. scores (every lane takes every trip: the shuffles need the warp)
  for (int b0 = 0; b0 < n_tok; b0 += kGroups * kUnroll) {
    const int base = b0 + grp;
    Chunk<T, VEC> kr[kUnroll][C];
    load_rows(k_pages, base, kr);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          part += qv[c][j] * elem<T, VEC>(kr[u][c], j);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      const int tok = base + u * kGroups;
      if (gl == 0 && tok < n_tok) logit[tok] = part * scale;
    }
  }
  __syncthreads();

  // 2. the partition's max, then P = exp(s - m) in place and its sum
  float m = -INFINITY;
  for (int i = tid; i < n_tok; i += kThreads) m = fmaxf(m, logit[i]);
  m = block_reduce<true>(m, red);
  float l = 0.f;
  for (int i = tid; i < n_tok; i += kThreads) {
    const float p = expf(logit[i] - m);
    logit[i] = p;
    l += p;
  }
  l = block_reduce<false>(l, red);  // its barriers publish the P writes

  // 3. acc = P V
  float acc[C][VEC];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[c][j] = 0.f;
  for (int b0 = 0; b0 < n_tok; b0 += kGroups * kUnroll) {
    const int base = b0 + grp;
    Chunk<T, VEC> vr[kUnroll][C];
    load_rows(v_pages, base, vr);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tok = base + u * kGroups;
      const float p = tok < n_tok ? logit[tok] : 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[c][j] += p * elem<T, VEC>(vr[u][c], j);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
#pragma unroll
      for (int o = G; o < 32; o <<= 1)
        acc[c][j] += __shfl_xor_sync(0xffffffffu, acc[c][j], o);
  if (lane < G) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int d = (gl + c * G) * VEC + j;
        if (d < D) acc_w[warp][d] = acc[c][j];
      }
  }
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float o = acc_w[0][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) o += acc_w[w][d];
    st[d] = o;
  }
  if (tid == 0) {
    st[D] = m;
    st[D + 1] = l;
  }
}

template <typename T>
__global__ void __launch_bounds__(kDMax) paged_attn_merge_kernel(
    const float* __restrict__ ws, T* __restrict__ out, int H, int D,
    int n_parts) {
  const int hh = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  if (d >= D) return;
  const int64_t bh = static_cast<int64_t>(b) * H + hh;
  const float* st = ws + bh * n_parts * (D + 2);
  float mx = -INFINITY;
  for (int s = 0; s < n_parts; ++s) mx = fmaxf(mx, st[s * (D + 2) + D]);
  float o = 0.f;
  if (mx != -INFINITY) {  // ctx == 0 leaves every partition empty: 0
    float lsum = 0.f, osum = 0.f;
    for (int s = 0; s < n_parts; ++s) {
      const float* p = st + s * (D + 2);
      if (p[D] == -INFINITY) continue;  // empty: its acc was never written
      const float c = expf(p[D] - mx);
      lsum += p[D + 1] * c;
      osum += p[d] * c;
    }
    o = osum / fmaxf(lsum, 1e-30f);
  }
  out[bh * D + d] = pt::from_f32<T>(o);
}

template <typename T, int VEC, int G, int C>
cudaError_t launch_part(const dim3& grid, size_t smem, const void* q,
                        const void* kp, const void* vp, const int* bt,
                        const int* cl, float* ws, int64_t sqb, int64_t sqh,
                        int H, int D, int page_size, int pages_per_seq,
                        int part_pages, float scale, cudaStream_t stream) {
  cudaError_t err = pt::allow_smem(paged_attn_part_kernel<T, VEC, G, C>,
                                   smem);
  if (err != cudaSuccess) return err;
  paged_attn_part_kernel<T, VEC, G, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, cl, ws, sqb, sqh, H, D, page_size,
      pages_per_seq, part_pages, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* cl, void* out, float* ws,
                   int64_t sqb, int64_t sqh, int B, int H, int D,
                   int page_size, int pages_per_seq, int part_pages,
                   int n_parts, float scale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid(H, B, n_parts);
  const size_t smem =
      static_cast<size_t>(part_pages) * (page_size + 1) * sizeof(float);
  const int chunks = D / kVec;  // 16-byte loads a row
  cudaError_t err;
  if (!(pt::aligned16(kp) && pt::aligned16(vp) && D % kVec == 0))
    err = launch_part<T, 1, 32, kDMax / 32>(grid, smem, q, kp, vp, bt, cl, ws,
                                            sqb, sqh, H, D, page_size,
                                            pages_per_seq, part_pages, scale,
                                            stream);
  else if (chunks <= 8)
    err = launch_part<T, kVec, 8, 1>(grid, smem, q, kp, vp, bt, cl, ws, sqb,
                                     sqh, H, D, page_size, pages_per_seq,
                                     part_pages, scale, stream);
  else if (chunks <= 16)
    err = launch_part<T, kVec, 16, 1>(grid, smem, q, kp, vp, bt, cl, ws, sqb,
                                      sqh, H, D, page_size, pages_per_seq,
                                      part_pages, scale, stream);
  else
    err = launch_part<T, kVec, 32, 1>(grid, smem, q, kp, vp, bt, cl, ws, sqb,
                                      sqh, H, D, page_size, pages_per_seq,
                                      part_pages, scale, stream);
  if (err != cudaSuccess) return err;
  paged_attn_merge_kernel<T><<<dim3(H, B), kDMax, 0, stream>>>(
      ws, static_cast<T*>(out), H, D, n_parts);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, D] with element strides (last dim contiguous); pools
// [P, page_size, H, D] contiguous; block_tables [B, pages_per_seq] int32
// and context_lens [B] int32 contiguous; out [B, H, D] contiguous; ws an
// fp32 workspace of B * H * n_parts * (D + 2) floats, n_parts =
// ceil(pages_per_seq / part_pages). D <= 128.
extern "C" int pt_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const int* block_tables,
                                  const int* context_lens, void* out,
                                  float* ws, int64_t sqb, int64_t sqh, int B,
                                  int H, int D, int page_size,
                                  int pages_per_seq, int part_pages,
                                  int n_parts, float scale, int is_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16
          ? launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                  context_lens, out, ws, sqb, sqh, B, H, D,
                                  page_size, pages_per_seq, part_pages,
                                  n_parts, scale, s)
          : launch<float>(q, k_pages, v_pages, block_tables, context_lens,
                          out, ws, sqb, sqh, B, H, D, page_size,
                          pages_per_seq, part_pages, n_parts, scale, s);
  return static_cast<int>(err);
}
