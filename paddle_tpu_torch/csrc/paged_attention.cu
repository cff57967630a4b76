// Paged decode attention for Hopper: one query token per sequence over a
// paged K/V pool.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_paged_attn_pallas`
// (kernel `_paged_attn_kernel` l.103): the block table picks each page,
// online softmax runs across pages, pages past context_lens are never read,
// and ctx == 0 gives exactly 0.
//
// What bounds it on the H100: bytes. Each live K/V element is read once
// for 2 FLOPs; the query, the block-table row and the output are tiny.
//
// Design: one block of 4 warps per (b, head). Warp w walks live pages
// w, w+4, ...; within a page each token's K row (D contiguous values) is
// read by the whole warp in one coalesced load, its score reduced with
// shuffles, and the warp's running max / sum / output row updated in fp32.
// The four partial softmax states merge through shared memory at the end.
// The TPU kernel walked every block-table slot and masked dead pages; here
// the loop stops at ceil(ctx / page_size), so no dead page costs a read.
//
// Contract (checked by the wrapper): pools are [P, page, H, D] contiguous;
// block_tables [B, pages_per_seq] int32 holds valid page ids in every slot
// the walk reaches (the serving allocator only writes ids it handed out,
// and the null page 0 elsewhere); context_lens [B] int32. A context longer
// than pages_per_seq * page is cut to it, as the TPU grid was.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kDMax = 128;
constexpr int kPerLane = kDMax / 32;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) paged_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, T* __restrict__ out, int64_t sqb,
    int64_t sqh, int H, int D, int page_size, int pages_per_seq,
    float scale) {
  __shared__ float w_m[kWarps], w_l[kWarps];
  __shared__ float w_acc[kWarps][kDMax];

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int ctx = context_lens[b];
  const int n_live =
      ctx > 0 ? min((ctx + page_size - 1) / page_size, pages_per_seq) : 0;
  const int ctx_cut = min(ctx, pages_per_seq * page_size);

  float qv[kPerLane], acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? pt::to_f32(q[b * sqb + hh * sqh + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int64_t tok_stride = static_cast<int64_t>(H) * D;
  const int* bt = block_tables + static_cast<int64_t>(b) * pages_per_seq;
  for (int p = warp; p < n_live; p += kWarps) {
    const int64_t base =
        static_cast<int64_t>(bt[p]) * page_size * tok_stride + hh * D;
    const int n_tok = min(page_size, ctx_cut - p * page_size);
    for (int t = 0; t < n_tok; ++t) {
      const T* kr = k_pages + base + t * tok_stride;
      const T* vr = v_pages + base + t * tok_stride;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) part += qv[i] * pt::to_f32(kr[d]);
      }
      const float s = pt::warp_sum(part) * scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);  // 0 on the first token
      const float p_t = expf(s - m_new);
      l = l * corr + p_t;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = acc[i] * corr + p_t * pt::to_f32(vr[d]);
      }
      m = m_new;
    }
  }

  if (lane == 0) {
    w_m[warp] = m;
    w_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) w_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  const int d = threadIdx.x;
  if (d < D) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_m[w]);
    float o = 0.f;
    if (mx != -INFINITY) {  // ctx == 0 leaves every warp empty: output 0
      float lsum = 0.f, osum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(w_m[w] - mx);  // 0 for an empty warp
        lsum += w_l[w] * c;
        osum += w_acc[w][d] * c;
      }
      o = osum / fmaxf(lsum, 1e-30f);
    }
    out[(static_cast<int64_t>(b) * H + hh) * D + d] = pt::from_f32<T>(o);
  }
}

template <typename T>
void launch(const void* q, const void* kp, const void* vp, const int* bt,
            const int* cl, void* out, int64_t sqb, int64_t sqh, int B, int H,
            int D, int page_size, int pages_per_seq, float scale,
            cudaStream_t stream) {
  const dim3 grid(H, B);
  paged_attn_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, cl, static_cast<T*>(out), sqb, sqh, H,
      D, page_size, pages_per_seq, scale);
}

}  // namespace

// q [B, H, D] with element strides (last dim contiguous); pools
// [P, page_size, H, D] contiguous; block_tables [B, pages_per_seq] int32
// and context_lens [B] int32 contiguous; out [B, H, D] contiguous.
// D <= 128.
extern "C" int pt_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const int* block_tables,
                                  const int* context_lens, void* out,
                                  int64_t sqb, int64_t sqh, int B, int H,
                                  int D, int page_size, int pages_per_seq,
                                  float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, context_lens,
                          out, sqb, sqh, B, H, D, page_size, pages_per_seq,
                          scale, s);
  else
    launch<float>(q, k_pages, v_pages, block_tables, context_lens, out, sqb,
                  sqh, B, H, D, page_size, pages_per_seq, scale, s);
  return static_cast<int>(cudaGetLastError());
}
