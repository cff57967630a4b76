// Flash-attention forward for Hopper: out and the per-row logsumexp.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fa_fwd_pallas`
// (tiled online softmax, kernel `_fa_fwd_kernel` l.198) and
// `_fa_small_fwd_pallas` (single-shot path for Lq == Lk <= 512, kernel
// l.438). On the card one kernel covers both: a short sequence is a tiled
// walk with few tiles, so the TPU's separate small path has no purpose.
//
// What bounds it on the H100: operations. At L = 1024, D = 64 the causal
// forward does ~2*L*L*D FLOPs per head against ~4*L*D*2 bytes in and out;
// tiles of K and V are reused by all 64 query rows of a block.
//
// Design: one block of 128 threads per (b, h, 64-row query tile). Two
// threads share a query row: each scores half of a 32-key tile and owns
// half of the output row (interleaved dims, so the two never hit one shared
// memory bank). K and V tiles stream through shared memory as fp32; the
// score tile never leaves the block. Online softmax runs in fp32. Tiles
// wholly above the causal diagonal are never loaded (kv_offset = Lk - Lq,
// as at l.820). Query rows past Lq and key rows past Lk are zero-filled and
// masked, so any L >= 1 works. Inputs are read through their [B, L, H, D]
// strides (last dim contiguous), so no transpose is needed. This first
// version uses CUDA cores, not wgmma/TMA.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 128; // 2 threads per query row
constexpr int kHalfK = kBK / 2;

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;    // [B, Lq, H, D] contiguous, input type
  float* lse;   // [B, H, Lq] fp32
  int64_t sqb, sql, sqh;
  int64_t skb, skl, skh;
  int64_t svb, svl, svh;
  int B, H, Lq, Lk, D;
  int causal;
  float scale;
};

__host__ __device__ inline size_t smem_floats(int D) {
  return static_cast<size_t>(kBQ) * (D + 1) + kBK * (D + 1) + kBK * D +
         kBQ * (kBK + 1);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FaArgs a) {
  extern __shared__ float smem[];
  const int D = a.D;
  float* Qs = smem;                    // [kBQ][D+1]
  float* Ks = Qs + kBQ * (D + 1);      // [kBK][D+1]
  float* Vs = Ks + kBK * (D + 1);      // [kBK][D]
  float* Ps = Vs + kBK * D;            // [kBQ][kBK+1]

  const int tid = threadIdx.x;
  const int r = tid >> 1;   // query row within the tile
  const int hf = tid & 1;   // which half of the keys / output dims
  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_off = a.Lk - a.Lq;

  const T* q = static_cast<const T*>(a.q) + b * a.sqb + hh * a.sqh;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + hh * a.skh;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + hh * a.svh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int rr = idx / D, d = idx - rr * D;
    const int qi = q0 + rr;
    Qs[rr * (D + 1) + d] = qi < a.Lq ? pt::to_f32(q[qi * a.sql + d]) : 0.f;
  }

  int n_tiles = (a.Lk + kBK - 1) / kBK;
  if (a.causal) {
    // the last key any row of this tile may see; later tiles are skipped
    const int last_col = q0 + kBQ - 1 + kv_off;
    n_tiles = min(n_tiles, last_col / kBK + 1);
  }

  const int qrow = q0 + r;
  float m_i = -INFINITY, l_i = 0.f;
  float acc[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int cc = idx / D, d = idx - cc * D;
      const int kj = k0 + cc;
      const bool in = kj < a.Lk;
      Ks[cc * (D + 1) + d] = in ? pt::to_f32(k[kj * a.skl + d]) : 0.f;
      Vs[cc * D + d] = in ? pt::to_f32(v[kj * a.svl + d]) : 0.f;
    }
    __syncthreads();

    float s[kHalfK];
#pragma unroll
    for (int j = 0; j < kHalfK; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[r * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kHalfK; ++j)
        s[j] += qd * Ks[(hf + 2 * j) * (D + 1) + d];
    }

    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < kHalfK; ++j) {
      const int col = k0 + hf + 2 * j;
      const bool ok = col < a.Lk && (!a.causal || qrow + kv_off >= col);
      s[j] = ok ? s[j] * a.scale : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m_i, mt);
    // a row with no visible key so far keeps p = 0 and acc = 0
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float corr = expf(m_i - mu);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kHalfK; ++j) {
      const float p = expf(s[j] - mu);
      ps += p;
      Ps[r * (kBK + 1) + hf + 2 * j] = p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    l_i = l_i * corr + ps;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) acc[i] *= corr;
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      const float pc = Ps[r * (kBK + 1) + c];
      const float* vr = Vs + c * D + hf;
#pragma unroll
      for (int i = 0; i < DMAX / 2; ++i)
        if (2 * i < D) acc[i] += pc * vr[2 * i];
    }
  }

  if (qrow < a.Lq) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    T* o = static_cast<T*>(a.out) +
           ((static_cast<int64_t>(b) * a.Lq + qrow) * a.H + hh) * D + hf;
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i)
      if (2 * i < D) o[2 * i] = pt::from_f32<T>(acc[i] * inv);
    if (hf == 0)
      a.lse[(static_cast<int64_t>(b) * a.H + hh) * a.Lq + qrow] =
          m_i + logf(fmaxf(l_i, 1e-30f));
  }
}

template <typename T, int DMAX>
cudaError_t launch(const FaArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.D) * sizeof(float);
  cudaError_t err = pt::allow_smem(flash_fwd_kernel<T, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q [B, Lq, H, D], k/v [B, Lk, H, D] with element strides (last dim
// contiguous); out [B, Lq, H, D] contiguous in the input type; lse
// [B, H, Lq] fp32. D <= 128 and even. For causal, Lk >= Lq.
extern "C" int pt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int64_t sqb, int64_t sql, int64_t sqh, int64_t skb, int64_t skl,
    int64_t skh, int64_t svb, int64_t svl, int64_t svh, int B, int H, int Lq,
    int Lk, int D, int causal, float scale, int is_bf16, void* stream) {
  FaArgs a{q,   k,   v,   out, lse, sqb, sql, sqh, skb,    skl,   skh,
           svb, svl, svh, B,   H,   Lq,  Lk,  D,   causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = D <= 64 ? launch<__nv_bfloat16, 64>(a, s)
                  : launch<__nv_bfloat16, 128>(a, s);
  else
    err = D <= 64 ? launch<float, 64>(a, s) : launch<float, 128>(a, s);
  return static_cast<int>(err);
}
