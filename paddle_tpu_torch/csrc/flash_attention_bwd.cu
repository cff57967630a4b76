// Flash-attention backward for Hopper: dq, dk and dv in one pass.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fa_bwd_fused_pallas`
// (one-pass backward, kernel `_fa_bwd_fused_kernel` l.856) and
// `_fa_small_bwd_pallas` (single-shot path for Lq == Lk <= 512, kernel
// l.474). As for the forward, one kernel covers both: a short sequence is
// a walk with few tiles.
//
// What bounds it on the H100: operations. Per (q tile, k tile) pair it does
// five products of 64 x 64 x D (S = Q K^T, dP = dO V^T, dV += P^T dO,
// dK += dS^T Q, dQ += dS K), about 5 * L^2/2 * D * 2 FLOPs per head when
// causal, against ~8 * L * D bytes in and out per head.
//
// TPU design: a sequential grid (b, h, k-block, q-block) that carries the
// whole (b, h) dq in VMEM scratch across the k-blocks. Blocks of a CUDA grid
// run in parallel and in no order, so nothing can be carried from one to the
// next. Card design:
// - one block of 256 threads per (64-key tile, b * h). It keeps its K and V
//   tile in shared memory and dK, dV in fp32 registers for its lifetime, and
//   walks the 64-row q tiles at or below the causal diagonal (tiles wholly
//   above it are never loaded; kv_offset = Lk - Lq as in the forward);
// - per q tile it computes P = exp(S * scale - lse) and dS = P * (dP - delta)
//   ONCE, as the TPU kernel does, and keeps both tiles in shared memory for
//   the three products that read them;
// - dq is summed across the k tiles with fp32 atomicAdd into a [B, Lq, H, D]
//   buffer the wrapper zeroes and then casts, so its summation order varies
//   from run to run (the tolerance says so);
// - each thread owns a 4 x 4 micro-tile of S and dP (rows ty + 16 i, keys
//   tx + 16 j), then 4 keys x D/16 dims of dK and dV and 4 rows x D/16 dims
//   of dQ; shared rows are padded to D + 1 floats so the strided reads do
//   not collide on a bank.
// Rows past Lq and keys past Lk are zero-filled and masked, so any L >= 1
// works. q, k, v and dO are read through their [B, L, H, D] strides (last
// dim contiguous). Shared memory is ~98 KB at D = 64 and ~162 KB at D = 128,
// above the 48 KB default, so the launch raises the cap. This first version
// uses CUDA cores, not wgmma/TMA.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per step of the walk
constexpr int kBK = 64;        // keys per block
constexpr int kTX = 16;        // thread grid 16 x 16
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kRI = kBQ / kTY; // rows per thread
constexpr int kCJ = kBK / kTX; // keys per thread in S and dP
constexpr int kPS = kBK + 1;   // padded row of the P and dS tiles
// dK and dV give each thread kBK / kTY keys, held in [kRI] arrays
static_assert(kBK / kTY == kRI, "dK/dV rows per thread must equal kRI");

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Lq]
  const float* delta;  // [B, H, Lq]
  float* dq;           // [B, Lq, H, D] fp32, zeroed by the wrapper
  void* dk;            // [B, Lk, H, D] contiguous, input type
  void* dv;            // [B, Lk, H, D] contiguous, input type
  int64_t sqb, sql, sqh;
  int64_t skb, skl, skh;
  int64_t svb, svl, svh;
  int64_t sob, sol, soh;
  int B, H, Lq, Lk, D;
  int causal;
  float scale;
};

inline size_t smem_floats(int D) {
  return static_cast<size_t>(2 * kBK + 2 * kBQ) * (D + 1) +
         2 * kBQ * kPS + 2 * kBQ;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(BwdArgs a) {
  constexpr int kDJ = DMAX / kTX;  // dims per thread
  extern __shared__ float smem[];
  const int D = a.D;
  const int DP = D + 1;
  float* Ks = smem;              // [kBK][DP]
  float* Vs = Ks + kBK * DP;     // [kBK][DP]
  float* Qs = Vs + kBK * DP;     // [kBQ][DP]
  float* Os = Qs + kBQ * DP;     // dO [kBQ][DP]
  float* Ps = Os + kBQ * DP;     // P [kBQ][kPS]
  float* Ss = Ps + kBQ * kPS;    // dS [kBQ][kPS]
  float* Ls = Ss + kBQ * kPS;    // lse [kBQ]
  float* Dl = Ls + kBQ;          // delta [kBQ]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int hh = bh - b * a.H;
  const int kv_off = a.Lk - a.Lq;

  const T* q = static_cast<const T*>(a.q) + b * a.sqb + hh * a.sqh;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + hh * a.skh;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + hh * a.svh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.sob + hh * a.soh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * a.Lq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * a.Lq;
  const int64_t row_stride = static_cast<int64_t>(a.H) * D;  // dq, dk, dv
  float* dq = a.dq + static_cast<int64_t>(b) * a.Lq * row_stride + hh * D;

  for (int idx = tid; idx < kBK * D; idx += kThreads) {
    const int c = idx / D, d = idx - c * D;
    const int kj = k0 + c;
    const bool in = kj < a.Lk;
    Ks[c * DP + d] = in ? pt::to_f32(k[kj * a.skl + d]) : 0.f;
    Vs[c * DP + d] = in ? pt::to_f32(v[kj * a.svl + d]) : 0.f;
  }

  float dk_acc[kRI][kDJ], dv_acc[kRI][kDJ];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // first q tile with a row that sees key k0: rows r with r + kv_off >= k0
  int qt = 0;
  if (a.causal) qt = max(0, k0 - kv_off) / kBQ;
  const int n_qt = (a.Lq + kBQ - 1) / kBQ;

  for (; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous tile's Qs/Os/Ps/Ss are no longer read
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const int qi = q0 + r;
      const bool in = qi < a.Lq;
      Qs[r * DP + d] = in ? pt::to_f32(q[qi * a.sql + d]) : 0.f;
      Os[r * DP + d] = in ? pt::to_f32(dout[qi * a.sol + d]) : 0.f;
    }
    if (tid < kBQ) {
      const int qi = q0 + tid;
      Ls[tid] = qi < a.Lq ? lse[qi] : 0.f;
      Dl[tid] = qi < a.Lq ? delta[qi] : 0.f;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T on this thread's 4 x 4 micro-tile
    float s[kRI][kCJ], dp[kRI][kCJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRI], ov[kRI], kv[kCJ], vv[kCJ];
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        qv[i] = Qs[(ty + kTY * i) * DP + d];
        ov[i] = Os[(ty + kTY * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        kv[j] = Ks[(tx + kTX * j) * DP + d];
        vv[j] = Vs[(tx + kTX * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int r = ty + kTY * i;
      const int qi = q0 + r;
      const float l = Ls[r];
      const float dl = Dl[r];
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int c = tx + kTX * j;
        const int kj = k0 + c;
        const bool ok = qi < a.Lq && kj < a.Lk &&
                        (!a.causal || qi + kv_off >= kj) && l != -INFINITY;
        const float p = ok ? expf(s[i][j] * a.scale - l) : 0.f;
        Ps[r * kPS + c] = p;
        Ss[r * kPS + c] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: keys ty + 16 i, dims tx + 16 j
    const int rows = min(kBQ, a.Lq - q0);
    for (int r = 0; r < rows; ++r) {
      float pv[kRI], sv[kRI];
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        pv[i] = Ps[r * kPS + ty + kTY * i];
        sv[i] = Ss[r * kPS + ty + kTY * i];
      }
#pragma unroll
      for (int j = 0; j < kDJ; ++j) {
        const int d = tx + kTX * j;
        if (d < D) {
          const float o = Os[r * DP + d];
          const float qq = Qs[r * DP + d];
#pragma unroll
          for (int i = 0; i < kRI; ++i) {
            dv_acc[i][j] += pv[i] * o;
            dk_acc[i][j] += sv[i] * qq;
          }
        }
      }
    }

    // dQ (this k tile's share) = dS K: rows ty + 16 i, dims tx + 16 j
    float dqp[kRI][kDJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kDJ; ++j) dqp[i][j] = 0.f;
    for (int c = 0; c < kBK; ++c) {
      float sv[kRI];
#pragma unroll
      for (int i = 0; i < kRI; ++i) sv[i] = Ss[(ty + kTY * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) {
        const int d = tx + kTX * j;
        if (d < D) {
          const float kk = Ks[c * DP + d];
#pragma unroll
          for (int i = 0; i < kRI; ++i) dqp[i][j] += sv[i] * kk;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int qi = q0 + ty + kTY * i;
      if (qi >= a.Lq) continue;
#pragma unroll
      for (int j = 0; j < kDJ; ++j) {
        const int d = tx + kTX * j;
        if (d < D) atomicAdd(dq + qi * row_stride + d, dqp[i][j] * a.scale);
      }
    }
  }

  T* dk = static_cast<T*>(a.dk) + static_cast<int64_t>(b) * a.Lk * row_stride +
          hh * D;
  T* dv = static_cast<T*>(a.dv) + static_cast<int64_t>(b) * a.Lk * row_stride +
          hh * D;
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int kj = k0 + ty + kTY * i;
    if (kj >= a.Lk) continue;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      const int d = tx + kTX * j;
      if (d < D) {
        dk[kj * row_stride + d] = pt::from_f32<T>(dk_acc[i][j] * a.scale);
        dv[kj * row_stride + d] = pt::from_f32<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.D) * sizeof(float);
  cudaError_t err = pt::allow_smem(flash_bwd_kernel<T, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + kBK - 1) / kBK, a.B * a.H);
  flash_bwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q [B, Lq, H, D], k/v [B, Lk, H, D], dout [B, Lq, H, D] with element
// strides (last dim contiguous); lse and delta [B, H, Lq] fp32; dq
// [B, Lq, H, D] fp32, zeroed; dk/dv [B, Lk, H, D] contiguous in the input
// type. D <= 128, a multiple of 8. For causal, Lk >= Lq.
extern "C" int pt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq, void* dk, void* dv,
    int64_t sqb, int64_t sql, int64_t sqh, int64_t skb, int64_t skl,
    int64_t skh, int64_t svb, int64_t svl, int64_t svh, int64_t sob,
    int64_t sol, int64_t soh, int B, int H, int Lq, int Lk, int D, int causal,
    float scale, int is_bf16, void* stream) {
  BwdArgs a{q,   k,   v,   dout, lse, delta, dq, dk,  dv,  sqb, sql,
            sqh, skb, skl, skh,  svb, svl,   svh, sob, sol, soh, B,
            H,   Lq,  Lk,  D,    causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = D <= 64 ? launch<__nv_bfloat16, 64>(a, s)
                  : launch<__nv_bfloat16, 128>(a, s);
  else
    err = D <= 64 ? launch<float, 64>(a, s) : launch<float, 128>(a, s);
  return static_cast<int>(err);
}
