// Flash-attention backward: what the one-pass kernel
// (flash_attention_bwd.cu) and the split pair (flash_attention_bwd_split.cu)
// share — the arguments, the tile shape, and the walk of one 64-key tile
// over the q tiles at or below the causal diagonal.
//
// The walk keeps its K and V tile in shared memory and dK, dV in fp32
// registers for the block's lifetime. Per q tile it computes
// P = exp(S * scale - lse) and dS = P * (dP - delta) once and keeps both
// tiles in shared memory for the products that read them. With kDq it also
// adds this k tile's share of dQ = dS K into an fp32 [B, Lq, H, D] buffer
// with atomicAdd (the one-pass kernel); without it the walk is the split
// backward's dk/dv kernel, and dq comes from its own walk.
//
// Each thread owns a 4 x 4 micro-tile of S and dP (rows ty + 16 i, keys
// tx + 16 j), then 4 keys x D/16 dims of dK and dV (and 4 rows x D/16 dims
// of dQ); shared rows are padded to D + 1 floats so the strided reads do
// not collide on a bank. Rows past Lq and keys past Lk are zero-filled and
// masked, so any L >= 1 works; q, k, v and dO are read through their
// [B, L, H, D] strides (last dim contiguous). Offsets that can pass 2^31
// are int64 (a row index times an int64 stride or row length).
#pragma once

#include <math.h>

#include "common.cuh"

namespace pt {
namespace fa_bwd {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
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
  void* dq;            // [B, Lq, H, D] contiguous: fp32 (one-pass, zeroed)
                       // or the input type (split)
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

// shared floats of the k-tile walk
inline size_t kv_walk_smem_floats(int D) {
  return static_cast<size_t>(2 * kBK + 2 * kBQ) * (D + 1) +
         2 * kBQ * kPS + 2 * kBQ;
}

// S = Q K^T and dP = dO V^T on this thread's 4 x 4 micro-tile (rows
// ty + 16 i of Qs/Os, keys tx + 16 j of Ks/Vs), then P and dS into Ps / Ss
// (Ps may be null: the dq walk needs dS alone).
__device__ __forceinline__ void p_ds_tile(
    const float* Qs, const float* Os, const float* Ks, const float* Vs,
    const float* Ls, const float* Dl, float* Ps, float* Ss, int DP, int D,
    int q0, int k0, int tx, int ty, const BwdArgs& a) {
  const int kv_off = a.Lk - a.Lq;
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
      if (Ps != nullptr) Ps[r * kPS + c] = p;
      Ss[r * kPS + c] = p * (dp[i][j] - dl);
    }
  }
}

// One block per (64-key tile = blockIdx.x, b * h = blockIdx.y).
template <typename T, int DMAX, bool kDq>
__device__ __forceinline__ void kv_walk(const BwdArgs& a) {
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

  for (int idx = tid; idx < kBK * D; idx += kThreads) {
    const int c = idx / D, d = idx - c * D;
    const int kj = k0 + c;
    const bool in = kj < a.Lk;
    Ks[c * DP + d] = in ? to_f32(k[kj * a.skl + d]) : 0.f;
    Vs[c * DP + d] = in ? to_f32(v[kj * a.svl + d]) : 0.f;
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
      Qs[r * DP + d] = in ? to_f32(q[qi * a.sql + d]) : 0.f;
      Os[r * DP + d] = in ? to_f32(dout[qi * a.sol + d]) : 0.f;
    }
    if (tid < kBQ) {
      const int qi = q0 + tid;
      Ls[tid] = qi < a.Lq ? lse[qi] : 0.f;
      Dl[tid] = qi < a.Lq ? delta[qi] : 0.f;
    }
    __syncthreads();

    p_ds_tile(Qs, Os, Ks, Vs, Ls, Dl, Ps, Ss, DP, D, q0, k0, tx, ty, a);
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

    if constexpr (kDq) {
      // dQ (this k tile's share) = dS K: rows ty + 16 i, dims tx + 16 j
      float* dq = static_cast<float*>(a.dq) +
                  static_cast<int64_t>(b) * a.Lq * row_stride + hh * D;
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
        dk[kj * row_stride + d] = from_f32<T>(dk_acc[i][j] * a.scale);
        dv[kj * row_stride + d] = from_f32<T>(dv_acc[i][j]);
      }
    }
  }
}

}  // namespace fa_bwd
}  // namespace pt
