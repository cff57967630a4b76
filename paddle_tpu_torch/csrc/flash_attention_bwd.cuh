// Flash-attention backward: what the one-pass kernel
// (flash_attention_bwd.cu) and the split pair (flash_attention_bwd_split.cu)
// share — the arguments, the tile shape, and the walk of one 64-key tile
// over the q tiles at or below the causal diagonal, in two designs.
//
// `kv_walk<T, D, kDq>`, CUDA cores (fp32, other head dims, unaligned
// rows): the walk keeps its K and V tile in shared memory and dK, dV in
// fp32 registers for the block's lifetime. Per q tile it computes
// P = exp(S * scale - lse) and dS = P * (dP - delta) once and keeps both
// tiles in shared memory for the products that read them. With kDq it also
// adds this k tile's share of dQ = dS K into an fp32 [B, Lq, H, D] buffer
// with atomicAdd (the one-pass kernel); without it the walk is the split
// backward's dk/dv kernel, and dq comes from its own walk. Each thread
// owns a 4 x 4 micro-tile of S and dP (rows ty + 16 i, keys tx + 16 j),
// then 4 keys x D/16 dims of dK and dV (and 4 rows x D/16 dims of dQ);
// shared rows are padded to D + 1 floats so the strided reads do not
// collide on a bank.
//
// `kv_walk_tc<D, kDq>`, tensor cores (bf16, D 64 or 128, aligned rows):
// 4 warps, each owning 16 of the tile's keys. K and V stay in shared memory
// as bf16; the q tiles (Q, dO, and lse and delta) stream through a 2-stage
// ring, Q and dO by cp.async. The walk computes the transposed tiles,
// S^T = K Q^T and dP^T = V dO^T, by mma.sync m16n8k16 with fp32
// accumulators, so P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T -
// delta) come out in accumulator layout: packed to bf16 (the reference's
// casts before its dv and dk products) they are the A fragments of
// dV += P^T dO and dK += dS^T Q, whose B operands (dO and Q, stored
// [q][d]) are read through ldmatrix.trans. dK and dV stay in fp32
// registers and are written once. With kDq (the one-pass kernel) dS^T also
// goes to shared memory, and the warps add dS K into the fp32 dq buffer
// with atomics, 16 q rows a warp.
//
// The bool mask, as in the forward (flash_attention.cu): an optional
// [B, H, Lq, Lk] byte array read through four element strides (0 on a
// broadcast dim); P is 0 where it is false, so dS is too. A row with no
// visible key (lse -inf, from the forward) gets P = 0 everywhere: dq 0 and
// nothing added to dk or dv. Both walks compile the mask in or out
// (`kMask`), so the walks without it are unchanged; with it every tile is
// masked element by element.
//
// Rows past Lq and keys past Lk are zero-filled and masked, so any L >= 1
// works; q, k, v and dO are read through their [B, L, H, D] strides (last
// dim contiguous). Offsets that can pass 2^31 are int64 (a row index times
// an int64 stride or row length).
#pragma once

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

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
  const uint8_t* mask; // bool [B, H, Lq, Lk] through its strides, or null
  int64_t smb, smh, smq, smk;  // 0 on a broadcast dim
};

// the (b, h) slice of the mask, element (row, col) at row * smq + col * smk
__device__ __forceinline__ const uint8_t* mask_slice(const BwdArgs& a, int b,
                                                     int hh) {
  return a.mask + b * a.smb + hh * a.smh;
}

// shared floats of the k-tile walk
inline size_t kv_walk_smem_floats(int D) {
  return static_cast<size_t>(2 * kBK + 2 * kBQ) * (D + 1) +
         2 * kBQ * kPS + 2 * kBQ;
}

// S = Q K^T and dP = dO V^T on this thread's 4 x 4 micro-tile (rows
// ty + 16 i of Qs/Os, keys tx + 16 j of Ks/Vs), then P and dS into Ps / Ss
// (Ps may be null: the dq walk needs dS alone); with kMask, mk is the
// (b, h) slice of the mask.
template <bool kMask>
__device__ __forceinline__ void p_ds_tile(
    const float* Qs, const float* Os, const float* Ks, const float* Vs,
    const float* Ls, const float* Dl, float* Ps, float* Ss, int DP, int D,
    int q0, int k0, int tx, int ty, const uint8_t* mk, const BwdArgs& a) {
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
      bool ok = qi < a.Lq && kj < a.Lk &&
                (!a.causal || qi + kv_off >= kj) && l != -INFINITY;
      if constexpr (kMask) ok = ok && mk[qi * a.smq + kj * a.smk];
      const float p = ok ? expf(s[i][j] * a.scale - l) : 0.f;
      if (Ps != nullptr) Ps[r * kPS + c] = p;
      Ss[r * kPS + c] = p * (dp[i][j] - dl);
    }
  }
}

// One block per (64-key tile = blockIdx.x, b * h = blockIdx.y).
template <typename T, int DMAX, bool kDq, bool kMask>
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
  const uint8_t* mk = kMask ? mask_slice(a, b, hh) : nullptr;
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

    p_ds_tile<kMask>(Qs, Os, Ks, Vs, Ls, Dl, Ps, Ss, DP, D, q0, k0, tx, ty,
                     mk, a);
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

// ------------------------------ tensor cores --------------------------------

constexpr int kTcThreads = 128;  // 4 warps, 16 rows (or keys) a warp
constexpr float kLog2e = 1.4426950408889634f;

// true when the tensor-core designs take these inputs: bf16 (checked by
// the caller), D 64 or 128, every row 16-byte aligned; the wrapper's
// `bwd_design` says the same
inline bool tc_takes(const BwdArgs& a) {
  constexpr int e = sizeof(__nv_bfloat16);
  return (a.D == 64 || a.D == 128) &&
         rows_aligned16(a.q, a.sqb, a.sql, a.sqh, e) &&
         rows_aligned16(a.k, a.skb, a.skl, a.skh, e) &&
         rows_aligned16(a.v, a.svb, a.svl, a.svh, e) &&
         rows_aligned16(a.dout, a.sob, a.sol, a.soh, e);
}

constexpr int kLS = kBQ + 8;  // padded row of the staged dS^T tile

// scale times one 16 x 8 mma accumulator tile c (rows g and g + 8, cols
// 2t and 2t + 1 in each thread) added into fp32 rows at p (row g) and
// p + row8 (row g + 8), columns 0..7, as two-float atomics (four-float
// ones after a lane swap, half the instructions for the same bytes, ran
// no faster on the H100: tools/ab_dq_epilogue.py); in_g, in_g8: whether
// the rows exist
__device__ __forceinline__ void add_dq_tile(float* p, int64_t row8,
                                            const float (&c)[4], float scale,
                                            int t, bool in_g, bool in_g8) {
  if (in_g)
    atomicAdd(reinterpret_cast<float2*>(p + 2 * t),
              make_float2(c[0] * scale, c[1] * scale));
  if (in_g8)
    atomicAdd(reinterpret_cast<float2*>(p + row8 + 2 * t),
              make_float2(c[2] * scale, c[3] * scale));
}

// bytes of shared memory of the tensor-core k-tile walk: K and V, two
// stages of Q, dO and of lse, delta, and with kDq the dS^T tile
template <int D, bool kDq>
constexpr size_t kv_walk_tc_smem_bytes() {
  return static_cast<size_t>(2 * kBK + 4 * kBQ) * (D + 8) *
             sizeof(__nv_bfloat16) +
         4 * kBQ * sizeof(float) +
         (kDq ? static_cast<size_t>(kBK) * kLS * sizeof(__nv_bfloat16) : 0);
}

// One block per (64-key tile = blockIdx.x, b * h = blockIdx.y). With kDq
// (the one-pass kernel) the walk also adds this k tile's share of
// dQ = dS K into the fp32 [B, Lq, H, D] buffer: dS^T, already packed to
// bf16 as the dK product's A fragments, is stored to shared memory as
// [key][q row]; after a barrier warp w computes q rows 16w..16w+15 of
// dS K by mma.sync, reading dS through ldmatrix.trans and K (stored
// [key][d]) through ldmatrix.trans, kDqN columns at a time so that no
// D-wide accumulator lives beside dK and dV, and adds each chunk, times
// scale, with two-float atomics (`add_dq_tile`).
template <int D, bool kDq, bool kMask>
__device__ __forceinline__ void kv_walk_tc(const BwdArgs& a) {
  constexpr int LD = D + 8;   // padded shared row, in elements
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of a dK / dV row
  constexpr int kDqN = D == 64 ? 64 : 32;  // dQ columns a chunk
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kBK][LD]
  bf16* Vs = Ks + kBK * LD;                      // [kBK][LD]
  bf16* Qs = Vs + kBK * LD;                      // [2][kBQ][LD]
  bf16* Os = Qs + 2 * kBQ * LD;                  // dO [2][kBQ][LD]
  float* Ls = reinterpret_cast<float*>(Os + 2 * kBQ * LD);  // [2][kBQ]
  float* Dl = Ls + 2 * kBQ;                                 // [2][kBQ]
  bf16* St = reinterpret_cast<bf16*>(Dl + 2 * kBQ);  // dS^T [kBK][kLS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int hh = bh - b * a.H;
  const int kv_off = a.Lk - a.Lq;

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sqb + hh * a.sqh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.skb + hh * a.skh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.svb + hh * a.svh;
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.sob + hh * a.soh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * a.Lq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * a.Lq;
  const uint8_t* mk = kMask ? mask_slice(a, b, hh) : nullptr;

  // first q tile with a row that sees key k0: rows r with r + kv_off >= k0
  int qt = 0;
  if (a.causal) qt = max(0, k0 - kv_off) / kBQ;
  const int n_qt = (a.Lq + kBQ - 1) / kBQ;

  // a q tile into stage `stage`: Q and dO by cp.async; lse in base 2 and
  // delta by plain loads (their rows need not be 16-byte aligned). A row
  // past Lq, or one with no visible key (lse -inf), gets lse +inf, so its
  // P is 0.
  auto load_q = [&](int stage, int tile) {
    const int q0 = tile * kBQ;
    load_rows_async<kBQ, D, LD, kTcThreads>(Qs + stage * kBQ * LD, q, a.sql,
                                            q0, a.Lq, tid);
    load_rows_async<kBQ, D, LD, kTcThreads>(Os + stage * kBQ * LD, dout,
                                            a.sol, q0, a.Lq, tid);
    if (tid < kBQ) {
      const int qi = q0 + tid;
      const float ls = qi < a.Lq ? lse[qi] : -INFINITY;
      Ls[stage * kBQ + tid] = ls == -INFINITY ? INFINITY : ls * kLog2e;
    } else {
      const int qi = q0 + tid - kBQ;
      Dl[stage * kBQ + tid - kBQ] = qi < a.Lq ? delta[qi] : 0.f;
    }
  };

  load_rows_async<kBK, D, LD, kTcThreads>(Ks, k, a.skl, k0, a.Lk, tid);
  load_rows_async<kBK, D, LD, kTcThreads>(Vs, v, a.svl, k0, a.Lk, tid);
  load_q(0, qt);
  cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float sl2 = a.scale * kLog2e;
  for (int it = 0; qt < n_qt; ++qt, ++it) {
    const int st = it & 1;
    if (qt + 1 < n_qt) load_q(st ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this q tile has landed
    __syncthreads();
    const bf16* Qt = Qs + st * kBQ * LD;
    const bf16* Ot = Os + st * kBQ * LD;
    const float* Lt = Ls + st * kBQ;
    const float* Dt = Dl + st * kBQ;
    const int q0 = qt * kBQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 rows a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned ka[4], va[4];
      load_a<LD>(ka, Ks, warp * 16, kk * 16, lane);
      load_a<LD>(va, Vs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned qb[4], ob[4];
        load_b<LD>(qb, Qt, np * 16, kk * 16, lane);
        load_b<LD>(ob, Ot, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], ka, qb[0], qb[1]);
        mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
        mma_bf16(dp[2 * np], va, ob[0], ob[1]);
        mma_bf16(dp[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    // P^T and dS^T in place; only tiles that cross the diagonal are
    // masked element by element (rows past Lq have lse +inf), and with a
    // mask every tile by the mask (keys past Lk meet zero-filled K and V
    // rows, and read no mask byte)
    const bool edge = a.causal && k0 + kBK - 1 > q0 + kv_off;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = n * 8 + 2 * t + j;  // row of the q tile
        const float lq = Lt[c];
        const float dl = Dt[c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + j;
          float p = exp2f(s[n][e] * sl2 - lq);
          if (edge && key0 + 8 * i > q0 + c + kv_off) p = 0.f;
          if constexpr (kMask) {
            const int row = q0 + c, key = key0 + 8 * i;
            if (row >= a.Lq || key >= a.Lk || !mk[row * a.smq + key * a.smk])
              p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl);
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T packed to bf16 as A
    // fragments, dO and Q through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      unsigned sa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                        pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                        pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                        pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      if constexpr (kDq) {
        // sa[0], sa[2]: key warp * 16 + g; sa[1], sa[3]: 8 keys on; q
        // rows kk * 16 + 2t (+1) and 8 rows on
        unsigned* row = reinterpret_cast<unsigned*>(
            St + (warp * 16 + g) * kLS + kk * 16 + 2 * t);
        row[0] = sa[0];
        row[4] = sa[2];
        row[8 * kLS / 2] = sa[1];
        row[8 * kLS / 2 + 4] = sa[3];
      }
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        unsigned ob[4], qb[4];
        load_b_trans<LD>(ob, Ot, dn * 16, kk * 16, lane);
        mma_bf16(dv[2 * dn], pa, ob[0], ob[1]);
        mma_bf16(dv[2 * dn + 1], pa, ob[2], ob[3]);
        load_b_trans<LD>(qb, Qt, dn * 16, kk * 16, lane);
        mma_bf16(dk[2 * dn], sa, qb[0], qb[1]);
        mma_bf16(dk[2 * dn + 1], sa, qb[2], qb[3]);
      }
    }
    if constexpr (kDq) {
      __syncthreads();  // the whole dS^T tile is staged
      const int r0 = warp * 16;  // this warp's q rows of the tile
      const int qi = q0 + r0 + g;
      float* dqp = static_cast<float*>(a.dq) +
                   (static_cast<int64_t>(b) * a.Lq + qi) * a.H * D + hh * D;
      const int64_t row8 = static_cast<int64_t>(8) * a.H * D;
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += kDqN) {
        float acc[kDqN / 8][4];
#pragma unroll
        for (int n = 0; n < kDqN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          unsigned da[4];
          load_a_trans<kLS>(da, St, r0, kk * 16, lane);
#pragma unroll
          for (int dn = 0; dn < kDqN / 16; ++dn) {
            unsigned kb[4];
            load_b_trans<LD>(kb, Ks, c0 + dn * 16, kk * 16, lane);
            mma_bf16(acc[2 * dn], da, kb[0], kb[1]);
            mma_bf16(acc[2 * dn + 1], da, kb[2], kb[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < kDqN / 8; ++n)
          add_dq_tile(dqp + c0 + n * 8, row8, acc[n], a.scale, t,
                      qi < a.Lq, qi + 8 < a.Lq);
      }
    }
    __syncthreads();  // stage st (and dS^T) is free for the next q tile
  }
  cp_async_wait<0>();

  const int64_t row_stride = static_cast<int64_t>(a.H) * D;
  bf16* dkp = static_cast<bf16*>(a.dk) +
              static_cast<int64_t>(b) * a.Lk * row_stride + hh * D;
  bf16* dvp = static_cast<bf16*>(a.dv) +
              static_cast<int64_t>(b) * a.Lk * row_stride + hh * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = key0 + 8 * i;
    if (kj >= a.Lk) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int64_t off = kj * row_stride + n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkp + off) = __floats2bfloat162_rn(
          dk[n][2 * i] * a.scale, dk[n][2 * i + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + off) =
          __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

}  // namespace fa_bwd
}  // namespace pt
