// Flash-attention backward: what the one-pass kernel
// (flash_attention_bwd.cu) and the split pair (flash_attention_bwd_split.cu)
// share — the arguments, the tile shape, and the walk of one 64-key tile
// over the q tiles at or below the causal diagonal, in three designs.
//
// `kv_walk<T, D, kDq>`, CUDA cores (other head dims, unaligned rows): the
// walk keeps its K and V tile in shared memory and dK, dV in
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
// `kv_walk_tf32<D, kDq>`, TF32 tensor cores in a 3xTF32 split (fp32, D 64
// or 128, aligned rows): the same walk on mma.sync m16n8k8 with fp32
// tiles in shared memory, split into TF32 hi and lo where each fragment is
// loaded; see its comment for what the fragment layout changes.
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

// true when the tensor-core designs take these inputs: D 64 or 128, every
// row 16-byte aligned, `e` bytes an element (2 for bf16, 4 for fp32); the
// wrapper's `bwd_design` says the same
inline bool tc_takes(const BwdArgs& a, int e) {
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

// ------------------------- fp32, 3xTF32 tensor cores -------------------------

// q rows a tile of the 3xTF32 k-tile walk: 64 at D 64; 32 at D 128, where
// dK and dV take 128 fp32 registers a thread and a 64-row tile's S^T and
// dP^T 64 more
template <int D>
__host__ __device__ constexpr int tf32_bq() {
  return D == 64 ? 64 : 32;
}

// bytes of shared memory of the 3xTF32 k-tile walk: K and V, one stage of
// Q and dO (rows of D + 4 floats; with kPre their lo planes too), lse and
// delta, and with kDq the dS^T tile
template <int D, bool kDq, bool kPre>
__host__ __device__ constexpr size_t kv_walk_tf32_bytes() {
  constexpr int BQ = tf32_bq<D>();
  return sizeof(float) *
         (static_cast<size_t>(2 * kBK + (kPre ? 4 : 2) * BQ) * (D + 4) +
          2 * BQ + (kDq ? static_cast<size_t>(kBK) * BQ : 0));
}

// the most shared memory a block may take for two to share an H100 SM
// (228 KB, 1 KB of it reserved a block)
constexpr size_t kHalfSm = 233472 / 2 - 1024;

// Where the walk splits Q and dO into TF32 hi and lo, each read by two
// products: at each fragment load, as the fp32 forward does (each warp
// splits the whole q tile for each product), or once a q tile into hi and
// lo planes in shared memory that the products load. Timed on the H100
// (tools/ab_bwd_split.py; NVIDIA H100 80GB HBM3, 700.00 W), ms at load /
// pre-split: one-pass B 8 L 1,024 causal 0.8765 / 0.8620, B 256 L 128
// 0.6754 / 0.8840, B 2 L 1,024 D 128 0.7060 / 0.7267; split dk/dv B 1
// L 4,096 1.2145 / 1.0702. The planes pay where two blocks still share
// an SM (the dk/dv walk at D 64, which stages no dS^T) and cost where
// they leave one (the 2-tile walks of B 256 L 128 lose 31 %), so the walk
// pre-splits exactly when two blocks fit; -DPT_TF32_BWD_PRESPLIT=0 or 1
// forces either (the tool builds both).
template <int D, bool kDq>
__host__ __device__ constexpr bool tf32_presplit() {
#ifdef PT_TF32_BWD_PRESPLIT
  return PT_TF32_BWD_PRESPLIT;
#else
  return kv_walk_tf32_bytes<D, kDq, true>() <= kHalfSm;
#endif
}

// the walk's shared memory: ~85 KB at D 64 and ~107 KB at D 128 with kDq,
// ~103 KB (pre-split) and ~99 KB without, so two blocks share an SM
template <int D, bool kDq>
constexpr size_t kv_walk_tf32_smem_bytes() {
  return kv_walk_tf32_bytes<D, kDq, tf32_presplit<D, kDq>()>();
}

// tiles a 3xTF32 backward walk (q tiles of the k-tile walk, k tiles of
// the split dq walk) adds into its accumulators in registers before it
// adds them into the fp32 outputs (after tiles kFlushTiles - 1, 2
// kFlushTiles - 1, ... and the last): a chain of at most 8 x 8 x 3 = 192
// mma adds (96 at D 128). With one chain over the whole walk, dk and dv
// drifted with the walk's length, to 0.52x the fp32 tolerance against the
// plain version at L 4,096 and 2.39x (2.47x against fp64 tiles) at
// L 32,768, while dq, whose largest values come from short walks there,
// held at 0.03-0.09 (chip_smoke.py phase 3, H100)
constexpr int kFlushTiles = 8;
static_assert((kFlushTiles & (kFlushTiles - 1)) == 0, "a power of two");

// the staged dS^T tile holds element (key, row) at key * BQ + (row ^
// st_swz(key)): with the XOR, both the stores (a warp's lanes over 8 keys
// and 4 row pairs) and the dQ product's loads (over 8 rows and 4 key
// pairs) fall on 32 distinct banks
__device__ __forceinline__ int st_swz(int key) {
  return ((key & 6) << 2) | (key & 1);
}

// The k-tile walk in fp32 on the TF32 tensor cores, each product in a
// 3xTF32 split (mma.cuh): 4 warps, each owning 16 of the tile's 64 keys,
// and one block per (64-key tile = blockIdx.x, b * h = blockIdx.y). K and
// V stay in shared memory for the block's lifetime and each q tile (Q,
// dO, lse and delta) is loaded in turn, all rows of D + 4 floats (LD = 4
// mod 32): ldmatrix reads 8 rows of 4 floats on distinct banks, and so
// do the scalar loads of (row 2t, col g) below. Operands stay fp32 in
// shared memory and are split into TF32 hi and lo where each fragment is
// loaded, as the fp32 forward splits its own, but for Q and dO where
// `tf32_presplit` splits them once a q tile into hi and lo planes.
// - S^T = K Q^T and dP^T = V dO^T (16 keys x BQ rows a warp): K, V as A
//   fragments and Q, dO ([row][d], i.e. [n][k]) as B fragments, by
//   ldmatrix on fp32 data.
// - P^T = exp2(S^T * scale log2 e - lse) and dS^T = P^T (dP^T - delta) in
//   the accumulators, 0 where the causal diagonal, the key tail or the
//   mask hides a pair, and on a row with no visible key (lse +inf).
// - dV += P^T dO and dK += dS^T Q: an accumulator tile (c0, c2, c1, c3)
//   is the A fragment over its 8 rows with row 2t as k = t and row 2t+1
//   as k = t+4 (the forward's renumbering), so the B operand is dO or Q
//   at rows 2t and 2t+1, column g: two scalar loads of each, on 32
//   distinct banks.
// - with kDq (the one-pass kernel), dQ += dS K contracts over keys, the
//   accumulators' rows, so dS^T goes to shared memory (swizzled, st_swz)
//   and after a barrier warp w computes a 16-row x 64-column block of this
//   k tile's dS K (rows 16 (w % (BQ/16)), columns 64 (w / (BQ/16))): dS
//   at (row g, keys 2t and 2t+1) as A in the renumbered order, K at keys
//   2t and 2t+1, column g as B, added times scale into the fp32 dq buffer
//   with two-float atomics (`add_dq_tile`).
// dK and dV gather in fp32 registers and are added into the outputs every
// kFlushTiles q tiles in a fixed order, so they repeat bit for bit; dq's
// atomics make its summation order vary.
// Registers (ptxas -v, sm_90a), unmasked / masked: one-pass D 64 255 / 255
// (48 / 40 bytes spilled; 0 / 8 before the flushes), D 128 255 / 255
// (28 / 44); dk/dv D 64 (pre-split) 255 / 255 (0 / 8), D 128 255 / 255
// (40 / 44). Two blocks of 128 threads still fit an SM's 65,536
// registers at 255.
template <int D, bool kDq, bool kMask>
__device__ __forceinline__ void kv_walk_tf32(const BwdArgs& a) {
  constexpr int BQ = tf32_bq<D>();
  constexpr int LD = D + 4;    // padded shared row, in floats
  constexpr int KD = D / 8;    // k8 steps over the head dim
  constexpr int NQ = BQ / 8;   // n8 tiles of q rows (k8 steps of dV, dK)
  constexpr int ND = D / 8;    // n8 tiles of a dK / dV row
  constexpr int RG = BQ / 16;  // 16-row groups of the dQ product
  constexpr int DQC = 64;      // dQ columns a warp
  constexpr bool kPre = tf32_presplit<D, kDq>();
  static_assert(4 / RG * DQC == D, "4 warps cover BQ x D of dQ");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [kBK][LD]
  float* Vs = Ks + kBK * LD;                       // [kBK][LD]
  float* Qs = Vs + kBK * LD;                       // [BQ][LD] (or its hi)
  float* Os = Qs + BQ * LD;                        // dO [BQ][LD] (or hi)
  float* Ql = Os + BQ * LD;                        // lo planes, kPre only
  float* Ol = Ql + (kPre ? BQ * LD : 0);
  float* Ls = Ol + (kPre ? BQ * LD : 0);           // lse, base 2 [BQ]
  float* Dl = Ls + BQ;                             // delta [BQ]
  float* St = Dl + BQ;                             // dS^T [kBK][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int hh = bh - b * a.H;
  const int kv_off = a.Lk - a.Lq;

  const float* q = static_cast<const float*>(a.q) + b * a.sqb + hh * a.sqh;
  const float* k = static_cast<const float*>(a.k) + b * a.skb + hh * a.skh;
  const float* v = static_cast<const float*>(a.v) + b * a.svb + hh * a.svh;
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.sob + hh * a.soh;
  const float* lse = a.lse + static_cast<int64_t>(bh) * a.Lq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * a.Lq;
  const uint8_t* mk = kMask ? mask_slice(a, b, hh) : nullptr;

  // first q tile with a row that sees key k0: rows r with r + kv_off >= k0
  int qt = 0;
  if (a.causal) qt = max(0, k0 - kv_off) / BQ;
  const int n_qt = (a.Lq + BQ - 1) / BQ;

  load_rows_async<kBK, D, LD, kTcThreads>(Ks, k, a.skl, k0, a.Lk, tid);
  load_rows_async<kBK, D, LD, kTcThreads>(Vs, v, a.svl, k0, a.Lk, tid);
  cp_async_commit();  // waited for with the first q tile

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  // dK and dV leave the registers for the fp32 outputs after every q tile
  // whose index is a multiple of kFlushTiles less one, and at the end,
  // and are added there with round-to-nearest adds: the tensor cores' own
  // fp32 accumulation does not round to nearest, and one chain of mma adds
  // over a long walk drifts with its length (kFlushTiles). The first
  // flush writes (add false), later ones add; this block alone owns its
  // keys' rows, so it needs no atomics, and the order is fixed.
  const int64_t row_stride = static_cast<int64_t>(a.H) * D;
  const int64_t base = static_cast<int64_t>(b) * a.Lk * row_stride + hh * D +
                       key0 * row_stride + 2 * t;
  auto flush = [&](bool add) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key0 + 8 * i >= a.Lk) continue;
      float2* pk = reinterpret_cast<float2*>(static_cast<float*>(a.dk) +
                                             base + 8 * i * row_stride);
      float2* pv = reinterpret_cast<float2*>(static_cast<float*>(a.dv) +
                                             base + 8 * i * row_stride);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float2 k2 = make_float2(dk[n][2 * i] * a.scale,
                                dk[n][2 * i + 1] * a.scale);
        float2 v2 = make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
        if (add) {
          const float2 ok = pk[4 * n], ov = pv[4 * n];
          k2.x += ok.x;
          k2.y += ok.y;
          v2.x += ov.x;
          v2.y += ov.y;
        }
        pk[4 * n] = k2;
        pv[4 * n] = v2;
        dk[n][2 * i] = dk[n][2 * i + 1] = 0.f;
        dv[n][2 * i] = dv[n][2 * i + 1] = 0.f;
      }
    }
  };
  const float sl2 = a.scale * kLog2e;
  const int qt0 = qt;
  for (; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous q tile's Qs, Os, Ls, Dl, St are read
    load_rows_async<BQ, D, LD, kTcThreads>(Qs, q, a.sql, q0, a.Lq, tid);
    load_rows_async<BQ, D, LD, kTcThreads>(Os, dout, a.sol, q0, a.Lq, tid);
    // lse in base 2, +inf past Lq or with no visible key (P is 0 there)
    if (tid < BQ) {
      const int qi = q0 + tid;
      const float ls = qi < a.Lq ? lse[qi] : -INFINITY;
      Ls[tid] = ls == -INFINITY ? INFINITY : ls * kLog2e;
    } else if (tid < 2 * BQ) {
      const int qi = q0 + tid - BQ;
      Dl[tid - BQ] = qi < a.Lq ? delta[qi] : 0.f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (kPre) {  // Q and dO into hi (in place) and lo planes
      for (int i = tid; i < BQ * D / 4; i += kTcThreads) {
        const int off = (i / (D / 4)) * LD + (i % (D / 4)) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          unsigned hi, lo;
          split_tf32(Qs[off + e], hi, lo);
          Qs[off + e] = __uint_as_float(hi);
          Ql[off + e] = __uint_as_float(lo);
          split_tf32(Os[off + e], hi, lo);
          Os[off + e] = __uint_as_float(hi);
          Ol[off + e] = __uint_as_float(lo);
        }
      }
      __syncthreads();
    }

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ rows a warp
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned x[4], kh[4], kl[4], vh[4], vl[4];
      load_a_f32<LD>(x, Ks, warp * 16, kk * 8, lane);
      split4(x, kh, kl);
      load_a_f32<LD>(x, Vs, warp * 16, kk * 8, lane);
      split4(x, vh, vl);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        unsigned qh[4], ql[4], oh[4], ol[4];
        if constexpr (kPre) {
          load_b_f32<LD>(qh, Qs, np * 16, kk * 8, lane);
          load_b_f32<LD>(ql, Ql, np * 16, kk * 8, lane);
          load_b_f32<LD>(oh, Os, np * 16, kk * 8, lane);
          load_b_f32<LD>(ol, Ol, np * 16, kk * 8, lane);
        } else {
          load_b_f32<LD>(x, Qs, np * 16, kk * 8, lane);
          split4(x, qh, ql);
          load_b_f32<LD>(x, Os, np * 16, kk * 8, lane);
          split4(x, oh, ol);
        }
        mma_3xtf32(s[2 * np], kh, kl, qh[0], qh[1], ql[0], ql[1]);
        mma_3xtf32(s[2 * np + 1], kh, kl, qh[2], qh[3], ql[2], ql[3]);
        mma_3xtf32(dp[2 * np], vh, vl, oh[0], oh[1], ol[0], ol[1]);
        mma_3xtf32(dp[2 * np + 1], vh, vl, oh[2], oh[3], ol[2], ol[3]);
      }
    }

    // P^T and dS^T in place: element e of tile n is (key key0 + 8 (e >> 1),
    // row n * 8 + 2t + (e & 1)); tiles that cross the diagonal or the key
    // tail are masked element by element, and with a mask every tile
    const bool edge = (a.causal && k0 + kBK - 1 > q0 + kv_off) ||
                      k0 + kBK > a.Lk;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = n * 8 + 2 * t + j;  // row of the q tile
        const float lq = Ls[c];
        const float dl = Dl[c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + j;
          const int key = key0 + 8 * i;
          float p = exp2f(s[n][e] * sl2 - lq);
          if (edge &&
              (key >= a.Lk || (a.causal && key > q0 + c + kv_off)))
            p = 0.f;
          if constexpr (kMask) {
            const int row = q0 + c;
            if (row >= a.Lq || key >= a.Lk || !mk[row * a.smq + key * a.smk])
              p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl);
          if constexpr (kDq) {
            const int ky = warp * 16 + g + 8 * i;  // key of the tile
            St[ky * BQ + (c ^ st_swz(ky))] = dp[n][e];
          }
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's rows, 8 at a time
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      unsigned ph[4], pl[4], sh[4], sl[4];
      split4(s[kk][0], s[kk][2], s[kk][1], s[kk][3], ph, pl);
      split4(dp[kk][0], dp[kk][2], dp[kk][1], dp[kk][3], sh, sl);
      const int rowg = (kk * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        unsigned oh0, ol0, oh1, ol1, qh0, ql0, qh1, ql1;
        const int o0 = rowg + dn * 8, o1 = o0 + LD;
        if constexpr (kPre) {
          oh0 = __float_as_uint(Os[o0]);
          ol0 = __float_as_uint(Ol[o0]);
          oh1 = __float_as_uint(Os[o1]);
          ol1 = __float_as_uint(Ol[o1]);
          qh0 = __float_as_uint(Qs[o0]);
          ql0 = __float_as_uint(Ql[o0]);
          qh1 = __float_as_uint(Qs[o1]);
          ql1 = __float_as_uint(Ql[o1]);
        } else {
          split_tf32(Os[o0], oh0, ol0);
          split_tf32(Os[o1], oh1, ol1);
          split_tf32(Qs[o0], qh0, ql0);
          split_tf32(Qs[o1], qh1, ql1);
        }
        mma_3xtf32(dv[dn], ph, pl, oh0, oh1, ol0, ol1);
        mma_3xtf32(dk[dn], sh, sl, qh0, qh1, ql0, ql1);
      }
    }

    if constexpr (kDq) {
      __syncthreads();  // the whole dS^T tile is staged
      const int r0 = (warp % RG) * 16;   // this warp's q rows of the tile
      const int c0 = (warp / RG) * DQC;  // and its dq columns
      float acc[DQC / 8][4];
#pragma unroll
      for (int n = 0; n < DQC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        // dS at rows r0 + g (+8), keys 2t (k = t) and 2t + 1 (k = t + 4)
        const int ke = kk * 8 + 2 * t, ko = ke + 1;
        const int ra = r0 + g, rb = r0 + g + 8;
        unsigned dh[4], dl[4];
        split4(St[ke * BQ + (ra ^ st_swz(ke))],
               St[ke * BQ + (rb ^ st_swz(ke))],
               St[ko * BQ + (ra ^ st_swz(ko))],
               St[ko * BQ + (rb ^ st_swz(ko))], dh, dl);
        const float* krow = Ks + ke * LD + c0 + g;
#pragma unroll
        for (int n = 0; n < DQC / 8; ++n) {
          unsigned bh0, bl0, bh1, bl1;
          split_tf32(krow[n * 8], bh0, bl0);
          split_tf32(krow[LD + n * 8], bh1, bl1);
          mma_3xtf32(acc[n], dh, dl, bh0, bh1, bl0, bl1);
        }
      }
      const int qi = q0 + r0 + g;
      float* dqp = static_cast<float*>(a.dq) +
                   (static_cast<int64_t>(b) * a.Lq + qi) * a.H * D +
                   hh * D + c0;
      const int64_t row8 = static_cast<int64_t>(8) * a.H * D;
#pragma unroll
      for (int n = 0; n < DQC / 8; ++n)
        add_dq_tile(dqp + n * 8, row8, acc[n], a.scale, t, qi < a.Lq,
                    qi + 8 < a.Lq);
    }
    // a flush before this one happened at a tile >= qt0
    if (qt % kFlushTiles == kFlushTiles - 1) flush(qt - qt0 >= kFlushTiles);
  }
  cp_async_wait<0>();
  if (n_qt % kFlushTiles != 0) flush((n_qt & -kFlushTiles) > qt0);
}

}  // namespace fa_bwd
}  // namespace pt
