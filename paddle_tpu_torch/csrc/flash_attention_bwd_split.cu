// Flash-attention backward for Hopper, split into two walks: dq, and dk/dv.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fa_bwd_pallas`
// (l.1013), its two pallas_calls: `_fa_bwd_dq_kernel` (l.282, called at
// l.1047), grid (b, h, q-block, k-block) with dq in VMEM scratch, and
// `_fa_bwd_dkv_kernel` (l.353, called at l.1071), grid (b, h, k-block,
// q-block) with dk, dv in scratch. The reference takes the split pair when
// the one-pass kernel's whole-(b, h) dq scratch, Lq * D * 4 bytes, passes
// 6 MiB (l.955, 1109): past 24,576 tokens at D = 64. The wrapper keeps the
// gate, so this pair is the long-context backward.
//
// What bounds it on the H100: operations. Per causal (q, k) pair the two
// walks together do seven products of 2 * D FLOPs (dq: S, dP, dQ; dk/dv:
// S, dP, dV, dK), 7 * B * H * L^2 * D FLOPs in all when causal, against
// ~10 * L * D bytes in and out per head: at L = 32,768 the products are
// thousands of times the bytes' time.
//
// Card design. The TPU carries each accumulator along its sequential grid;
// here one block owns one output tile for its lifetime and walks the other
// operand inside the block, and writes its outputs once: no atomics, so
// runs repeat bit for bit.
// - `dq`: one block per (64-row q tile, b * h). It walks the 64-key tiles
//   up to the causal diagonal (kv_offset = Lk - Lq, as in the forward),
//   recomputing P = exp(S * scale - lse) and dS = P * (dP - delta), with
//   dP = dO V^T, and adds dS K. The q tiles with the longest walks (the
//   last rows, under causal masking) are scheduled first, so the grid does
//   not end on a few long blocks.
// - `dk/dv`: one block per (64-key tile, b * h), the k-tile walk of
//   flash_attention_bwd.cuh without the dQ product; key tile 0, the
//   longest walk, has the lowest block index.
// Two designs each; the launchers pick one by type, head dim and alignment:
// - bf16, D 64 or 128, 16-byte aligned rows: tensor cores. The dq kernel
//   (`flash_bwd_dq_tc_kernel`) has 4 warps of 16 q rows; its Q and dO tile
//   stay in shared memory as bf16, lse and delta in registers, and K and V
//   tiles stream through a 2-stage cp.async ring. S = Q K^T and dP = dO V^T
//   go through mma.sync m16n8k16 into fp32 registers; dS is packed to
//   bf16 as A fragments (the reference's cast before its dq product) and
//   dq += dS K reads K through ldmatrix.trans; dq stays in fp32 registers.
//   The dk/dv kernel is `kv_walk_tc`, which computes the transposed tiles.
// - fp32 and other head dims: CUDA cores. Each thread owns a 4 x 4
//   micro-tile of S and dP and 4 rows x D/16 dims of its accumulators;
//   shared rows are padded to D + 1 floats; the dk/dv kernel is `kv_walk`.
// Rows past Lq and keys past Lk are zero-filled and masked, so any L >= 1
// works; D <= 128 in multiples of 8; fp32 or bf16 [B, L, H, D] read through
// strides, causal or not. Offsets that can pass 2^31 are int64. Shared
// memory at D = 64 (128): tensor cores ~54 (~104) KB a block; CUDA cores
// ~84 (~149) KB (dq) and ~98 (~162) KB (dk/dv).
#include "flash_attention_bwd.cuh"

namespace {

using pt::fa_bwd::BwdArgs;
using pt::fa_bwd::kBK;
using pt::fa_bwd::kBQ;
using pt::fa_bwd::kPS;
using pt::fa_bwd::kRI;
using pt::fa_bwd::kThreads;
using pt::fa_bwd::kTX;
using pt::fa_bwd::kTY;

// ------------------------------ tensor cores --------------------------------

using pt::fa_bwd::kLog2e;
using pt::fa_bwd::kTcThreads;

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  // Q and dO, then two stages of K and of V, rows padded to D + 8 elements
  return static_cast<size_t>(2 * kBQ + 4 * kBK) * (D + 8) *
         sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_tc_kernel(BwdArgs a) {
  constexpr int LD = D + 8;   // padded shared row, in elements
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of a dq row
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LD]
  bf16* Os = Qs + kBQ * LD;                      // dO [kBQ][LD]
  bf16* Ks = Os + kBQ * LD;                      // [2][kBK][LD]
  bf16* Vs = Ks + 2 * kBK * LD;                  // [2][kBK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (a.Lq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int hh = bh - b * a.H;
  const int kv_off = a.Lk - a.Lq;

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sqb + hh * a.sqh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.skb + hh * a.skh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.svb + hh * a.svh;
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.sob + hh * a.soh;

  // k tiles with a key that some row of this tile sees: keys <= the last
  // real row + kv_off
  int n_kt = (a.Lk + kBK - 1) / kBK;
  if (a.causal)
    n_kt = min(n_kt, (min(q0 + kBQ, a.Lq) - 1 + kv_off) / kBK + 1);

  auto load_kv = [&](int stage, int tile) {
    const int k0 = tile * kBK;
    pt::load_rows_async<kBK, D, LD, kTcThreads>(Ks + stage * kBK * LD, k,
                                                a.skl, k0, a.Lk, tid);
    pt::load_rows_async<kBK, D, LD, kTcThreads>(Vs + stage * kBK * LD, v,
                                                a.svl, k0, a.Lk, tid);
  };
  pt::load_rows_async<kBQ, D, LD, kTcThreads>(Qs, q, a.sql, q0, a.Lq, tid);
  pt::load_rows_async<kBQ, D, LD, kTcThreads>(Os, dout, a.sol, q0, a.Lq,
                                              tid);
  load_kv(0, 0);
  pt::cp_async_commit();

  // this thread's rows row0 and row0 + 8: lse in base 2 (+inf past Lq or
  // with no visible key, so P is 0 there) and delta
  const int row0 = q0 + warp * 16 + g;
  float lq[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    const float ls =
        qi < a.Lq ? a.lse[static_cast<int64_t>(bh) * a.Lq + qi] : -INFINITY;
    lq[i] = ls == -INFINITY ? INFINITY : ls * kLog2e;
    dl[i] = qi < a.Lq ? a.delta[static_cast<int64_t>(bh) * a.Lq + qi] : 0.f;
  }
  const float sl2 = a.scale * kLog2e;

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) load_kv(st ^ 1, kt + 1);
    pt::cp_async_commit();
    pt::cp_async_wait<1>();  // k tile kt (and, first, Q and dO) has landed
    __syncthreads();
    const bf16* Kt = Ks + st * kBK * LD;
    const bf16* Vt = Vs + st * kBK * LD;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned qa[4], oa[4];
      pt::load_a<LD>(qa, Qs, warp * 16, kk * 16, lane);
      pt::load_a<LD>(oa, Os, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kb[4], vb[4];
        pt::load_b<LD>(kb, Kt, np * 16, kk * 16, lane);
        pt::load_b<LD>(vb, Vt, np * 16, kk * 16, lane);
        pt::mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        pt::mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        pt::mma_bf16(dp[2 * np], oa, vb[0], vb[1]);
        pt::mma_bf16(dp[2 * np + 1], oa, vb[2], vb[3]);
      }
    }

    // dS in place of dP; only tiles that cross the diagonal or the key
    // tail are masked element by element
    const int k0 = kt * kBK;
    const bool edge =
        k0 + kBK > a.Lk || (a.causal && k0 + kBK - 1 > q0 + kv_off);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(s[n][e] * sl2 - lq[i]);
        if (edge) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          if (col >= a.Lk || (a.causal && col > row0 + 8 * i + kv_off))
            p = 0.f;
        }
        dp[n][e] = p * (dp[n][e] - dl[i]);
      }
    }

    // dq += dS K: dS packed to bf16 as A fragments, K through
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned sa[4] = {pt::pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                        pt::pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                        pt::pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                        pt::pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        unsigned kb[4];
        pt::load_b_trans<LD>(kb, Kt, dn * 16, kk * 16, lane);
        pt::mma_bf16(dq[2 * dn], sa, kb[0], kb[1]);
        pt::mma_bf16(dq[2 * dn + 1], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // stage st is free for the load of k tile kt + 2
  }
  pt::cp_async_wait<0>();

  const int64_t row_stride = static_cast<int64_t>(a.H) * D;
  bf16* dqp = static_cast<bf16*>(a.dq) +
              static_cast<int64_t>(b) * a.Lq * row_stride + hh * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    if (qi >= a.Lq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqp + qi * row_stride + n * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(dq[n][2 * i] * a.scale,
                                dq[n][2 * i + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_tc_kernel(BwdArgs a) {
  pt::fa_bwd::kv_walk_tc<D, false>(a);
}

template <int D>
cudaError_t launch_dq_tc(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = dq_tc_smem_bytes<D>();
  cudaError_t err = pt::allow_smem(flash_bwd_dq_tc_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.B * a.H);
  flash_bwd_dq_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = pt::fa_bwd::kv_walk_tc_smem_bytes<D, false>();
  cudaError_t err = pt::allow_smem(flash_bwd_dkv_tc_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + kBK - 1) / kBK, a.B * a.H);
  flash_bwd_dkv_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------ CUDA cores ----------------------------------

inline size_t dq_smem_floats(int D) {
  return static_cast<size_t>(2 * kBQ + 2 * kBK) * (D + 1) + kBQ * kPS +
         2 * kBQ;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int kDJ = DMAX / kTX;  // dims per thread
  extern __shared__ float smem[];
  const int D = a.D;
  const int DP = D + 1;
  float* Qs = smem;              // [kBQ][DP]
  float* Os = Qs + kBQ * DP;     // dO [kBQ][DP]
  float* Ks = Os + kBQ * DP;     // [kBK][DP]
  float* Vs = Ks + kBK * DP;     // [kBK][DP]
  float* Ss = Vs + kBK * DP;     // dS [kBQ][kPS]
  float* Ls = Ss + kBQ * kPS;    // lse [kBQ]
  float* Dl = Ls + kBQ;          // delta [kBQ]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int n_qt = (a.Lq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
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
  const int64_t row_stride = static_cast<int64_t>(a.H) * D;  // dq

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

  float dq_acc[kRI][kDJ];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dq_acc[i][j] = 0.f;

  // k tiles with a key that some row of this tile sees: keys <= the last
  // real row + kv_off
  int n_kt = (a.Lk + kBK - 1) / kBK;
  if (a.causal)
    n_kt = min(n_kt, (min(q0 + kBQ, a.Lq) - 1 + kv_off) / kBK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Ks/Vs/Ss are no longer read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      const int kj = k0 + c;
      const bool in = kj < a.Lk;
      Ks[c * DP + d] = in ? pt::to_f32(k[kj * a.skl + d]) : 0.f;
      Vs[c * DP + d] = in ? pt::to_f32(v[kj * a.svl + d]) : 0.f;
    }
    __syncthreads();

    pt::fa_bwd::p_ds_tile(Qs, Os, Ks, Vs, Ls, Dl, nullptr, Ss, DP, D, q0, k0,
                          tx, ty, a);
    __syncthreads();

    // dQ += dS K: rows ty + 16 i, dims tx + 16 j
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
          for (int i = 0; i < kRI; ++i) dq_acc[i][j] += sv[i] * kk;
        }
      }
    }
  }

  T* dq = static_cast<T*>(a.dq) + static_cast<int64_t>(b) * a.Lq * row_stride +
          hh * D;
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int qi = q0 + ty + kTY * i;
    if (qi >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      const int d = tx + kTX * j;
      if (d < D)
        dq[qi * row_stride + d] = pt::from_f32<T>(dq_acc[i][j] * a.scale);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  pt::fa_bwd::kv_walk<T, DMAX, false>(a);
}

template <typename T, int DMAX>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dq_smem_floats(a.D) * sizeof(float);
  cudaError_t err = pt::allow_smem(flash_bwd_dq_kernel<T, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.B * a.H);
  flash_bwd_dq_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = pt::fa_bwd::kv_walk_smem_floats(a.D) * sizeof(float);
  cudaError_t err = pt::allow_smem(flash_bwd_dkv_kernel<T, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + kBK - 1) / kBK, a.B * a.H);
  flash_bwd_dkv_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q [B, Lq, H, D], k/v [B, Lk, H, D], dout [B, Lq, H, D] with element
// strides (last dim contiguous); lse and delta [B, H, Lq] fp32; dq
// [B, Lq, H, D] contiguous in the input type. D <= 128, a multiple of 8;
// B * H <= 65535. For causal, Lk >= Lq.
extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int64_t sqb, int64_t sql,
    int64_t sqh, int64_t skb, int64_t skl, int64_t skh, int64_t svb,
    int64_t svl, int64_t svh, int64_t sob, int64_t sol, int64_t soh, int B,
    int H, int Lq, int Lk, int D, int causal, float scale, int is_bf16,
    void* stream) {
  BwdArgs a{q,   k,   v,   dout, lse, delta, dq,  nullptr, nullptr,
            sqb, sql, sqh, skb,  skl, skh,   svb, svl,     svh,
            sob, sol, soh, B,    H,   Lq,    Lk,  D,       causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16 && pt::fa_bwd::tc_takes(a))
    err = D == 64 ? launch_dq_tc<64>(a, s) : launch_dq_tc<128>(a, s);
  else if (is_bf16)
    err = D <= 64 ? launch_dq<__nv_bfloat16, 64>(a, s)
                  : launch_dq<__nv_bfloat16, 128>(a, s);
  else
    err = D <= 64 ? launch_dq<float, 64>(a, s) : launch_dq<float, 128>(a, s);
  return static_cast<int>(err);
}

// The same inputs; dk/dv [B, Lk, H, D] contiguous in the input type.
extern "C" int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int64_t sqb,
    int64_t sql, int64_t sqh, int64_t skb, int64_t skl, int64_t skh,
    int64_t svb, int64_t svl, int64_t svh, int64_t sob, int64_t sol,
    int64_t soh, int B, int H, int Lq, int Lk, int D, int causal, float scale,
    int is_bf16, void* stream) {
  BwdArgs a{q,   k,   v,   dout, lse, delta, nullptr, dk,  dv,
            sqb, sql, sqh, skb,  skl, skh,   svb,     svl, svh,
            sob, sol, soh, B,    H,   Lq,    Lk,      D,   causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16 && pt::fa_bwd::tc_takes(a))
    err = D == 64 ? launch_dkv_tc<64>(a, s) : launch_dkv_tc<128>(a, s);
  else if (is_bf16)
    err = D <= 64 ? launch_dkv<__nv_bfloat16, 64>(a, s)
                  : launch_dkv<__nv_bfloat16, 128>(a, s);
  else
    err = D <= 64 ? launch_dkv<float, 64>(a, s) : launch_dkv<float, 128>(a, s);
  return static_cast<int>(err);
}
