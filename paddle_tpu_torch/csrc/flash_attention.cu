// Flash-attention forward for Hopper: out and the per-row logsumexp.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fa_fwd_pallas`
// (tiled online softmax, kernel `_fa_fwd_kernel` l.198) and
// `_fa_small_fwd_pallas` (single-shot path for Lq == Lk <= 512, kernel
// l.438). On the card one kernel covers both: a short sequence is a tiled
// walk with few tiles, so the TPU's separate small path has no purpose.
//
// What bounds it on the H100: operations. The causal forward does
// 4 * D FLOPs per visible (q, k) pair (S = Q K^T and P V) against ~4 * L * D
// elements in and out per head: at L = 1024, D = 64 that is ~260 FLOPs a
// byte in bf16, at L = 32,768 thousands.
//
// Three designs; the launcher picks one by type, head dim and alignment
// (16-byte aligned rows, counted in bytes):
//
// - bf16, D 64 or 128, aligned rows: tensor cores (`mma.sync` m16n8k16,
//   fp32 accumulators), as the reference feeds its MXU bf16 with fp32
//   accumulation. One block of 4 warps per (b, h, 64-row query tile);
//   each warp owns 16 query rows. The Q tile is copied once into shared
//   memory as bf16 with 16-byte cp.async and read into A fragments
//   (ldmatrix), which stay in registers. K and V tiles of 64 keys stream
//   through a 2-stage cp.async ring; shared rows are padded to D + 8
//   elements (16 bytes mod 128), so ldmatrix has no bank conflicts.
//   S = Q K^T goes to fp32 registers; the online softmax runs there in
//   base 2 (scale * log2 e folded in), with row max and row sum reduced
//   over the 4 lanes of a quad; P is packed to bf16 in registers (two n8
//   accumulator tiles are one k16 A fragment, the reference's cast of p
//   before p @ v) and P V reads V through ldmatrix.trans.
// - fp32, D 64 or 128, aligned rows: the TF32 tensor cores in a 3xTF32
//   split (`mma.sync` m16n8k8; csrc/mma.cuh), which keeps fp32 accuracy:
//   each operand is split into a TF32 hi and lo part and each product is
//   hi hi + hi lo + lo hi in fp32. The same walk as bf16, with 16 query
//   rows a warp and 4 warps a block (2 for the shortest prefills, Lq <=
//   32 at D 64). K and V tiles of fp32 stream through a 2-stage cp.async
//   ring of 64 keys at D 64 (32 at D 128 and in the 2-warp block), so at
//   least two blocks share an SM. The k index
//   of each k8 product is renumbered (csrc/mma.cuh), so a lane reads Q
//   and K as 8-byte pairs from rows padded to D + 8 floats, takes its P
//   fragment straight from the S accumulators, and reads V (keys 2t and
//   2t+1, column g) from rows padded to D + 4 floats: no bank is hit
//   twice. Q's hi and lo fragments stay in registers at D 64 and are
//   split per k step from shared memory at D 128. P is split in registers
//   as it leaves the softmax. A NaN in Q, K or V survives the split (in
//   its lo part) and a NaN row sum stays NaN, so a NaN input gives NaN
//   where the plain version does.
// - every other case (other head dims, unaligned rows): CUDA cores. One
//   block of 128 threads per (b, h, 64-row query tile); two threads share
//   a query row: each scores half of a 32-key tile and owns half of the
//   output row (interleaved dims, so the two never hit one shared memory
//   bank). K and V tiles stream through shared memory as fp32; online
//   softmax in fp32.
//
// The bool mask (the reference's `_apply_mask`, l.164, whose tiles
// `_mask_spec` l.758 and `_small_mask_spec` l.518 stream beside K and V):
// an optional [B, H, Lq, Lk] byte array read through four element strides,
// 0 on a broadcast dim, so a [B, 1, 1, Lk] key-padding mask is never
// expanded. Each thread reads the bytes of the scores it holds (in the mma
// designs by the accumulator fragment's row and column) and a masked score
// becomes -inf before the running max. Every design compiles the mask in
// or out (`kMask`, chosen per call by `pt::with_mask`), so the kernels
// without it are unchanged; with it every tile is masked element by
// element, causal interior tiles too. A row with no visible key keeps
// l = 0 and gives out exactly 0 and lse -inf, the plain version's
// convention, which the backwards read as P = 0.
//
// All: tiles wholly above the causal diagonal are never loaded
// (kv_offset = Lk - Lq, as at l.820), and only the tiles that cross it or
// the key tail are masked element by element; on the tensor cores causal
// q tiles with the longest walks (the last rows) launch first. Query rows
// past Lq and key rows past Lk are zero-filled and masked, so any L >= 1
// works. Inputs are read through their [B, L, H, D] strides (last dim
// contiguous), so no transpose is needed.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

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
  const uint8_t* mask;  // bool [B, H, Lq, Lk] through its strides, or null
  int64_t smb, smh, smq, smk;  // 0 on a broadcast dim
};

// this block's (b, h) slice of the mask: element (row, col) is at
// row * smq + col * smk
__device__ __forceinline__ const uint8_t* mask_slice(const FaArgs& a, int b,
                                                     int hh) {
  return a.mask + b * a.smb + hh * a.smh;
}

// whether the mask (mk, this (b, h)'s slice) hides key `col` (< Lk) from
// query row `row`; a row past Lq reads no mask byte and is hidden (its
// output is never written)
__device__ __forceinline__ bool mask_hides(const FaArgs& a, const uint8_t* mk,
                                           int row, int col) {
  return row >= a.Lq || !mk[row * a.smq + col * a.smk];
}

// ------------------------------ CUDA cores -----------------------------------

__host__ __device__ inline size_t smem_floats(int D) {
  return static_cast<size_t>(kBQ) * (D + 1) + kBK * (D + 1) + kBK * D +
         kBQ * (kBK + 1);
}

template <typename T, int DMAX, bool kMask>
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
  const uint8_t* mk = kMask ? mask_slice(a, b, hh) : nullptr;

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
      bool ok = col < a.Lk && (!a.causal || qrow + kv_off >= col);
      if constexpr (kMask) ok = ok && !mask_hides(a, mk, qrow, col);
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

template <typename T, int DMAX, bool kMask>
cudaError_t launch(const FaArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.D) * sizeof(float);
  cudaError_t err = pt::allow_smem(flash_fwd_kernel<T, DMAX, kMask>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_kernel<T, DMAX, kMask><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ----------------------------- bf16, tensor cores ----------------------------

constexpr int kTcBQ = 64;       // query rows per block, 16 a warp
constexpr int kTcBK = 64;       // keys per tile
constexpr int kTcThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr size_t tc_smem_bytes() {
  // Q, then two stages of K and of V, rows padded to D + 8 elements
  return static_cast<size_t>(kTcBQ + 4 * kTcBK) * (D + 8) *
         sizeof(__nv_bfloat16);
}

template <int D, bool kMask>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(FaArgs a) {
  constexpr int LD = D + 8;  // padded shared row, in elements
  constexpr int KD = D / 16; // k16 steps over the head dim
  constexpr int ND = D / 8;  // n8 tiles of the output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kTcBQ * LD;    // [2][kTcBK][LD]
  __nv_bfloat16* Vs = Ks + 2 * kTcBK * LD; // [2][kTcBK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (a.Lq + kTcBQ - 1) / kTcBQ;
  // causal: the q tiles with the longest walks (the last rows) first
  const int qt = a.causal ? n_qt - 1 - static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x);
  const int q0 = qt * kTcBQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_off = a.Lk - a.Lq;

  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sqb + hh * a.sqh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.skb + hh * a.skh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.svb + hh * a.svh;
  const uint8_t* mk = kMask ? mask_slice(a, b, hh) : nullptr;

  int n_tiles = (a.Lk + kTcBK - 1) / kTcBK;
  if (a.causal)  // the last key any row of this tile may see
    n_tiles = min(n_tiles, (q0 + kTcBQ - 1 + kv_off) / kTcBK + 1);

  auto load_kv = [&](int stage, int tile) {
    const int k0 = tile * kTcBK;
    pt::load_rows_async<kTcBK, D, LD, kTcThreads>(
        Ks + stage * kTcBK * LD, k, a.skl, k0, a.Lk, tid);
    pt::load_rows_async<kTcBK, D, LD, kTcThreads>(
        Vs + stage * kTcBK * LD, v, a.svl, k0, a.Lk, tid);
  };
  pt::load_rows_async<kTcBQ, D, LD, kTcThreads>(Qs, q, a.sql, q0, a.Lq, tid);
  pt::cp_async_commit();
  load_kv(0, 0);
  pt::cp_async_commit();
  pt::cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();
  unsigned qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    pt::load_a<LD>(qf[kk], Qs, warp * 16, kk * 16, lane);

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float sl2 = a.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};  // row max, in base-2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) load_kv(st ^ 1, it + 1);
    pt::cp_async_commit();
    pt::cp_async_wait<1>();  // tile it has landed
    __syncthreads();
    const bf16* Kt = Ks + st * kTcBK * LD;
    const bf16* Vt = Vs + st * kTcBK * LD;

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kb[4];
        pt::load_b<LD>(kb, Kt, np * 16, kk * 16, lane);
        pt::mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        pt::mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale to base 2; mask the tiles that cross the diagonal or the
    // tail, and with a mask every tile
    const int k0 = it * kTcBK;
    const bool edge = kMask || k0 + kTcBK > a.Lk ||
                      (a.causal && k0 + kTcBK - 1 > q0 + kv_off);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (edge) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= a.Lk || (a.causal && col > row + kv_off)) {
            x = -INFINITY;
          } else if constexpr (kMask) {
            if (mask_hides(a, mk, row, col)) x = -INFINITY;
          }
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with no visible key so far keeps p = 0 and o = 0
      mu[i] = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - mu[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }

    // O += P V, P packed to bf16 as A fragments, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      unsigned pa[4] = {pt::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pt::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        unsigned vb[4];
        pt::load_b_trans<LD>(vb, Vt, dn * 16, kk * 16, lane);
        pt::mma_bf16(o[2 * dn], pa, vb[0], vb[1]);
        pt::mma_bf16(o[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // stage st is free for the load of tile it + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= a.Lq) continue;
    // not fmaxf, which would turn a NaN sum (a NaN input) into 1e-30
    const float lsum = l[i] < 1e-30f ? 1e-30f : l[i];
    const float inv = 1.f / lsum;
    bf16* orow = static_cast<bf16*>(a.out) +
                 ((static_cast<int64_t>(b) * a.Lq + row) * a.H + hh) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (t == 0)
      a.lse[(static_cast<int64_t>(b) * a.H + hh) * a.Lq + row] =
          m[i] * kLn2 + logf(lsum);
  }
}

template <int D, bool kMask>
cudaError_t launch_tc(const FaArgs& a, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t err = pt::allow_smem(flash_fwd_tc_kernel<D, kMask>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kTcBQ - 1) / kTcBQ, a.H, a.B);
  flash_fwd_tc_kernel<D, kMask><<<grid, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// --------------------------- fp32, 3xTF32 tensor cores -----------------------

// keys a tile: 64 at D 64 with 64-row query tiles, else 32
template <int D, int WARPS>
__host__ __device__ constexpr int tf32_bk() {
  return D == 64 && WARPS == 4 ? 64 : 32;
}

template <int D, int WARPS>
constexpr size_t tf32_smem_bytes() {
  // Q and two stages of K in rows of D + 8 floats, two of V in D + 4
  constexpr int BQ = 16 * WARPS, BK = tf32_bk<D, WARPS>();
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (D + 8) +
                          2 * BK * (D + 4));
}

template <int D, int WARPS, bool kMask>
__global__ void __launch_bounds__(WARPS * 32)
    flash_fwd_tf32_kernel(FaArgs a) {
  constexpr int BQ = 16 * WARPS, BK = tf32_bk<D, WARPS>();
  constexpr int THREADS = WARPS * 32;
  constexpr int LDK = D + 8;  // Q, K rows: pairs (g, 2t) on distinct banks
  constexpr int LDV = D + 4;  // V rows: keys 2t, 2t+1 at column g likewise
  constexpr int KD = D / 8;   // k8 steps over the head dim
  constexpr int NK = BK / 8;  // n8 tiles of keys (k8 steps of P V)
  constexpr int ND = D / 8;   // n8 tiles of the output row
  constexpr bool kQReg = D == 64;  // Q's split fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * LDK;      // [2][BK][LDK]
  float* Vs = Ks + 2 * BK * LDK;  // [2][BK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (a.Lq + BQ - 1) / BQ;
  // causal: the q tiles with the longest walks (the last rows) first
  const int qt = a.causal ? n_qt - 1 - static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x);
  const int q0 = qt * BQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_off = a.Lk - a.Lq;

  const float* q = static_cast<const float*>(a.q) + b * a.sqb + hh * a.sqh;
  const float* k = static_cast<const float*>(a.k) + b * a.skb + hh * a.skh;
  const float* v = static_cast<const float*>(a.v) + b * a.svb + hh * a.svh;
  const uint8_t* mk = kMask ? mask_slice(a, b, hh) : nullptr;

  int n_tiles = (a.Lk + BK - 1) / BK;
  if (a.causal)  // the last key any row of this tile may see
    n_tiles = min(n_tiles, (q0 + BQ - 1 + kv_off) / BK + 1);

  auto load_kv = [&](int stage, int tile) {
    const int k0 = tile * BK;
    pt::load_rows_async<BK, D, LDK, THREADS>(Ks + stage * BK * LDK, k, a.skl,
                                             k0, a.Lk, tid);
    pt::load_rows_async<BK, D, LDV, THREADS>(Vs + stage * BK * LDV, v, a.svl,
                                             k0, a.Lk, tid);
  };
  pt::load_rows_async<BQ, D, LDK, THREADS>(Qs, q, a.sql, q0, a.Lq, tid);
  pt::cp_async_commit();
  load_kv(0, 0);
  pt::cp_async_commit();
  pt::cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();

  // this warp's rows g and g + 8 of Q, at the pair (2t, 2t + 1) of a k8 step
  const float* qw = Qs + (warp * 16 + g) * LDK + 2 * t;
  auto q_pairs = [&](int kk, unsigned (&hi)[4], unsigned (&lo)[4]) {
    pt::split_a_pairs(hi, lo, *reinterpret_cast<const float2*>(qw + kk * 8),
                      *reinterpret_cast<const float2*>(qw + 8 * LDK + kk * 8));
  };
  unsigned qhi[kQReg ? KD : 1][4], qlo[kQReg ? KD : 1][4];
  if constexpr (kQReg) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) q_pairs(kk, qhi[kk], qlo[kk]);
  }

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float sl2 = a.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};  // row max, in base-2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) load_kv(st ^ 1, it + 1);
    pt::cp_async_commit();
    pt::cp_async_wait<1>();  // tile it has landed
    __syncthreads();
    const float* Kt = Ks + st * BK * LDK;
    const float* Vt = Vs + st * BK * LDV;

    // S = Q K^T: 16 rows x BK keys a warp; K [key][d] gives each lane the
    // pair (key g, d 2t and 2t + 1): b0 and b1 in the renumbered k order
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned ahi[4], alo[4];
      if constexpr (kQReg) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ahi[r] = qhi[kk][r];
          alo[r] = qlo[kk][r];
        }
      } else {
        q_pairs(kk, ahi, alo);
      }
      unsigned bhi[NK][2], blo[NK][2];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float2 kp = *reinterpret_cast<const float2*>(
            Kt + (n * 8 + g) * LDK + kk * 8 + 2 * t);
        pt::split_tf32(kp.x, bhi[n][0], blo[n][0]);
        pt::split_tf32(kp.y, bhi[n][1], blo[n][1]);
      }
      // hi lo and lo hi, then hi hi, each over every key tile in turn, so
      // no product waits on the one before it
#pragma unroll
      for (int n = 0; n < NK; ++n) pt::mma_tf32(s[n], alo, bhi[n][0], bhi[n][1]);
#pragma unroll
      for (int n = 0; n < NK; ++n) pt::mma_tf32(s[n], ahi, blo[n][0], blo[n][1]);
#pragma unroll
      for (int n = 0; n < NK; ++n) pt::mma_tf32(s[n], ahi, bhi[n][0], bhi[n][1]);
    }

    // scale to base 2; mask the tiles that cross the diagonal or the
    // tail, and with a mask every tile
    const int k0 = it * BK;
    const bool edge = kMask || k0 + BK > a.Lk ||
                      (a.causal && k0 + BK - 1 > q0 + kv_off);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (edge) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= a.Lk || (a.causal && col > row + kv_off)) {
            x = -INFINITY;
          } else if constexpr (kMask) {
            if (mask_hides(a, mk, row, col)) x = -INFINITY;
          }
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with no visible key so far keeps p = 0 and o = 0
      mu[i] = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - mu[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }

    // O += P V: key tile j's accumulators (c0, c2, c1, c3) are its A
    // fragment (keys 2t, 2t + 1 as k = t, t + 4), split in registers; V
    // [key][d] gives b0, b1 = keys 2t, 2t + 1 at column g
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      unsigned phi[4], plo[4];
      pt::split_tf32(s[j][0], phi[0], plo[0]);
      pt::split_tf32(s[j][2], phi[1], plo[1]);
      pt::split_tf32(s[j][1], phi[2], plo[2]);
      pt::split_tf32(s[j][3], phi[3], plo[3]);
      const float* vr = Vt + (j * 8 + 2 * t) * LDV + g;
      // four output tiles at a time, the three products in turn as above
#pragma unroll
      for (int d0 = 0; d0 < ND; d0 += 4) {
        unsigned bhi[4][2], blo[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pt::split_tf32(vr[(d0 + i) * 8], bhi[i][0], blo[i][0]);
          pt::split_tf32(vr[LDV + (d0 + i) * 8], bhi[i][1], blo[i][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pt::mma_tf32(o[d0 + i], plo, bhi[i][0], bhi[i][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pt::mma_tf32(o[d0 + i], phi, blo[i][0], blo[i][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pt::mma_tf32(o[d0 + i], phi, bhi[i][0], bhi[i][1]);
      }
    }
    __syncthreads();  // stage st is free for the load of tile it + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= a.Lq) continue;
    // not fmaxf, which would turn a NaN sum (a NaN input) into 1e-30
    const float lsum = l[i] < 1e-30f ? 1e-30f : l[i];
    const float inv = 1.f / lsum;
    float* orow = static_cast<float*>(a.out) +
                  ((static_cast<int64_t>(b) * a.Lq + row) * a.H + hh) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
          make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (t == 0)
      a.lse[(static_cast<int64_t>(b) * a.H + hh) * a.Lq + row] =
          m[i] * kLn2 + logf(lsum);
  }
}

template <int D, int WARPS, bool kMask>
cudaError_t launch_tf32_rows(const FaArgs& a, cudaStream_t stream) {
  constexpr size_t smem = tf32_smem_bytes<D, WARPS>();
  cudaError_t err =
      pt::allow_smem(flash_fwd_tf32_kernel<D, WARPS, kMask>, smem);
  if (err != cudaSuccess) return err;
  constexpr int BQ = 16 * WARPS;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_tf32_kernel<D, WARPS, kMask>
      <<<grid, WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// the fp32 query tile: 64 rows, but 32 for Lq <= 32 at D 64. Timed on the
// H100 (tools/ab_fwd_q_tile.py, which builds this file with
// -DPT_TF32_Q32_MAX_LQ=0 and =1024): one query tile covers such a
// sequence either way, and the 32-row block's 32-key tiles load fewer
// padded keys; from L 64 on the 64-row block (64-key tiles at D 64) is
// faster
#ifndef PT_TF32_Q32_MAX_LQ
#define PT_TF32_Q32_MAX_LQ 32
#endif

template <int D, bool kMask>
cudaError_t launch_tf32(const FaArgs& a, cudaStream_t stream) {
  if constexpr (D == 64)
    if (a.Lq <= PT_TF32_Q32_MAX_LQ)
      return launch_tf32_rows<64, 2, kMask>(a, stream);
  return launch_tf32_rows<D, 4, kMask>(a, stream);
}

}  // namespace

// q [B, Lq, H, D], k/v [B, Lk, H, D] with element strides (last dim
// contiguous); out [B, Lq, H, D] contiguous in the input type; lse
// [B, H, Lq] fp32; mask null or a bool [B, H, Lq, Lk] read through element
// strides smb, smh, smq, smk (0 on a broadcast dim; true = attend). D <= 128
// and even. For causal, Lk >= Lq. *design is set to the design launched
// (pt::Design).
extern "C" int pt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const void* mask, int64_t sqb, int64_t sql, int64_t sqh, int64_t skb,
    int64_t skl, int64_t skh, int64_t svb, int64_t svl, int64_t svh,
    int64_t smb, int64_t smh, int64_t smq, int64_t smk, int B, int H, int Lq,
    int Lk, int D, int causal, float scale, int is_bf16, int* design,
    void* stream) {
  FaArgs a{q,   k,   v,   out, lse, sqb, sql, sqh, skb,    skl,   skh,
           svb, svl, svh, B,   H,   Lq,  Lk,  D,   causal, scale,
           static_cast<const uint8_t*>(mask), smb, smh, smq, smk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the design by type, head dim and alignment; the wrapper's
  // `fwd_design` predicts the same
  const int elem = is_bf16 ? 2 : 4;
  const bool tc = (D == 64 || D == 128) &&
                  pt::rows_aligned16(q, sqb, sql, sqh, elem) &&
                  pt::rows_aligned16(k, skb, skl, skh, elem) &&
                  pt::rows_aligned16(v, svb, svl, svh, elem);
  return static_cast<int>(pt::with_mask(mask, [&](auto m) {
    constexpr bool M = decltype(m)::value;
    if (tc && is_bf16) {
      *design = pt::kMmaBf16;
      return D == 64 ? launch_tc<64, M>(a, s) : launch_tc<128, M>(a, s);
    }
    if (tc) {
      *design = pt::kMma3xTf32;
      return D == 64 ? launch_tf32<64, M>(a, s) : launch_tf32<128, M>(a, s);
    }
    *design = pt::kCudaCore;
    if (is_bf16)
      return D <= 64 ? launch<__nv_bfloat16, 64, M>(a, s)
                     : launch<__nv_bfloat16, 128, M>(a, s);
    return D <= 64 ? launch<float, 64, M>(a, s) : launch<float, 128, M>(a, s);
  }));
}
