// Flash-attention backward for Hopper: dq, dk and dv in one pass.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fa_bwd_fused_pallas`
// (one-pass backward, kernel `_fa_bwd_fused_kernel` l.856) and
// `_fa_small_bwd_pallas` (single-shot path for Lq == Lk <= 512, kernel
// l.474). As for the forward, one kernel covers both: a short sequence is
// a walk with few tiles. The wrapper takes it while Lq * D * 4 bytes fit
// the reference's 6 MiB gate (l.955, 1109); above it the split pair of
// flash_attention_bwd_split.cu runs.
//
// What bounds it on the H100: operations. Per (q tile, k tile) pair it does
// five products of 64 x 64 x D (S = Q K^T, dP = dO V^T, dV += P^T dO,
// dK += dS^T Q, dQ += dS K), about 5 * L^2/2 * D * 2 FLOPs per head when
// causal, against ~8 * L * D bytes in and out per head.
//
// TPU design: a sequential grid (b, h, k-block, q-block) that carries the
// whole (b, h) dq in VMEM scratch across the k-blocks. Blocks of a CUDA grid
// run in parallel and in no order, so nothing can be carried from one to the
// next. Card design: one block per (64-key tile, b * h). It keeps its K and
// V tile in shared memory and dK, dV in fp32 registers for its lifetime,
// and walks the 64-row q tiles at or below the causal diagonal (tiles wholly
// above it are never loaded; kv_offset = Lk - Lq as in the forward). Per q
// tile it computes P and dS ONCE, as the TPU kernel does, and feeds them to
// the products that read them. dq is summed across the k tiles with fp32
// atomics into a [B, Lq, H, D] buffer the wrapper zeroes and then casts, so
// its summation order varies from run to run (the tolerance says so); dk
// and dv are written once and repeat bit for bit. The walk, shared with the
// split dk/dv kernel, is in flash_attention_bwd.cuh, in three designs:
// - bf16 at D 64 or 128 with 16-byte aligned rows: `kv_walk_tc<D, true>`,
//   4 warps on the tensor cores (mma.sync m16n8k16). P^T and dS^T leave
//   their products as bf16 A fragments for dV and dK; dS^T is also staged
//   in shared memory, and each warp adds 16 q rows of dS K into dq with
//   two-float atomics. Shared memory ~64 (~112) KB a block at D 64 (128).
// - fp32 at D 64 or 128 with 16-byte aligned rows: `kv_walk_tf32<D,
//   true>`, 4 warps on the TF32 tensor cores (mma.sync m16n8k8), each
//   product hi hi + hi lo + lo hi of a 3xTF32 split, which keeps fp32
//   accuracy: the bf16 walk's design with fp32 tiles, whose fragment
//   layout sets how the operands are read and where dS^T is staged (see
//   the walk). Shared memory ~85 (~107) KB at D 64 (128, where the q tile
//   is 32 rows), so two blocks share an SM.
// - other head dims and unaligned rows: `kv_walk<T, D, true>`, 256
//   threads on CUDA cores, P and dS kept in shared memory as fp32 tiles;
//   ~98 KB at D = 64 and ~162 KB at D = 128.
// All raise the 48 KB default cap on shared memory at launch; the entry
// reports the design it launched.
#include "flash_attention_bwd.cuh"

namespace {

using pt::fa_bwd::BwdArgs;

template <typename T, int DMAX, bool kMask>
__global__ void __launch_bounds__(pt::fa_bwd::kThreads)
    flash_bwd_kernel(BwdArgs a) {
  pt::fa_bwd::kv_walk<T, DMAX, true, kMask>(a);
}

template <int D, bool kMask>
__global__ void __launch_bounds__(pt::fa_bwd::kTcThreads)
    flash_bwd_tc_kernel(BwdArgs a) {
  pt::fa_bwd::kv_walk_tc<D, true, kMask>(a);
}

template <int D, bool kMask>
__global__ void __launch_bounds__(pt::fa_bwd::kTcThreads)
    flash_bwd_tf32_kernel(BwdArgs a) {
  pt::fa_bwd::kv_walk_tf32<D, true, kMask>(a);
}

template <typename T, int DMAX, bool kMask>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  using namespace pt::fa_bwd;
  const size_t smem = kv_walk_smem_floats(a.D) * sizeof(float);
  cudaError_t err = pt::allow_smem(flash_bwd_kernel<T, DMAX, kMask>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + kBK - 1) / kBK, a.B * a.H);
  flash_bwd_kernel<T, DMAX, kMask><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool kMask>
cudaError_t launch_tc(const BwdArgs& a, cudaStream_t stream) {
  using namespace pt::fa_bwd;
  constexpr size_t smem = kv_walk_tc_smem_bytes<D, true>();
  cudaError_t err = pt::allow_smem(flash_bwd_tc_kernel<D, kMask>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + kBK - 1) / kBK, a.B * a.H);
  flash_bwd_tc_kernel<D, kMask><<<grid, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool kMask>
cudaError_t launch_tf32(const BwdArgs& a, cudaStream_t stream) {
  using namespace pt::fa_bwd;
  constexpr size_t smem = kv_walk_tf32_smem_bytes<D, true>();
  cudaError_t err = pt::allow_smem(flash_bwd_tf32_kernel<D, kMask>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + kBK - 1) / kBK, a.B * a.H);
  flash_bwd_tf32_kernel<D, kMask><<<grid, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q [B, Lq, H, D], k/v [B, Lk, H, D], dout [B, Lq, H, D] with element
// strides (last dim contiguous); lse and delta [B, H, Lq] fp32; dq
// [B, Lq, H, D] fp32, zeroed; dk/dv [B, Lk, H, D] contiguous in the input
// type; mask null or the forward's bool [B, H, Lq, Lk] through element
// strides smb, smh, smq, smk (0 on a broadcast dim). D <= 128, a multiple
// of 8; B * H <= 65535. For causal, Lk >= Lq. *design is set to the
// design launched (pt::Design).
extern "C" int pt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq, void* dk, void* dv,
    const void* mask, int64_t sqb, int64_t sql, int64_t sqh, int64_t skb,
    int64_t skl, int64_t skh, int64_t svb, int64_t svl, int64_t svh,
    int64_t sob, int64_t sol, int64_t soh, int64_t smb, int64_t smh,
    int64_t smq, int64_t smk, int B, int H, int Lq, int Lk, int D, int causal,
    float scale, int is_bf16, int* design, void* stream) {
  BwdArgs a{q,   k,   v,   dout, lse, delta, dq, dk,  dv,  sqb, sql,
            sqh, skb, skl, skh,  svb, svl,   svh, sob, sol, soh, B,
            H,   Lq,  Lk,  D,    causal, scale,
            static_cast<const uint8_t*>(mask), smb, smh, smq, smk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the design by type, head dim and alignment; the wrapper's
  // `bwd_design` predicts the same
  const bool tc = pt::fa_bwd::tc_takes(a, is_bf16 ? 2 : 4);
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
