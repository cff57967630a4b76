// 1x1 convolution with BatchNorm statistics for Hopper: y = x @ w^T over a
// channels-last [R = N*H*W, Cin] view, plus the per-channel sum and sum of
// squares of y as stored.
//
// Replaces: paddle_tpu/ops/pallas/fused_conv_bn.py `_conv1x1_stats_pallas`
// (l.103, kernel `_conv1x1_stats_kernel` l.73).
//
//   y[r, o]  = sum_i x[r, i] * w[o, i]      (fp32 accumulation, stored in
//                                            x's type)
//   sum[o]   = sum_r Y[r, o],  sumsq[o] = sum_r Y[r, o]^2
//   with Y the value as stored, rounded to x's type (reference l.92-94)
//
// w is the conv weight (Cout, Cin, 1, 1) read as [Cout, Cin]: each output
// channel's Cin inputs are contiguous, so x and w are both K-major, the
// "TN" product wgmma reads directly, and no transpose is made.
//
// What bounds it on the H100: at ResNet-50's shapes the product sits near
// the card's ridge (layer2, R = 100,352, 512 -> 128 in bf16: 13.2 GFLOP and
// 128 MB, 0.013 ms at 989 TFLOP/s against 0.038 ms at 3.35 TB/s), so bytes
// up to 512 -> 128; at 1024 -> 256 and up, operations.
//
// Design, bf16 (csrc/wgmma.cuh): a persistent grid, one block per SM, of
// three warpgroups. The producer warpgroup gives up registers (setmaxnreg)
// and one of its threads keeps a ring of 6-8 stages (192 KB) of TMA loads
// in flight: a 128 x 64 tile of x and a BN x 64 tile of w a stage, in
// 128-byte swizzled rows, zero-filled past R, Cin and Cout, completion on
// an mbarrier. Each of the two consumer warpgroups owns 64 rows x BN of the
// output tile and runs wgmma m64nBNk16 on the stages as they land (fp32
// accumulators in registers), keeping one stage's products in flight and
// releasing each stage on an empty barrier once its products are done.
// BN is 64 or 128 by Cout. Each block walks the row tiles of one Cout
// stripe (the grid is a whole number of blocks a stripe), neighbouring
// blocks the stripes of one row tile at once, so x comes from device
// memory once and its other stripes from L2 (w, at most 2048 x 2048, stays
// in L2), and the producer loads the next tile while the consumers run
// this one's epilogue. The epilogue, 64 columns at a time, rounds each
// accumulator to bf16 into a chunk of y staged in shared memory (two
// chunks a consumer group, so one is written while the other's TMA store
// reads it; swizzled like the loads, so the lanes' 4-byte writes hit no
// bank twice) and stores it with TMA, clipped at R and Cout; then each
// lane adds a column pair of the staged chunk, over its warp's 16 rows, to
// its running sums of the rounded values and their squares (whole 128-byte
// rows a warp, no bank twice, no shuffles). At the end the 8 consumer
// warps' sums are added in a fixed order into one row of fp32 partials
// per block [blocks a stripe, 2, Cout]; column_sums.cuh then adds the rows
// in a fixed order (no atomics, the same result every run). The tensor
// maps are encoded on the host at each call and passed as
// __grid_constant__ parameters.
//
// Design, fp32 ("wgmma-3xtf32"): the same persistent grid, warp roles,
// Cout stripes and row-tile walk, on the TF32 tensor cores in a 3xTF32
// split, so the product keeps fp32's accuracy (csrc/mma.cuh: x = hi + lo,
// hi rounded to the nearest TF32, lo = x - hi truncated, and x w = lo hi
// + hi lo + hi hi, the dropped lo lo below 2^-22 of |x w|). What bounds it
// is the split's three products: R = 100,352, 512 -> 128 is 13.2 GFLOP,
// 0.080 ms at 495 / 3 TFLOP/s, against 257 MB, 0.077 ms at 3.35 TB/s;
// the layer1 shapes (Cin or Cout 64) are bound by bytes.
//   - w is split once a call into two global planes, w_hi and w_lo
//     [Cout, Cin] (the wrapper's scratch; at most 2 x 16 MB at 2048 x
//     2048), by a small kernel before the product.
//   - A stage is a 128 x 32 fp32 tile of x (one 128-byte swizzled row a
//     row, as for bf16) and the BN x 32 tiles of w_hi and w_lo: 48 KB at
//     BN 128 (4 stages in the 192 KB ring), 32 KB at BN 64 (6 stages).
//   - x stays unsplit in shared memory: each consumer warp reads its
//     16 rows of a k8 slice with one ldmatrix (fp32 as pairs of b16, the
//     TF32 A fragment's own k order, csrc/mma.cuh), splits it in
//     registers, and issues wgmma m64nBNk8 .tf32 with A from registers
//     three times on one accumulator: (x_lo, w_hi), (x_hi, w_lo), (x_hi,
//     w_hi). A slice's fragments are double-buffered in registers, so the
//     next slice is loaded and split while this one's products run.
//   - The tensor cores' fp32 accumulation does not round to nearest (the
//     fp32 flash backward drifted over long chains), so the accumulators
//     are added into fp32 registers every kFlushTiles stages (256 of
//     Cin): one chain is at most 96 products long.
//   - The epilogue stages y 32 fp32 columns (one swizzled 128-byte row) at
//     a time, stores it by TMA and adds the staged values, each lane one
//     column over its warp's 16 rows, to its running sums; y as stored is
//     the fp32 sum, so the statistics are of exactly what is stored.
//   - Out-of-bounds rows and columns of x and w load as zero (TMA's fill),
//     so R, Cin and Cout off the tiles add exact zeros to the sums, and
//     the stores clip at R and Cout. A NaN in x or w reaches y and the
//     sums: the split keeps it in lo.
//
// Edges: Cin and Cout must be multiples of 8 (16-byte rows) and x, w
// 16-byte aligned, which the wrapper checks; any R >= 1.
#include "column_sums.cuh"
#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

// names this file's second pass in its column_sums_kernel symbol, so a
// profile can tell it from the other caller's
struct conv1x1_sums;

namespace {

// ---------------------------- bf16, wgmma + TMA ------------------------------

constexpr int kWgBM = 128;  // rows of y a tile: 64 a consumer warpgroup
constexpr int kWgBK = 64;   // Cin a stage: one 128-byte swizzled row
constexpr int kWgThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kRingBytes = 192 * 1024;

// BN, the output columns of a tile, by Cout: 64 up to Cout 64, else 128
// (256 columns, tried, spill past the 168 registers a thread of a
// 384-thread block may have, and ran slower at every ResNet-50 shape)
inline int wgmma_bn(int Cout) { return Cout <= 64 ? 64 : 128; }

// the persistent grid's blocks per Cout stripe: each walks the row tiles
// b, b + P, b + 2P, ... of its stripe and writes one row of partial sums,
// so this many rows of the wrapper's (at most one a row tile) are written
inline int wgmma_blocks_per_stripe(int R, int Cout, int sms) {
  const int tiles_m = (R + kWgBM - 1) / kWgBM;
  const int tiles_n = (Cout + wgmma_bn(Cout) - 1) / wgmma_bn(Cout);
  const int p = sms / tiles_n < tiles_m ? sms / tiles_n : tiles_m;
  return p > 1 ? p : 1;
}

template <int BN>
struct WgCfg {
  static constexpr int kABytes = kWgBM * kWgBK * 2;  // 16 KB
  static constexpr int kBBytes = BN * kWgBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;  // 8, 6
  // two 64 x 64 y chunks a consumer group (a store in flight while the
  // next chunk is written); at the end the column sums reuse it
  static constexpr int kYBytes = 2 * 2 * 64 * 128;
  static constexpr int kRedFloats = 8 * (BN / 64) * 4 * 32;
  // ring, y staging, barriers; 1 KB to align the ring
  static constexpr size_t kSmem =
      1024 + kStages * kStageBytes + kYBytes + 2 * kStages * 8;
  static_assert(kStages >= 4, "at least 4 stages in flight");
  static_assert(kRedFloats * 4 <= kYBytes, "the sums fit the staging");
  static_assert(kSmem <= 232448, "fits one SM's shared memory");
};

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    conv1x1_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap ty,
                         float* __restrict__ part, int Cin, int Cout,
                         int tiles_m, int tiles_n) {
  using Cfg = WgCfg<BN>;
  constexpr int S = Cfg::kStages;
  constexpr int NC = BN / 64;  // 64-column chunks of a tile
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* ystage = base + S * Cfg::kStageBytes;  // [2][2][64][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ystage + Cfg::kYBytes);
  uint64_t* empty = full + S;
  auto stage_a = [&](int s) { return base + s * Cfg::kStageBytes; };
  auto stage_b = [&](int s) {
    return base + s * Cfg::kStageBytes + Cfg::kABytes;
  };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int ktiles = (Cin + kWgBK - 1) / kWgBK;
  // this block's stripe and its row tiles (grid = P * tiles_n)
  const int stripe = blockIdx.x % tiles_n, n0 = stripe * BN;
  const int m_first = blockIdx.x / tiles_n, m_step = gridDim.x / tiles_n;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      pt::mbar_init(&full[s], 1);   // the producer's arrival + the bytes
      pt::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    pt::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------ producer ---------------------------------
    pt::setmaxnreg_dec<40>();
    if (tid == 256) {
      int stage = 0, phase = 0;
      for (int tm = m_first; tm < tiles_m; tm += m_step) {
        for (int kt = 0; kt < ktiles; ++kt) {
          pt::mbar_wait(&empty[stage], phase ^ 1);
          pt::mbar_expect_tx(&full[stage], Cfg::kStageBytes);
          pt::tma_load_2d(stage_a(stage), &tx, kt * kWgBK, tm * kWgBM,
                          &full[stage]);
          pt::tma_load_2d(stage_b(stage), &tw, kt * kWgBK, n0, &full[stage]);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ------------------------------ consumers --------------------------------
    pt::setmaxnreg_inc<232>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;  // warp in the group
    const int g = lane >> 2, t = lane & 3;
    unsigned char* ys = ystage + wg * 2 * 64 * 128;  // this group's 2 chunks
    int stage = 0, phase = 0, nstored = 0;
    float acc[BN / 2];
    // running column sums over the block's tiles: lane p owns the column
    // pair (2p, 2p + 1) of each 64-column chunk over its warp's 16 rows;
    // (sum lo, sum hi, sumsq lo, sumsq hi)
    float cs[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) cs[c][0] = cs[c][1] = cs[c][2] = cs[c][3] = 0.f;
    for (int tm = m_first; tm < tiles_m; tm += m_step) {
      // one stage's products stay in flight while the next stage's are
      // issued; a stage is released once its products are done
      int prev = -1;
      for (int kt = 0; kt < ktiles; ++kt) {
        pt::mbar_wait(&full[stage], phase);
        pt::wgmma_fence();
        const uint64_t da = pt::smem_desc_sw128(stage_a(stage) + wg * 64 * 128);
        const uint64_t db = pt::smem_desc_sw128(stage_b(stage));
#pragma unroll
        for (int k16 = 0; k16 < kWgBK / 16; ++k16)
          pt::wgmma_bf16<BN>(acc, da + 2 * k16, db + 2 * k16,
                             kt > 0 || k16 > 0);
        pt::wgmma_commit();
        pt::wgmma_wait<1>();
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) pt::mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      pt::wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) pt::mbar_arrive(&empty[prev]);

      // epilogue, 64 columns at a time: round to bf16, stage, store by
      // TMA, and add the stored values to the column sums
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        unsigned char* buf = ys + (nstored & 1) * 64 * 128;
        // the store that used this buffer two chunks ago has read it
        if ((tid & 127) == 0) pt::bulk_wait_read<1>();
        pt::named_barrier(2 + wg, 128);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = 4 * (c * 8 + i);  // n8 tile c * 8 + i
          // rows r and r + 8 (both r % 8 = g): 16-byte chunk i at i ^ g
          const int r = 16 * warp + g;
          const int off = ((i ^ g) << 4) + 4 * t;
          *reinterpret_cast<__nv_bfloat162*>(buf + r * 128 + off) =
              __floats2bfloat162_rn(acc[e], acc[e + 1]);
          *reinterpret_cast<__nv_bfloat162*>(buf + (r + 8) * 128 + off) =
              __floats2bfloat162_rn(acc[e + 2], acc[e + 3]);
        }
        pt::fence_proxy_async();
        pt::named_barrier(2 + wg, 128);
        if ((tid & 127) == 0) {
          pt::tma_store_2d(&ty, buf, n0 + 64 * c, tm * kWgBM + 64 * wg);
          pt::bulk_commit();
        }
        ++nstored;
        // a warp reads whole 128-byte rows: lane p's pair at chunk
        // (p / 4) ^ (r % 8), no bank twice
#pragma unroll 4
        for (int rr = 0; rr < 16; ++rr) {
          const int r = 16 * warp + rr;
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              buf + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + 4 * (lane & 3));
          const float f0 = __low2float(v), f1 = __high2float(v);
          cs[c][0] += f0;
          cs[c][1] += f1;
          cs[c][2] += f0 * f0;
          cs[c][3] += f1 * f1;
        }
      }
    }

    // one row of partials per block: the 8 warps' sums in a fixed order,
    // in the staging once every store of both groups has completed
    if ((tid & 127) == 0) pt::bulk_wait();
    pt::named_barrier(1, 256);
    float* red = reinterpret_cast<float*>(ystage);  // [8][NC][4][32]
    const int w8 = wg * 4 + warp;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[((w8 * NC + c) * 4 + j) * 32 + lane] = cs[c][j];
    pt::named_barrier(1, 256);
    float* out = part + static_cast<int64_t>(m_first) * 2 * Cout;
    for (int idx = tid; idx < 2 * BN; idx += 256) {
      const int which = idx / BN, col = idx % BN;  // which: sum, sumsq
      if (n0 + col >= Cout) continue;
      const int c = col / 64, pair = (col % 64) / 2;
      const int j = 2 * which + (col & 1);
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) v += red[((w * NC + c) * 4 + j) * 32 + pair];
      out[which * Cout + n0 + col] = v;
    }
  }
}

template <int BN>
cudaError_t launch_wgmma(const void* x, const void* w, void* y, float* part,
                         int R, int Cin, int Cout, int sms,
                         cudaStream_t stream) {
  CUtensorMap tx, tw, ty;
  CUresult res = pt::tensor_map_bf16(&tx, x, R, Cin, kWgBM, kWgBK);
  if (res == CUDA_SUCCESS)
    res = pt::tensor_map_bf16(&tw, w, Cout, Cin, BN, kWgBK);
  if (res == CUDA_SUCCESS) res = pt::tensor_map_bf16(&ty, y, R, Cout, 64, 64);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const int tiles_m = (R + kWgBM - 1) / kWgBM;
  const int tiles_n = (Cout + BN - 1) / BN;
  const int grid = wgmma_blocks_per_stripe(R, Cout, sms) * tiles_n;
  const cudaError_t err =
      pt::allow_smem(conv1x1_wgmma_kernel<BN>, WgCfg<BN>::kSmem);
  if (err != cudaSuccess) return err;
  conv1x1_wgmma_kernel<BN><<<grid, kWgThreads, WgCfg<BN>::kSmem, stream>>>(
      tx, tw, ty, part, Cin, Cout, tiles_m, tiles_n);
  return cudaGetLastError();
}

// ------------------------- fp32, 3xTF32 on wgmma + TMA ------------------------

constexpr int kTfBK = 32;  // Cin a stage: one 128-byte swizzled row of fp32
// the accumulators are added into fp32 registers every kFlushTiles stages
// (256 of Cin): 8 x 4 slices x 3 products, the longest chain of wgmma adds
constexpr int kFlushTiles = 8;

template <int BN>
struct TfCfg {
  static constexpr int kABytes = kWgBM * kTfBK * 4;  // 16 KB of x
  static constexpr int kBBytes = BN * kTfBK * 4;     // w_hi, and w_lo
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;  // 4, 6
  // two 64 x 32 fp32 y chunks a consumer group (a store in flight while
  // the next chunk is written); at the end the column sums reuse it
  static constexpr int kYBytes = 2 * 2 * 64 * 128;
  static constexpr int kRedFloats = 8 * (BN / 32) * 2 * 32;
  static constexpr size_t kSmem =
      1024 + kStages * kStageBytes + kYBytes + 2 * kStages * 8;
  static_assert(kStages >= 4, "at least 4 stages in flight");
  static_assert(kRedFloats * 4 <= kYBytes, "the sums fit the staging");
  static_assert(kSmem <= 232448, "fits one SM's shared memory");
};

// w [n4 * 4] into its two TF32 planes: wh = w rounded to the nearest TF32,
// wl = the rest, truncated (csrc/mma.cuh split_tf32)
__global__ void __launch_bounds__(256)
    split_w_tf32_kernel(const float4* __restrict__ w, float4* __restrict__ wh,
                        float4* __restrict__ wl, int64_t n4) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n4) return;
  const float4 v = w[i];
  unsigned h[4], l[4];
  pt::split4(v.x, v.y, v.z, v.w, h, l);
  wh[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                      __uint_as_float(h[2]), __uint_as_float(h[3]));
  wl[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                      __uint_as_float(l[2]), __uint_as_float(l[3]));
}

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    conv1x1_tf32_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap twh,
                        const __grid_constant__ CUtensorMap twl,
                        const __grid_constant__ CUtensorMap ty,
                        float* __restrict__ part, int Cin, int Cout,
                        int tiles_m, int tiles_n) {
  using Cfg = TfCfg<BN>;
  constexpr int S = Cfg::kStages;
  constexpr int NC = BN / 32;  // 32-column chunks of a tile
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* ystage = base + S * Cfg::kStageBytes;  // [2][2][64][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ystage + Cfg::kYBytes);
  uint64_t* empty = full + S;
  auto stage_a = [&](int s) { return base + s * Cfg::kStageBytes; };
  auto stage_bh = [&](int s) {
    return base + s * Cfg::kStageBytes + Cfg::kABytes;
  };
  auto stage_bl = [&](int s) { return stage_bh(s) + Cfg::kBBytes; };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int ktiles = (Cin + kTfBK - 1) / kTfBK;
  // this block's stripe and its row tiles (grid = P * tiles_n)
  const int stripe = blockIdx.x % tiles_n, n0 = stripe * BN;
  const int m_first = blockIdx.x / tiles_n, m_step = gridDim.x / tiles_n;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      pt::mbar_init(&full[s], 1);   // the producer's arrival + the bytes
      pt::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    pt::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------ producer ---------------------------------
    pt::setmaxnreg_dec<40>();
    if (tid == 256) {
      int stage = 0, phase = 0;
      for (int tm = m_first; tm < tiles_m; tm += m_step) {
        for (int kt = 0; kt < ktiles; ++kt) {
          pt::mbar_wait(&empty[stage], phase ^ 1);
          pt::mbar_expect_tx(&full[stage], Cfg::kStageBytes);
          pt::tma_load_2d(stage_a(stage), &tx, kt * kTfBK, tm * kWgBM,
                          &full[stage]);
          pt::tma_load_2d(stage_bh(stage), &twh, kt * kTfBK, n0,
                          &full[stage]);
          pt::tma_load_2d(stage_bl(stage), &twl, kt * kTfBK, n0,
                          &full[stage]);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ------------------------------ consumers --------------------------------
    pt::setmaxnreg_inc<232>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;  // warp in the group
    const int g = lane >> 2, t = lane & 3;
    unsigned char* ys = ystage + wg * 2 * 64 * 128;  // this group's 2 chunks
    // the row this lane addresses for ldmatrix in a stage's x tile (tiles
    // (rows 0-7, k 0-3), (8-15, k 0-3), (0-7, k 4-7), (8-15, k 4-7) of the
    // warp's 16 rows: a0..a3); its 16-byte chunk of slice s is 2 s +
    // (lane >> 4), at that chunk ^ (row % 8) = chunk ^ (lane & 7)
    const int arow = 64 * wg + 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
    int stage = 0, phase = 0, nstored = 0;
    float acc[BN / 2], facc[BN / 2];
    // running column sums over the block's tiles: lane p owns column p of
    // each 32-column chunk over its warp's 16 rows; (sum, sumsq)
    float cs[NC][2];
#pragma unroll
    for (int c = 0; c < NC; ++c) cs[c][0] = cs[c][1] = 0.f;
    // x's split fragments of a k8 slice, double-buffered: slice j + 1 is
    // loaded while slice j's products run, into the registers of slice
    // j - 1, whose products are done
    unsigned xh[2][4], xl[2][4];
    for (int tm = m_first; tm < tiles_m; tm += m_step) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) facc[i] = 0.f;
      int prev = -1;  // the stage whose products may still be running
      for (int kt = 0; kt < ktiles; ++kt) {
        pt::mbar_wait(&full[stage], phase);
        const unsigned char* xa = stage_a(stage) + arow * 128;
        const uint64_t dh = pt::smem_desc_sw128(stage_bh(stage));
        const uint64_t dl = pt::smem_desc_sw128(stage_bl(stage));
        const bool restart = kt % kFlushTiles == 0;
#pragma unroll
        for (int s = 0; s < kTfBK / 8; ++s) {
          unsigned r[4];
          pt::ldmatrix_x4(r, xa + (((2 * s + (lane >> 4)) ^ (lane & 7)) << 4));
          pt::split4(r, xh[s & 1], xl[s & 1]);
          pt::wgmma_fence();
          // the small products first; a chain restarts from 0
          pt::wgmma_tf32<BN>(acc, xl[s & 1], dh + 2 * s,
                             !(restart && s == 0));
          pt::wgmma_tf32<BN>(acc, xh[s & 1], dl + 2 * s, 1);
          pt::wgmma_tf32<BN>(acc, xh[s & 1], dh + 2 * s, 1);
          pt::wgmma_commit();
          pt::wgmma_wait<1>();
          // slice s - 1 is done: at s = 0 that is the previous stage's last
          if (s == 0 && prev >= 0) {
            __syncwarp();
            if (lane == 0) pt::mbar_arrive(&empty[prev]);
            prev = -1;
          }
        }
        if (kt % kFlushTiles == kFlushTiles - 1 || kt == ktiles - 1) {
          // the chain ends: its sum into the fp32 registers
          pt::wgmma_wait<0>();
          __syncwarp();
          if (lane == 0) pt::mbar_arrive(&empty[stage]);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) facc[i] += acc[i];
        } else {
          prev = stage;
        }
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }

      // epilogue, 32 columns at a time: stage, store by TMA, and add the
      // stored values to the column sums
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        unsigned char* buf = ys + (nstored & 1) * 64 * 128;
        // the store that used this buffer two chunks ago has read it
        if ((tid & 127) == 0) pt::bulk_wait_read<1>();
        pt::named_barrier(2 + wg, 128);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * (4 * c + i);  // n8 tile 4c + i
          // rows r and r + 8 (both r % 8 = g), cols 8i + 2t, 8i + 2t + 1:
          // 16-byte chunk 2i + t / 2 at that ^ g, 8 bytes in for odd t / 2
          const int r = 16 * warp + g;
          const int off = (((2 * i + (t >> 1)) ^ g) << 4) + 8 * (t & 1);
          *reinterpret_cast<float2*>(buf + r * 128 + off) =
              make_float2(facc[e], facc[e + 1]);
          *reinterpret_cast<float2*>(buf + (r + 8) * 128 + off) =
              make_float2(facc[e + 2], facc[e + 3]);
        }
        pt::fence_proxy_async();
        pt::named_barrier(2 + wg, 128);
        if ((tid & 127) == 0) {
          pt::tma_store_2d(&ty, buf, n0 + 32 * c, tm * kWgBM + 64 * wg);
          pt::bulk_commit();
        }
        ++nstored;
        // a warp reads whole 128-byte rows: lane p's column at chunk
        // (p / 4) ^ (r % 8), no bank twice
#pragma unroll 4
        for (int rr = 0; rr < 16; ++rr) {
          const int r = 16 * warp + rr;
          const float v = *reinterpret_cast<const float*>(
              buf + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + 4 * (lane & 3));
          cs[c][0] += v;
          cs[c][1] += v * v;
        }
      }
    }

    // one row of partials per block: the 8 warps' sums in a fixed order,
    // in the staging once every store of both groups has completed
    if ((tid & 127) == 0) pt::bulk_wait();
    pt::named_barrier(1, 256);
    float* red = reinterpret_cast<float*>(ystage);  // [8][NC][2][32]
    const int w8 = wg * 4 + warp;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        red[((w8 * NC + c) * 2 + j) * 32 + lane] = cs[c][j];
    pt::named_barrier(1, 256);
    float* out = part + static_cast<int64_t>(m_first) * 2 * Cout;
    for (int idx = tid; idx < 2 * BN; idx += 256) {
      const int which = idx / BN, col = idx % BN;  // which: sum, sumsq
      if (n0 + col >= Cout) continue;
      const int c = col / 32, p = col % 32;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) v += red[((w * NC + c) * 2 + which) * 32 + p];
      out[which * Cout + n0 + col] = v;
    }
  }
}

template <int BN>
cudaError_t launch_tf32(const void* x, const void* w, float* wsplit, void* y,
                        float* part, int R, int Cin, int Cout, int sms,
                        cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(Cout) * Cin;
  float* wh = wsplit;
  float* wl = wsplit + n;
  CUtensorMap tx, th, tl, ty;
  CUresult res = pt::tensor_map_f32(&tx, x, R, Cin, kWgBM, kTfBK);
  if (res == CUDA_SUCCESS)
    res = pt::tensor_map_f32(&th, wh, Cout, Cin, BN, kTfBK);
  if (res == CUDA_SUCCESS)
    res = pt::tensor_map_f32(&tl, wl, Cout, Cin, BN, kTfBK);
  if (res == CUDA_SUCCESS) res = pt::tensor_map_f32(&ty, y, R, Cout, 64, 32);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const int64_t n4 = n / 4;  // Cin % 8 == 0
  split_w_tf32_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0,
                        stream>>>(static_cast<const float4*>(w),
                                  reinterpret_cast<float4*>(wh),
                                  reinterpret_cast<float4*>(wl), n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles_m = (R + kWgBM - 1) / kWgBM;
  const int tiles_n = (Cout + BN - 1) / BN;
  const int grid = wgmma_blocks_per_stripe(R, Cout, sms) * tiles_n;
  err = pt::allow_smem(conv1x1_tf32_kernel<BN>, TfCfg<BN>::kSmem);
  if (err != cudaSuccess) return err;
  conv1x1_tf32_kernel<BN><<<grid, kWgThreads, TfCfg<BN>::kSmem, stream>>>(
      tx, th, tl, ty, part, Cin, Cout, tiles_m, tiles_n);
  return cudaGetLastError();
}

}  // namespace

// y [R, Cout] in x's type (bf16 != 0: bfloat16, else float32); part: fp32
// scratch [cap, 2, Cout] of partial sums, of which the kernel writes and
// adds one row a block of its persistent grid per Cout stripe (from the
// card's SM count, at most ceil(R / 128)); a cap below that is refused.
// wsplit: for float32, fp32 scratch [2, Cout, Cin] for w's TF32 planes
// (16-byte aligned; ignored for bf16). out: fp32 [2, Cout] = (sum, sumsq).
extern "C" int pt_conv1x1_stats(const void* x, const void* w, void* y,
                                float* part, float* wsplit, float* out,
                                int64_t R, int Cin, int Cout, int64_t cap,
                                int bf16, cudaStream_t stream) {
  if (R <= 0 || R > 0x7fffffff || Cin % 8 || Cout % 8 || Cin <= 0 ||
      Cout <= 0 || !pt::aligned16(x) || !pt::aligned16(w) ||
      (!bf16 && (wsplit == nullptr || !pt::aligned16(wsplit))))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int r = static_cast<int>(R);
  const int64_t tiles = wgmma_blocks_per_stripe(r, Cout, sms);
  if (tiles > cap) return static_cast<int>(cudaErrorInvalidValue);
  const bool narrow = wgmma_bn(Cout) == 64;
  cudaError_t err;
  if (bf16)
    err = narrow ? launch_wgmma<64>(x, w, y, part, r, Cin, Cout, sms, stream)
                 : launch_wgmma<128>(x, w, y, part, r, Cin, Cout, sms, stream);
  else
    err = narrow ? launch_tf32<64>(x, w, wsplit, y, part, r, Cin, Cout, sms,
                                   stream)
                 : launch_tf32<128>(x, w, wsplit, y, part, r, Cin, Cout, sms,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  pt::launch_column_sums<conv1x1_sums>(
      part, out, tiles, 2 * static_cast<int64_t>(Cout), stream);
  return static_cast<int>(cudaGetLastError());
}
