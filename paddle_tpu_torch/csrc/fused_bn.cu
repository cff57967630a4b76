// Fused training-mode BatchNorm(+residual add)+ReLU for Hopper: the forward
// apply pass, the backward column reduction and the backward dx pass over a
// channels-last [R = N*H*W, C] view.
//
// Replaces: paddle_tpu/ops/pallas/fused_bn.py `_bn_act_fwd_pallas` (l.93,
// kernel `_fwd_kernel` l.77), `_bn_bwd_reduce_pallas` (l.150, kernel
// `_bwd_reduce_kernel` l.117) and `_bn_bwd_dx_pallas` (l.189, kernel
// `_bwd_dx_kernel` l.174).
//
//   forward:  y  = act(x * k + c (+ z))           k, c fp32 [C]
//   reduce:   db = sum_r g,  dg = inv * sum_r g * (x - mean)
//             with g = (y > 0) * dy for ReLU (the mask from the saved output)
//   dx:       dx = A * g + B * x + C0,  dz = g    A, B, C0 fp32 [C]
//
// What bounds them on the H100: bytes. Each reads its [R, C] operands once
// and writes once, for a few FLOPs an element (at the ResNet-50 stem,
// R = 1,605,632 and C = 64, one bf16 operand is 206 MB).
//
// Design: a block is tx channel vectors by ty rows (tx * ty <= 256), a
// vector being 16 bytes (8 bf16 or 4 fp32) where C and every pointer allow
// it and one element otherwise; neighbouring threads read neighbouring
// vectors of a row, so loads are coalesced 16-byte accesses. The grid is
// row chunks by channel strips; each thread keeps ITS channels for the
// whole chunk, so the per-channel constants (k, c / mean, inv / A, B, C0)
// live in registers, loaded once. The TPU kernels' sequential grid carried
// the reduction in VMEM from one row block to the next; here blocks run in
// parallel, so each (chunk, strip) block reduces its rows in registers,
// then over its ty rows in shared memory in a fixed order, and writes one
// row of fp32 partials [chunk][2][C]; a second small kernel
// (column_sums.cuh) adds the chunks' rows in a fixed order. No atomics: the
// result is the same on every run. Row offsets are int64.
#include <algorithm>
#include <initializer_list>

#include "column_sums.cuh"
#include "common.cuh"

// names this file's second pass in its column_sums_kernel symbol, so a
// profile can tell it from the other caller's
struct bn_reduce_sums;

namespace {

constexpr int kThreads = 256;

struct Geometry {
  int vec;     // elements per vector: 16 bytes' worth, or 1
  int cv;      // vectors per row, C / vec
  int tx, ty;  // block: tx vectors of a row by ty rows
  int strips;  // blocks across a row
};

Geometry geometry(int C, int vec) {
  Geometry g;
  g.vec = vec;
  g.cv = C / vec;
  g.tx = std::min(g.cv, 32);
  g.ty = kThreads / g.tx;
  g.strips = (g.cv + g.tx - 1) / g.tx;
  return g;
}

// 16 bytes' worth of elements when C is a multiple of it and every pointer
// is 16-byte aligned; else 1 (scalar loads)
int pick_vec(int C, int elem_bytes, std::initializer_list<const void*> ptrs) {
  const int v = 16 / elem_bytes;
  if (C % v) return 1;
  for (const void* p : ptrs)
    if (p != nullptr && !pt::aligned16(p)) return 1;
  return v;
}

// about eight blocks an SM for the elementwise passes, and at least ty rows
// a chunk
int64_t elementwise_chunks(int64_t R, const Geometry& g) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = std::max<int64_t>(1, (int64_t)sms * 8 / g.strips);
  return std::min<int64_t>(want, (R + g.ty - 1) / g.ty);
}

template <typename T, int VEC, bool RELU, bool ADD>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ z,
                  const float* __restrict__ k, const float* __restrict__ c,
                  T* __restrict__ y, int64_t R, int C, int64_t chunk_rows) {
  const int vi = blockIdx.y * blockDim.x + threadIdx.x;
  if (vi * VEC >= C) return;
  const int ch = vi * VEC;
  float kk[VEC], cc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    kk[j] = k[ch + j];
    cc[j] = c[ch + j];
  }
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * chunk_rows;
  const int64_t r1 = r0 + chunk_rows < R ? r0 + chunk_rows : R;
  for (int64_t r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    const int64_t off = r * C + ch;
    float v[VEC];
    pt::load_vec<T, VEC>(x + off, v);
    float w[VEC];
    if constexpr (ADD) pt::load_vec<T, VEC>(z + off, w);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float t = v[j] * kk[j] + cc[j];
      if constexpr (ADD) t += w[j];
      if constexpr (RELU) t = t < 0.f ? 0.f : t;  // keeps a NaN
      v[j] = t;
    }
    pt::store_vec<T, VEC>(y + off, v);
  }
}

template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_reduce_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     const T* __restrict__ dy, const float* __restrict__ mean,
                     const float* __restrict__ inv, float* __restrict__ part,
                     int64_t R, int C, int64_t chunk_rows) {
  __shared__ float sdb[kThreads * VEC], sdg[kThreads * VEC];
  const int vi = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = vi * VEC < C;
  const int ch = vi * VEC;
  float db[VEC], dg[VEC], mu[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    db[j] = 0.f;
    dg[j] = 0.f;
    mu[j] = live ? mean[ch + j] : 0.f;
  }
  if (live) {
    const int64_t r0 = static_cast<int64_t>(blockIdx.x) * chunk_rows;
    const int64_t r1 = r0 + chunk_rows < R ? r0 + chunk_rows : R;
    for (int64_t r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const int64_t off = r * C + ch;
      float xv[VEC], g[VEC];
      pt::load_vec<T, VEC>(x + off, xv);
      pt::load_vec<T, VEC>(dy + off, g);
      if constexpr (RELU) {
        float yv[VEC];
        pt::load_vec<T, VEC>(y + off, yv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) g[j] = yv[j] > 0.f ? g[j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        db[j] += g[j];
        dg[j] += g[j] * (xv[j] - mu[j]);
      }
    }
  }
  const int slot = (threadIdx.y * blockDim.x + threadIdx.x) * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sdb[slot + j] = db[j];
    sdg[slot + j] = dg[j];
  }
  __syncthreads();
  if (threadIdx.y != 0 || !live) return;
  float* out = part + static_cast<int64_t>(blockIdx.x) * 2 * C;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float s = 0.f, s2 = 0.f;
    for (int t = 0; t < blockDim.y; ++t) {
      const int o = (t * blockDim.x + threadIdx.x) * VEC + j;
      s += sdb[o];
      s2 += sdg[o];
    }
    out[ch + j] = s;
    out[C + ch + j] = s2 * inv[ch + j];
  }
}

template <typename T, int VEC, bool RELU, bool ADD>
__global__ void __launch_bounds__(kThreads)
    bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const T* __restrict__ dy, const float* __restrict__ a,
                 const float* __restrict__ b, const float* __restrict__ c0,
                 T* __restrict__ dx, T* __restrict__ dz, int64_t R, int C,
                 int64_t chunk_rows) {
  const int vi = blockIdx.y * blockDim.x + threadIdx.x;
  if (vi * VEC >= C) return;
  const int ch = vi * VEC;
  float aa[VEC], bb[VEC], cc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    aa[j] = a[ch + j];
    bb[j] = b[ch + j];
    cc[j] = c0[ch + j];
  }
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * chunk_rows;
  const int64_t r1 = r0 + chunk_rows < R ? r0 + chunk_rows : R;
  for (int64_t r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    const int64_t off = r * C + ch;
    float xv[VEC], g[VEC];
    pt::load_vec<T, VEC>(x + off, xv);
    pt::load_vec<T, VEC>(dy + off, g);
    if constexpr (RELU) {
      float yv[VEC];
      pt::load_vec<T, VEC>(y + off, yv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) g[j] = yv[j] > 0.f ? g[j] : 0.f;
    }
    if constexpr (ADD) pt::store_vec<T, VEC>(dz + off, g);
#pragma unroll
    for (int j = 0; j < VEC; ++j) xv[j] = aa[j] * g[j] + bb[j] * xv[j] + cc[j];
    pt::store_vec<T, VEC>(dx + off, xv);
  }
}

// ------------------------------ launchers -----------------------------------

template <typename T, int VEC>
void launch_fwd(const Geometry& g, const void* x, const void* z,
                const float* k, const float* c, void* y, int64_t R, int C,
                bool relu, bool add, cudaStream_t s) {
  const int64_t chunks = elementwise_chunks(R, g);
  const int64_t rows = (R + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(chunks), g.strips), block(g.tx, g.ty);
  auto X = static_cast<const T*>(x), Z = static_cast<const T*>(z);
  auto Y = static_cast<T*>(y);
  if (relu && add)
    bn_fwd_kernel<T, VEC, true, true><<<grid, block, 0, s>>>(X, Z, k, c, Y, R, C, rows);
  else if (relu)
    bn_fwd_kernel<T, VEC, true, false><<<grid, block, 0, s>>>(X, Z, k, c, Y, R, C, rows);
  else if (add)
    bn_fwd_kernel<T, VEC, false, true><<<grid, block, 0, s>>>(X, Z, k, c, Y, R, C, rows);
  else
    bn_fwd_kernel<T, VEC, false, false><<<grid, block, 0, s>>>(X, Z, k, c, Y, R, C, rows);
}

template <typename T, int VEC>
void launch_reduce(const Geometry& g, const void* x, const void* y,
                   const void* dy, const float* mean, const float* inv,
                   float* part, int64_t R, int C, int64_t chunks, bool relu,
                   cudaStream_t s) {
  const int64_t rows = (R + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(chunks), g.strips), block(g.tx, g.ty);
  auto X = static_cast<const T*>(x), Y = static_cast<const T*>(y);
  auto DY = static_cast<const T*>(dy);
  if (relu)
    bn_reduce_kernel<T, VEC, true><<<grid, block, 0, s>>>(X, Y, DY, mean, inv, part, R, C, rows);
  else
    bn_reduce_kernel<T, VEC, false><<<grid, block, 0, s>>>(X, Y, DY, mean, inv, part, R, C, rows);
}

template <typename T, int VEC>
void launch_dx(const Geometry& g, const void* x, const void* y,
               const void* dy, const float* a, const float* b,
               const float* c0, void* dx, void* dz, int64_t R, int C,
               bool relu, bool add, cudaStream_t s) {
  const int64_t chunks = elementwise_chunks(R, g);
  const int64_t rows = (R + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(chunks), g.strips), block(g.tx, g.ty);
  auto X = static_cast<const T*>(x), Y = static_cast<const T*>(y);
  auto DY = static_cast<const T*>(dy);
  auto DX = static_cast<T*>(dx), DZ = static_cast<T*>(dz);
  if (relu && add)
    bn_dx_kernel<T, VEC, true, true><<<grid, block, 0, s>>>(X, Y, DY, a, b, c0, DX, DZ, R, C, rows);
  else if (relu)
    bn_dx_kernel<T, VEC, true, false><<<grid, block, 0, s>>>(X, Y, DY, a, b, c0, DX, DZ, R, C, rows);
  else if (add)
    bn_dx_kernel<T, VEC, false, true><<<grid, block, 0, s>>>(X, Y, DY, a, b, c0, DX, DZ, R, C, rows);
  else
    bn_dx_kernel<T, VEC, false, false><<<grid, block, 0, s>>>(X, Y, DY, a, b, c0, DX, DZ, R, C, rows);
}

}  // namespace

// Entries: contiguous row operands of one type (bf16 != 0: bfloat16, else
// float32), fp32 per-channel vectors; z / dz may be null when add == 0.
extern "C" int pt_fused_bn_fwd(const void* x, const void* z, const float* k,
                               const float* c, void* y, int64_t R, int C,
                               int relu, int add, int bf16,
                               cudaStream_t stream) {
  if (bf16) {
    const int vec = pick_vec(C, 2, {x, z, y});
    const Geometry g = geometry(C, vec);
    if (vec == 8)
      launch_fwd<__nv_bfloat16, 8>(g, x, z, k, c, y, R, C, relu, add, stream);
    else
      launch_fwd<__nv_bfloat16, 1>(g, x, z, k, c, y, R, C, relu, add, stream);
  } else {
    const int vec = pick_vec(C, 4, {x, z, y});
    const Geometry g = geometry(C, vec);
    if (vec == 4)
      launch_fwd<float, 4>(g, x, z, k, c, y, R, C, relu, add, stream);
    else
      launch_fwd<float, 1>(g, x, z, k, c, y, R, C, relu, add, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// part: fp32 [chunks, 2, C] scratch; out: fp32 [2, C] = (dbeta, dgamma)
extern "C" int pt_fused_bn_bwd_reduce(const void* x, const void* y,
                                      const void* dy, const float* mean,
                                      const float* inv, float* part,
                                      float* out, int64_t R, int C,
                                      int64_t chunks, int relu, int bf16,
                                      cudaStream_t stream) {
  if (bf16) {
    const int vec = pick_vec(C, 2, {x, y, dy});
    const Geometry g = geometry(C, vec);
    if (vec == 8)
      launch_reduce<__nv_bfloat16, 8>(g, x, y, dy, mean, inv, part, R, C, chunks, relu, stream);
    else
      launch_reduce<__nv_bfloat16, 1>(g, x, y, dy, mean, inv, part, R, C, chunks, relu, stream);
  } else {
    const int vec = pick_vec(C, 4, {x, y, dy});
    const Geometry g = geometry(C, vec);
    if (vec == 4)
      launch_reduce<float, 4>(g, x, y, dy, mean, inv, part, R, C, chunks, relu, stream);
    else
      launch_reduce<float, 1>(g, x, y, dy, mean, inv, part, R, C, chunks, relu, stream);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pt::launch_column_sums<bn_reduce_sums>(
      part, out, chunks, 2 * static_cast<int64_t>(C), stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_fused_bn_bwd_dx(const void* x, const void* y,
                                  const void* dy, const float* a,
                                  const float* b, const float* c0, void* dx,
                                  void* dz, int64_t R, int C, int relu,
                                  int add, int bf16, cudaStream_t stream) {
  if (bf16) {
    const int vec = pick_vec(C, 2, {x, y, dy, dx, dz});
    const Geometry g = geometry(C, vec);
    if (vec == 8)
      launch_dx<__nv_bfloat16, 8>(g, x, y, dy, a, b, c0, dx, dz, R, C, relu, add, stream);
    else
      launch_dx<__nv_bfloat16, 1>(g, x, y, dy, a, b, c0, dx, dz, R, C, relu, add, stream);
  } else {
    const int vec = pick_vec(C, 4, {x, y, dy, dx, dz});
    const Geometry g = geometry(C, vec);
    if (vec == 4)
      launch_dx<float, 4>(g, x, y, dy, a, b, c0, dx, dz, R, C, relu, add, stream);
    else
      launch_dx<float, 1>(g, x, y, dy, a, b, c0, dx, dz, R, C, relu, add, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
