// Fused channel-last training batch norm for Hopper (sm_90a), forward and
// backward, float32 and bfloat16.
//
// Replaces analytics_zoo_tpu/ops/fused_bn.py::bn_train (the jax.custom_vjp
// whose forward is _bn_train_fwd = _moments + _normalize and whose backward
// is _bn_train_bwd), called by nn.BatchNormalization in channel-last
// training.  The wrapper is analytics_zoo_tpu_torch/ops/fused_bn.py.  For x
// viewed as [rows, C] with C contiguous (rows = N*H*W):
//
//   forward   shift = x[0, :]                                   (f32)
//             m1 = sum(x - shift) / n,  m2 = sum((x - shift)^2) / n
//             mean = m1 + shift,  var = max(m2 - m1^2, 0)       (f32 [C])
//             inv = rsqrt(var + eps) * gamma,  mean_c = T(mean)
//             sh = (f32(mean_c) - mean) * inv + beta
//             y = (x - mean_c) * T(inv) + T(sh)   in T, rounded per op
//   backward  inv = rsqrt(var + eps),  s1 = sum(dy),  s2 = sum(dy * (x - mean) * inv)
//             dgamma = s2, dbeta = s1, k = gamma * inv
//             c1 = (s1/n) k - dmean/n + (dvar/n) 2 mean,  c2 = (s2/n) k inv
//             cv = (dvar/n) 2
//             dx = T(dy k - c1 - (x - mean) c2 + x cv)          (f32 math)
//
// Design.  Four passes over the map, each a kernel over a grid of
// (channel tiles) x (row splits), and two small finalize kernels:
//   (a) stats:     per (split, channel) f32 partial sums of x - shift and
//                  (x - shift)^2;
//   (a') finalize: sums the partials of each channel in a fixed order and
//                  writes mean, var and the normalize's per-channel
//                  scalars (mean_c, T(inv), T(sh));
//   (b) normalize: y from x and those scalars;
//   (c) reduce:    per (split, channel) partials of s1 and s2;
//   (c') finalize: dgamma, dbeta and the dx pass's scalars (k, c1, c2, cv);
//   (d) dx:        dx from dy, x and those scalars.
// A thread owns one channel vector (V consecutive channels: 16 bytes, 8 bf16
// or 4 f32, where C is a multiple of V and every pointer 16-byte aligned;
// else one channel) and walks the rows of its split with a stride of the
// block's row groups, so a warp reads whole 16-byte pieces of consecutive
// channels and rows.  Channel tiles hold up to 32 vectors (256 bf16
// channels); splitting the rows as well fills the 132 SMs at both ends of
// ResNet-50's shapes (1,605,632 x 64 at the stem, 6,272 x 2048 in the last
// stage).  Partial sums reduce over the block's row groups in shared memory
// and across splits in the finalize, each in a fixed order: no atomics, so
// two runs on one input give identical bits.  The per-element arithmetic
// uses round-to-nearest intrinsics in the order the plain PyTorch version
// evaluates it (no contraction into FMAs), so y and dx agree with it exactly
// given the same per-channel scalars.
//
// What bounds it.  Batch norm does a few operations per element: it is
// bound by bytes.  The least traffic reads x and writes y once (forward)
// and reads dy and x and writes dx once (backward): 2 and 3 x rows * C *
// itemsize over 3.35 TB/s.  This design reads x twice in the forward and
// dy and x twice in the backward (3 and 5 map passes), so it can reach at
// most 2/3 and 3/5 of that bound where the map does not stay in the 50 MB
// L2 between its passes (the stem's 205 MB bf16 map does not; the last
// stage's 26 MB map may).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // threads per block, (tx, ty) = (vectors, row groups)
constexpr int kMaxTx = 32;     // channel vectors per block
constexpr int kMaxSplits = 65535;
constexpr int kFinTx = 32, kFinTy = 8;  // finalize blocks: channels x splits

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back: the value a T tensor holds
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// V consecutive elements at p (16-byte aligned when V > 1) as floats
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_f(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = from_f<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// The block's channel vector and row range.  blockDim = (tx, ty) with tx =
// min(C / V, 32) and ty = 256 / tx; blockIdx = (channel tile, row split).
struct Slot {
  int c0;        // first channel of this thread's vector
  bool active;   // c0 < C (the last channel tile may be partial)
  int64_t r0, r1;  // the split's rows
};

template <int V>
__device__ __forceinline__ Slot slot(int64_t rows, int C, int64_t rows_per_split) {
  Slot s;
  s.c0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  s.active = s.c0 < C;
  s.r0 = int64_t(blockIdx.y) * rows_per_split;
  s.r1 = min(rows, s.r0 + rows_per_split);
  return s;
}

// Sums red[ty][tx * V + i] over ty in a fixed order (tree over row groups);
// the result lands in red[0].  Every thread of the block calls it.
template <int V>
__device__ __forceinline__ void reduce_rows(float* red, const float (&acc)[V]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int width = blockDim.x * V;
#pragma unroll
  for (int i = 0; i < V; ++i) red[ty * width + tx * V + i] = acc[i];
  __syncthreads();
  for (int s = 1; s < blockDim.y; s <<= 1) {
    if ((ty & (2 * s - 1)) == 0 && ty + s < blockDim.y) {
#pragma unroll
      for (int i = 0; i < V; ++i)
        red[ty * width + tx * V + i] += red[(ty + s) * width + tx * V + i];
    }
    __syncthreads();
  }
}

// (a) per (split, channel) partial sums of x - shift and (x - shift)^2 into
// part[split][0][c] and part[split][1][c]
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, int64_t rows, int C,
                int64_t rows_per_split, float* __restrict__ part) {
  __shared__ float red[2][kThreads * V];
  const Slot sl = slot<V>(rows, C, rows_per_split);
  float shift[V], s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) shift[i] = s1[i] = s2[i] = 0.f;
  if (sl.active) {
    load<T, V>(x + sl.c0, shift);  // the one-sample shift: row 0
#pragma unroll 4
    for (int64_t r = sl.r0 + threadIdx.y; r < sl.r1; r += blockDim.y) {
      float v[V];
      load<T, V>(x + r * C + sl.c0, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[i] - shift[i];
        s1[i] += d;
        s2[i] = fmaf(d, d, s2[i]);
      }
    }
  }
  reduce_rows<V>(red[0], s1);
  reduce_rows<V>(red[1], s2);
  if (threadIdx.y == 0 && sl.active) {
    float* p = part + int64_t(blockIdx.y) * 2 * C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      p[sl.c0 + i] = red[0][threadIdx.x * V + i];
      p[C + sl.c0 + i] = red[1][threadIdx.x * V + i];
    }
  }
}

// Sums part[split][j][c] over the splits for j = 0, 1 in a fixed order;
// blockDim (32, 8), a block per 32 channels.  Returns (sum0, sum1) for
// threads with threadIdx.y == 0 and c < C.
__device__ __forceinline__ void sum_splits(const float* __restrict__ part,
                                           int splits, int C, int c,
                                           float& a, float& b) {
  __shared__ float red[2][kFinTy][kFinTx];
  const int tx = threadIdx.x, ty = threadIdx.y;
  a = b = 0.f;
  if (c < C) {
    for (int s = ty; s < splits; s += kFinTy) {
      a += part[int64_t(s) * 2 * C + c];
      b += part[int64_t(s) * 2 * C + C + c];
    }
  }
  red[0][ty][tx] = a;
  red[1][ty][tx] = b;
  __syncthreads();
  for (int s = 1; s < kFinTy; s <<= 1) {
    if ((ty & (2 * s - 1)) == 0) {
      red[0][ty][tx] += red[0][ty + s][tx];
      red[1][ty][tx] += red[1][ty + s][tx];
    }
    __syncthreads();
  }
  a = red[0][0][tx];
  b = red[1][0][tx];
}

// (a') mean, var and prm = [mean_c, T(inv), T(sh)] (each [C], f32 holding T
// values); the per-channel arithmetic in the plain version's order
template <typename T>
__global__ void __launch_bounds__(kFinTx * kFinTy)
bn_stats_finalize_kernel(const T* __restrict__ x,
                         const float* __restrict__ part, int splits, int C,
                         int64_t rows, const float* __restrict__ gamma,
                         const float* __restrict__ beta, float eps,
                         float* __restrict__ mean_out,
                         float* __restrict__ var_out,
                         float* __restrict__ prm) {
  const int c = blockIdx.x * kFinTx + threadIdx.x;
  float s1, s2;
  sum_splits(part, splits, C, c, s1, s2);
  if (threadIdx.y != 0 || c >= C) return;
  const float n = float(rows);
  const float m1 = __fdiv_rn(s1, n), m2 = __fdiv_rn(s2, n);
  const float mean = __fadd_rn(m1, to_f(x[c]));
  const float var = fmaxf(__fsub_rn(m2, __fmul_rn(m1, m1)), 0.f);
  const float inv = __fmul_rn(rsqrtf(__fadd_rn(var, eps)), gamma[c]);
  const float mean_c = round_t<T>(mean);
  const float sh = __fadd_rn(__fmul_rn(__fsub_rn(mean_c, mean), inv), beta[c]);
  mean_out[c] = mean;
  var_out[c] = var;
  prm[c] = mean_c;
  prm[C + c] = round_t<T>(inv);
  prm[2 * C + c] = round_t<T>(sh);
}

// (b) y = (x - mean_c) * inv_c + sh_c, each operation rounded to T
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_normalize_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                    int C, int64_t rows_per_split,
                    const float* __restrict__ prm) {
  const Slot sl = slot<V>(rows, C, rows_per_split);
  if (!sl.active) return;
  float mc[V], ic[V], sc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mc[i] = prm[sl.c0 + i];
    ic[i] = prm[C + sl.c0 + i];
    sc[i] = prm[2 * C + sl.c0 + i];
  }
#pragma unroll 4
  for (int64_t r = sl.r0 + threadIdx.y; r < sl.r1; r += blockDim.y) {
    float v[V];
    load<T, V>(x + r * C + sl.c0, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = round_t<T>(__fsub_rn(v[i], mc[i]));
      const float p = round_t<T>(__fmul_rn(d, ic[i]));
      v[i] = __fadd_rn(p, sc[i]);
    }
    store<T, V>(y + r * C + sl.c0, v);
  }
}

// (c) per (split, channel) partials of s1 = sum(dy) and s2 = sum(dy * x_hat)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const float* __restrict__ mean,
                     const float* __restrict__ var, float eps, int64_t rows,
                     int C, int64_t rows_per_split,
                     float* __restrict__ part) {
  __shared__ float red[2][kThreads * V];
  const Slot sl = slot<V>(rows, C, rows_per_split);
  float mu[V], inv[V], s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) mu[i] = inv[i] = s1[i] = s2[i] = 0.f;
  if (sl.active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mu[i] = mean[sl.c0 + i];
      inv[i] = rsqrtf(__fadd_rn(var[sl.c0 + i], eps));
    }
#pragma unroll 4
    for (int64_t r = sl.r0 + threadIdx.y; r < sl.r1; r += blockDim.y) {
      float g[V], v[V];
      load<T, V>(dy + r * C + sl.c0, g);
      load<T, V>(x + r * C + sl.c0, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1[i] += g[i];
        s2[i] = fmaf(g[i], __fmul_rn(__fsub_rn(v[i], mu[i]), inv[i]), s2[i]);
      }
    }
  }
  reduce_rows<V>(red[0], s1);
  reduce_rows<V>(red[1], s2);
  if (threadIdx.y == 0 && sl.active) {
    float* p = part + int64_t(blockIdx.y) * 2 * C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      p[sl.c0 + i] = red[0][threadIdx.x * V + i];
      p[C + sl.c0 + i] = red[1][threadIdx.x * V + i];
    }
  }
}

// (c') dgamma = s2, dbeta = s1 and prm = [k, c1, c2, cv] (each [C])
__global__ void __launch_bounds__(kFinTx * kFinTy)
bn_bwd_finalize_kernel(const float* __restrict__ part, int splits, int C,
                       int64_t rows, const float* __restrict__ gamma,
                       const float* __restrict__ mean,
                       const float* __restrict__ var,
                       const float* __restrict__ dmean,
                       const float* __restrict__ dvar, float eps,
                       float* __restrict__ dgamma, float* __restrict__ dbeta,
                       float* __restrict__ prm) {
  const int c = blockIdx.x * kFinTx + threadIdx.x;
  float s1, s2;
  sum_splits(part, splits, C, c, s1, s2);
  if (threadIdx.y != 0 || c >= C) return;
  const float n = float(rows);
  const float inv = rsqrtf(__fadd_rn(var[c], eps));
  const float k = __fmul_rn(gamma[c], inv);
  const float dvn = __fdiv_rn(dvar[c], n);
  const float c1 = __fadd_rn(
      __fsub_rn(__fmul_rn(__fdiv_rn(s1, n), k), __fdiv_rn(dmean[c], n)),
      __fmul_rn(__fmul_rn(dvn, 2.f), mean[c]));
  const float c2 = __fmul_rn(__fmul_rn(__fdiv_rn(s2, n), k), inv);
  dgamma[c] = s2;
  dbeta[c] = s1;
  prm[c] = k;
  prm[C + c] = c1;
  prm[2 * C + c] = c2;
  prm[3 * C + c] = __fmul_rn(dvn, 2.f);
}

// (d) dx = T(((dy k - c1) - (x - mean) c2) + x cv)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                 T* __restrict__ dx, const float* __restrict__ mean,
                 int64_t rows, int C, int64_t rows_per_split,
                 const float* __restrict__ prm) {
  const Slot sl = slot<V>(rows, C, rows_per_split);
  if (!sl.active) return;
  float k[V], c1[V], c2[V], cv[V], mu[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    k[i] = prm[sl.c0 + i];
    c1[i] = prm[C + sl.c0 + i];
    c2[i] = prm[2 * C + sl.c0 + i];
    cv[i] = prm[3 * C + sl.c0 + i];
    mu[i] = mean[sl.c0 + i];
  }
#pragma unroll 4
  for (int64_t r = sl.r0 + threadIdx.y; r < sl.r1; r += blockDim.y) {
    float g[V], v[V];
    load<T, V>(dy + r * C + sl.c0, g);
    load<T, V>(x + r * C + sl.c0, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float a = __fsub_rn(__fmul_rn(g[i], k[i]), c1[i]);
      const float b = __fmul_rn(__fsub_rn(v[i], mu[i]), c2[i]);
      g[i] = __fadd_rn(__fsub_rn(a, b), __fmul_rn(v[i], cv[i]));
    }
    store<T, V>(dx + r * C + sl.c0, g);
  }
}

// The grid of the four passes for [rows, C] in vectors of V channels.
struct Grid {
  dim3 block, grid;
  int64_t rows_per_split;
};

inline bool make_grid(int64_t rows, int C, int V, int splits, Grid& g) {
  if (rows < 1 || C < 1 || splits < 1 || splits > kMaxSplits || C % V)
    return false;
  const int nvec = C / V;
  const int tx = nvec < kMaxTx ? nvec : kMaxTx;
  const int ty = kThreads / tx;
  g.block = dim3(tx, ty);
  g.rows_per_split = (rows + splits - 1) / splits;
  g.grid = dim3((nvec + tx - 1) / tx, splits);
  return true;
}

template <typename T, int V>
cudaError_t fwd(const T* x, T* y, float* mean, float* var, const float* gamma,
                const float* beta, float* work, int64_t rows, int C,
                int splits, float eps, cudaStream_t stream) {
  Grid g;
  if (!make_grid(rows, C, V, splits, g)) return cudaErrorInvalidValue;
  float* part = work;                        // [splits][2][C]
  float* prm = work + int64_t(splits) * 2 * C;  // [3][C]
  bn_stats_kernel<T, V><<<g.grid, g.block, 0, stream>>>(
      x, rows, C, g.rows_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_stats_finalize_kernel<T><<<(C + kFinTx - 1) / kFinTx,
                                dim3(kFinTx, kFinTy), 0, stream>>>(
      x, part, splits, C, rows, gamma, beta, eps, mean, var, prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_normalize_kernel<T, V><<<g.grid, g.block, 0, stream>>>(
      x, y, rows, C, g.rows_per_split, prm);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t bwd(const T* dy, const T* x, const float* gamma, const float* mean,
                const float* var, const float* dmean, const float* dvar, T* dx,
                float* dgamma, float* dbeta, float* work, int64_t rows, int C,
                int splits, float eps, cudaStream_t stream) {
  Grid g;
  if (!make_grid(rows, C, V, splits, g)) return cudaErrorInvalidValue;
  float* part = work;                        // [splits][2][C]
  float* prm = work + int64_t(splits) * 2 * C;  // [4][C]
  bn_bwd_reduce_kernel<T, V><<<g.grid, g.block, 0, stream>>>(
      dy, x, mean, var, eps, rows, C, g.rows_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_bwd_finalize_kernel<<<(C + kFinTx - 1) / kFinTx, dim3(kFinTx, kFinTy),
                           0, stream>>>(part, splits, C, rows, gamma, mean,
                                        var, dmean, dvar, eps, dgamma, dbeta,
                                        prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_bwd_dx_kernel<T, V><<<g.grid, g.block, 0, stream>>>(
      dy, x, dx, mean, rows, C, g.rows_per_split, prm);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes.  x, y, dy, dx: contiguous [rows,
// C] of the entry's dtype; gamma, beta, mean, var, dmean, dvar, dgamma,
// dbeta: f32 [C]; work: f32 scratch of (2 * splits + 4) * C floats.
// `vec` != 0 takes 16-byte vectors of channels (C a multiple of 8 for bf16,
// 4 for f32, every map pointer 16-byte aligned); 0 takes one channel a
// thread.  Launch on `stream` (the forward: stats, finalize, normalize; the
// backward: reduce, finalize, dx), do not synchronise, allocate nothing;
// return the first failing launch's cudaError_t (0 on success).
#define FUSED_BN_ENTRIES(SUFFIX, T, V)                                        \
  extern "C" int fused_bn_fwd_##SUFFIX(                                       \
      const void* x, void* y, void* mean, void* var, const void* gamma,       \
      const void* beta, void* work, long long rows, int C, int splits,        \
      int vec, float eps, void* stream) {                                     \
    auto s = static_cast<cudaStream_t>(stream);                               \
    auto args = [&](auto v) {                                                 \
      return fwd<T, decltype(v)::value>(                                      \
          static_cast<const T*>(x), static_cast<T*>(y),                       \
          static_cast<float*>(mean), static_cast<float*>(var),                \
          static_cast<const float*>(gamma), static_cast<const float*>(beta),  \
          static_cast<float*>(work), rows, C, splits, eps, s);                \
    };                                                                        \
    return vec ? args(std::integral_constant<int, V>())                       \
               : args(std::integral_constant<int, 1>());                      \
  }                                                                           \
  extern "C" int fused_bn_bwd_##SUFFIX(                                       \
      const void* dy, const void* x, const void* gamma, const void* mean,     \
      const void* var, const void* dmean, const void* dvar, void* dx,         \
      void* dgamma, void* dbeta, void* work, long long rows, int C,           \
      int splits, int vec, float eps, void* stream) {                         \
    auto s = static_cast<cudaStream_t>(stream);                               \
    auto args = [&](auto v) {                                                 \
      return bwd<T, decltype(v)::value>(                                      \
          static_cast<const T*>(dy), static_cast<const T*>(x),                \
          static_cast<const float*>(gamma), static_cast<const float*>(mean),  \
          static_cast<const float*>(var), static_cast<const float*>(dmean),   \
          static_cast<const float*>(dvar), static_cast<T*>(dx),               \
          static_cast<float*>(dgamma), static_cast<float*>(dbeta),            \
          static_cast<float*>(work), rows, C, splits, eps, s);                \
    };                                                                        \
    return vec ? args(std::integral_constant<int, V>())                       \
               : args(std::integral_constant<int, 1>());                      \
  }

FUSED_BN_ENTRIES(f32, float, 4)
FUSED_BN_ENTRIES(bf16, __nv_bfloat16, 8)

extern "C" const char* fused_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
