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
//             mean = m1 + shift,  var = max(m2 - m1^2, 0)       (f32 [C];
//             a NaN stays NaN)
//             inv = rsqrt(var + eps) * gamma,  mean_c = T(mean)
//             sh = (f32(mean_c) - mean) * inv + beta
//             y = (x - mean_c) * T(inv) + T(sh)   in T, rounded per op
//   backward  inv = rsqrt(var + eps),  s1 = sum(dy),  s2 = sum(dy * (x - mean) * inv)
//             dgamma = s2, dbeta = s1, k = gamma * inv
//             c1 = (s1/n) k - dmean/n + (dvar/n) 2 mean,  c2 = (s2/n) k inv
//             cv = (dvar/n) 2
//             dx = T(dy k - c1 - (x - mean) c2 + x cv)          (f32 math)
//
// What bounds it.  Batch norm does a few operations per element: it is
// bound by bytes.  The least traffic reads x and writes y once (forward)
// and reads dy and x and writes dx once (backward): 2 and 3 x rows * C *
// itemsize over 3.35 TB/s.  Each direction needs every row twice, though:
// once for the per-channel sums and once, after every row has been summed,
// for the output.
//
// Design.  One persistent cooperative launch a direction, one block of 512
// threads an SM (the grid is what the card holds resident at once, read
// once a device).  A block owns units of (channel tile, row range); a tile
// is whole rows up to 512 channel vectors (every ResNet-50 map), so with
// one tile each block owns one range of rows, and wider maps split their
// tiles' rows among the blocks as evenly as the counts allow.  A thread
// owns one channel vector (V consecutive channels: 16 bytes, 8 bf16 or 4
// f32, where C is a multiple of V and every pointer 16-byte aligned; else
// one channel) and walks the rows with a stride of the block's row groups,
// so a warp reads whole 16-byte pieces of consecutive channels and rows.
//   phase 1: the block's f32 partials of (sum(x - shift), sum((x-shift)^2))
//            or (sum(dy), sum(dy x_hat)), summed over its row groups in
//            shared memory, written to a workspace [split][2][C];
//   grid barrier (a counter in the workspace, zeroed by a cudaMemsetAsync
//            on the stream before the launch);
//   finalize: groups of 32 channels spread over the blocks sum every
//            split's partials (coalesced, in a fixed order) and write mean
//            and var (dgamma and dbeta) and the output pass's per-channel
//            scalars: exactly one block per channel;
//   grid barrier;
//   phase 2: every block stages its tile's scalars through shared memory
//            and writes y, or dx.
// (Every block summing its own tile's partials, as a first version did,
// read splits x C partials per block from the same L2 lines at once: 30 us
// at 100,352 x 256, more than the map takes.)
// The map is kept on chip between the phases: in phase 1 the block copies
// as many of its first rows as fit in 200 KB of dynamic shared memory
// (dy's and x's in the backward: half as many rows) with cp.async.bulk,
// one copy a quarter completing on its mbarrier, while its threads stream
// the rest of its rows from device memory; phase 2 takes the rows in
// shared memory first, then re-reads the streamed rows in the reverse
// order, so the rows read last in phase 1 are found in the 50 MB L2.  A
// map of at most about 26 MB (forward; 13 MB backward) is read from device
// memory once: in bf16 every ResNet-50 map from 6,272 x 512 to 100,352 x
// 128 at batch 128 but the 51 MB ones.  No atomics in any sum: two runs on
// one input give identical bits.  The per-element arithmetic uses
// round-to-nearest intrinsics in the order the plain PyTorch version
// evaluates it (no contraction into FMAs), so y and dx agree with it
// exactly given the same per-channel scalars.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// threads per block, (tx, ty) = (channel vectors, row groups)
constexpr int kThreads = 512;
constexpr int kPieces = 4;     // mbarriers over the resident rows
constexpr int kUnroll = 4;     // rows' loads in flight per thread
// the finalize's loads in flight per lane: 16 warps take the 132 splits of
// an H100 in one round
constexpr int kSplitLoads = 9;
constexpr int kResidentBytes = 200 * 1024;  // dynamic shared memory at most

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

// V consecutive elements at p (16-byte aligned when V > 1) as floats; p in
// device or shared memory
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

// One unit of a block's work: channel tile `tile`, row range [r0, r1) =
// split `split` of the tile's `nsplits`.  Unit u is tile u % ctiles, split
// u / ctiles, so with units = blocks every SM has one and the tiles' split
// counts differ by at most one.
struct Unit {
  int split;
  int cbase;      // the tile's first channel
  int width;      // the tile's channels (the last tile may be narrower)
  int c0;         // first channel of this thread's vector
  bool active;    // c0 < C
  int64_t r0, r1;
};

template <int V>
__device__ __forceinline__ Unit unit(int u, int ctiles, int units,
                                     int64_t rows, int C) {
  Unit w;
  const int tile = u % ctiles;
  const int nsplits = (units - tile + ctiles - 1) / ctiles;
  w.split = u / ctiles;
  w.cbase = tile * blockDim.x * V;
  w.width = min(int(blockDim.x) * V, C - w.cbase);
  w.c0 = w.cbase + threadIdx.x * V;
  w.active = w.c0 < C;
  w.r0 = rows * w.split / nsplits;
  w.r1 = rows * (w.split + 1) / nsplits;
  return w;
}

__device__ __forceinline__ int thread_rank() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

// The block's sum over its row groups of each thread's acc[V], in a fixed
// order (row group 0 first), into out[c] for the unit's channels: acc goes
// through red ([ty][tx * V]), then thread j sums column j.  Every thread
// of the block calls it.
template <int V>
__device__ __forceinline__ void column_sums(float* red, const Unit& w,
                                            const float (&acc)[V],
                                            float* out) {
  const int width = blockDim.x * V;
  float* mine = red + threadIdx.y * width + threadIdx.x * V;
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(mine + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) mine[i] = acc[i];
  }
  __syncthreads();
  for (int j = thread_rank(); j < w.width; j += blockDim.x * blockDim.y) {
    float sum = 0.f;
    for (int k = 0; k < blockDim.y; ++k) sum += red[k * width + j];
    out[j] = sum;
  }
  __syncthreads();  // red is free again
}

// Phase 1's end: the unit's partials (a, b) into part[split][0 | 1][c]
template <int V>
__device__ __forceinline__ void write_partials(float* part, int C,
                                               const Unit& w, float* red,
                                               const float (&a)[V],
                                               const float (&b)[V]) {
  float* p = part + int64_t(w.split) * 2 * C + w.cbase;
  column_sums<V>(red, w, a, p);
  column_sums<V>(red, w, b, p + C);
}

// The finalize, between the two grid barriers: groups of 32 channels
// spread over the blocks; in a block, lane l of warp w sums splits w, w +
// warps, ... of part[s][0 | 1][c] for channel c = 32 group + l (read from
// L2: other SMs wrote them; a warp's loads are 128 contiguous bytes), then
// thread l adds the warps' sums in order and calls per_channel(c, s1, s2).
// The order is fixed, so every run gives the same bits.
template <typename PerChannel>
__device__ __forceinline__ void finalize(const float* part, int C,
                                         int tile_width, int ctiles,
                                         int units, float* red,
                                         PerChannel per_channel) {
  const int rank = thread_rank(), warp = rank / 32, lane = rank % 32;
  const int warps = blockDim.x * blockDim.y / 32;  // whole warps only
  for (int group = blockIdx.x; group * 32 < C; group += gridDim.x) {
    const int c = group * 32 + lane;
    if (warp < warps) {
      float a = 0.f, b = 0.f;
      if (c < C) {
        const int tile = c / tile_width;
        const int nsplits = (units - tile + ctiles - 1) / ctiles;
        // kSplitLoads splits' loads in flight before any is added (a split
        // past the last adds zeros)
        for (int s = warp; s < nsplits; s += kSplitLoads * warps) {
          float pa[kSplitLoads], pb[kSplitLoads];
#pragma unroll
          for (int k = 0; k < kSplitLoads; ++k) {
            const int64_t at = int64_t(s + k * warps) * 2 * C + c;
            const bool in = s + k * warps < nsplits;
            pa[k] = in ? __ldcg(part + at) : 0.f;
            pb[k] = in ? __ldcg(part + at + C) : 0.f;
          }
#pragma unroll
          for (int k = 0; k < kSplitLoads; ++k) {
            a += pa[k];
            b += pb[k];
          }
        }
      }
      red[warp * 32 + lane] = a;
      red[(warps + warp) * 32 + lane] = b;
    }
    __syncthreads();
    if (rank < 32 && c < C) {
      float a = 0.f, b = 0.f;
      for (int k = 0; k < warps; ++k) {
        a += red[k * 32 + lane];
        b += red[(warps + k) * 32 + lane];
      }
      per_channel(c, a, b);
    }
    __syncthreads();
  }
}

// The per-channel scalars prm[j][c] of this thread's vector, out[j][i] for
// c = c0 + i: each row of prm (written by other SMs' finalize: read from
// L2) staged for the unit's tile in red by coalesced loads.  Every thread
// of the block calls it.
template <int V, int N>
__device__ __forceinline__ void load_scalars(const float* prm, int C,
                                             const Unit& w, float* red,
                                             float (&out)[N][V]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    for (int k = thread_rank(); k < w.width; k += blockDim.x * blockDim.y)
      red[k] = __ldcg(prm + int64_t(j) * C + w.cbase + k);
    __syncthreads();
    if (w.active) {
#pragma unroll
      for (int i = 0; i < V; ++i) out[j][i] = red[w.c0 - w.cbase + i];
    }
    __syncthreads();
  }
}

// cp.async.bulk of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(warp_mma::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(warp_mma::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ int piece_row(int keep, int p) {
  return keep * p / kPieces;
}

// Copies rows [r0, r0 + keep) of the unit's channel tile of each of the
// NS maps src[s] ([rows, C]) into dst[s] (keep x width, dense), piece p of
// kPieces completing on bars[p]: one copy a piece where the tile is whole
// rows, else one a row.  Thread 0 arms the barriers, warp 0 sends them.
template <typename T, int NS>
__device__ __forceinline__ void load_resident(const T* const (&src)[NS],
                                              T* const (&dst)[NS], int C,
                                              const Unit& w, int keep,
                                              uint64_t* bars) {
  const int rank = thread_rank();
  if (rank >= 32) return;
  const uint32_t row_bytes = uint32_t(w.width) * sizeof(T);
  if (rank == 0) {
    for (int p = 0; p < kPieces; ++p)
      hopper::mbar_expect_tx(
          &bars[p],
          NS * row_bytes * (piece_row(keep, p + 1) - piece_row(keep, p)));
  }
  __syncwarp();
  for (int p = 0; p < kPieces; ++p) {
    const int a = piece_row(keep, p), b = piece_row(keep, p + 1);
    if (a == b) continue;
    if (w.width == C) {
      if (rank == 0) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
          bulk_load(dst[s] + int64_t(a) * C, src[s] + (w.r0 + a) * C,
                    row_bytes * (b - a), &bars[p]);
      }
    } else {
      for (int r = a + rank; r < b; r += 32) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
          bulk_load(dst[s] + int64_t(r) * w.width,
                    src[s] + (w.r0 + r) * C + w.cbase, row_bytes, &bars[p]);
      }
    }
  }
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every block of the grid waits here until all have arrived (round 1, 2,
// ... of one counter); writes before it are visible to every block after
// it.  The launch is cooperative, so
// every block is resident; a wait of seconds is a fault and traps.
__device__ __forceinline__ void grid_sync(unsigned* count, int round) {
  __syncthreads();
  if (thread_rank() == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const long long start = clock64();
    while (load_acquire(count) < round * gridDim.x) {
      if (clock64() - start > (1ll << 33)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Calls f(row, off) for the rows [a, b) of this thread's row group (a +
// ty, a + ty + TY, ...), kUnroll rows loaded before any is used; `off` is
// the element offset of the row's vector, `ld` the row pitch.  With
// `reverse` the walk starts at b - 1 - ty and steps down.
template <bool kReverse, typename Load, typename Use>
__device__ __forceinline__ void walk(int64_t a, int64_t b, Load ld, Use use) {
  const int64_t step = blockDim.y;
  int64_t r = kReverse ? b - 1 - threadIdx.y : a + threadIdx.y;
  auto inside = [&](int64_t row) { return kReverse ? row >= a : row < b; };
  const int64_t last = kReverse ? -(kUnroll - 1) * step : (kUnroll - 1) * step;
  for (; inside(r + last); r += kReverse ? -kUnroll * step : kUnroll * step) {
    decltype(ld(r)) v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      v[k] = ld(r + (kReverse ? -k : k) * step);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      use(r + (kReverse ? -k : k) * step, v[k]);
  }
  for (; inside(r); r += kReverse ? -step : step) use(r, ld(r));
}

template <int V>
struct Vec {
  float v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<V> vload(const T* p) {
  Vec<V> out;
  load<T, V>(p, out.v);
  return out;
}

template <int V>
struct Pair {
  Vec<V> g, x;
};

#ifdef FUSED_BN_TRACE
// Per block, thread 0's clock at the forward's phase boundaries (slot 0:
// %globaltimer at the start): a build for dev/torch_bn_parts.py --trace.
__device__ long long g_trace[1024][10];
__device__ __forceinline__ void trace(int k) {
  if (thread_rank() != 0 || blockIdx.x >= 1024) return;
  long long t;
  if (k == 0)
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  else
    t = clock64();
  g_trace[blockIdx.x][k] = t;
}
#else
__device__ __forceinline__ void trace(int) {}
#endif

template <typename T>
struct FwdArgs {
  const T* x;
  T* y;
  const float* gamma;
  const float* beta;
  float* mean;
  float* var;
  float* part;       // [splits][2][C]
  float* prm;        // [3][C]: mean_c, T(inv), T(sh)
  unsigned* count;   // the grid barrier's counter, zeroed before the launch
  int64_t rows;
  int C, ctiles, units, keep;
  float eps;
};

// The forward: phase 1 shifted sums, barrier, the finalize (mean, var and
// the normalize's scalars), barrier, phase 2
// y = (x - mean_c) * inv_c + sh_c, each operation rounded to T
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1) bn_fwd_kernel(FwdArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) float red[kThreads * (V > 2 ? V : 2)];
  __shared__ uint64_t bars[kPieces];
  T* res = reinterpret_cast<T*>(smem);
  const int C = a.C;
  if (a.keep > 0) {
    if (thread_rank() == 0) {
      for (int p = 0; p < kPieces; ++p) hopper::mbar_init(&bars[p], 1);
      hopper::mbar_init_fence();
    }
    __syncthreads();
  }
  trace(0);
  trace(1);

  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const Unit w = unit<V>(u, a.ctiles, a.units, a.rows, C);
    const int keep = int(min(int64_t(a.keep), w.r1 - w.r0));
    if (keep > 0) {
      const T* src[1] = {a.x};
      T* const dst[1] = {res};
      load_resident<T, 1>(src, dst, C, w, keep, bars);
    }
    float shift[V], s1[V], s2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) shift[i] = s1[i] = s2[i] = 0.f;
    if (w.active) {
      load<T, V>(a.x + w.c0, shift);  // the one-sample shift: row 0
      auto add = [&](int64_t, const Vec<V>& v) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = v.v[i] - shift[i];
          s1[i] += d;
          s2[i] = fmaf(d, d, s2[i]);
        }
      };
      const int off = w.c0 - w.cbase;
      walk<false>(w.r0 + keep, w.r1,
                  [&](int64_t r) { return vload<T, V>(a.x + r * C + w.c0); },
                  add);
      trace(2);
      for (int p = 0; p < kPieces && keep > 0; ++p) {
        hopper::mbar_wait(&bars[p], 0);
        walk<false>(piece_row(keep, p), piece_row(keep, p + 1),
                    [&](int64_t r) {
                      return vload<T, V>(res + r * w.width + off);
                    },
                    add);
      }
      trace(3);
    }
    write_partials<V>(a.part, C, w, red, s1, s2);
  }
  trace(4);

  grid_sync(a.count, 1);
  trace(5);
  finalize(a.part, C, blockDim.x * V, a.ctiles, a.units, red,
           [&](int c, float s1, float s2) {
             const float n = float(a.rows);
             const float m1 = __fdiv_rn(s1, n), m2 = __fdiv_rn(s2, n);
             const float mean = __fadd_rn(m1, to_f(a.x[c]));
             // max(d, 0) that keeps a NaN, as jnp.maximum and torch's
             // clamp do (fmaxf drops it: a poisoned channel's var would
             // read 0)
             const float d = __fsub_rn(m2, __fmul_rn(m1, m1));
             const float var = d != d ? d : fmaxf(d, 0.f);
             const float inv =
                 __fmul_rn(rsqrtf(__fadd_rn(var, a.eps)), a.gamma[c]);
             const float mean_c = round_t<T>(mean);
             const float sh = __fadd_rn(
                 __fmul_rn(__fsub_rn(mean_c, mean), inv), a.beta[c]);
             a.mean[c] = mean;
             a.var[c] = var;
             a.prm[c] = mean_c;
             a.prm[C + c] = round_t<T>(inv);
             a.prm[2 * C + c] = round_t<T>(sh);
           });
  trace(6);
  grid_sync(a.count, 2);
  trace(7);

  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const Unit w = unit<V>(u, a.ctiles, a.units, a.rows, C);
    float sc[3][V];  // mean_c, inv_c, sh_c
    load_scalars<V, 3>(a.prm, C, w, red, sc);
    if (!w.active) continue;
    const int keep = int(min(int64_t(a.keep), w.r1 - w.r0));
    auto put = [&](int64_t r, Vec<V> v) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = round_t<T>(__fsub_rn(v.v[i], sc[0][i]));
        const float p = round_t<T>(__fmul_rn(d, sc[1][i]));
        v.v[i] = __fadd_rn(p, sc[2][i]);
      }
      store<T, V>(a.y + r * C + w.c0, v.v);
    };
    const int off = w.c0 - w.cbase;
    walk<false>(0, keep,
                [&](int64_t r) {
                  return vload<T, V>(res + r * w.width + off);
                },
                [&](int64_t r, const Vec<V>& v) { put(w.r0 + r, v); });
    walk<true>(w.r0 + keep, w.r1,
               [&](int64_t r) {
                 return vload<T, V>(a.x + r * C + w.c0);
               },
               put);
  }
#ifdef FUSED_BN_TRACE
  __syncthreads();
  trace(8);
#endif
}

template <typename T>
struct BwdArgs {
  const T* dy;
  const T* x;
  const float* gamma;
  const float* mean;
  const float* var;
  const float* dmean;
  const float* dvar;
  T* dx;
  float* dgamma;
  float* dbeta;
  float* part;
  float* prm;        // [4][C]: k, c1, c2, cv
  unsigned* count;
  int64_t rows;
  int C, ctiles, units, keep;
  float eps;
};

// The backward: phase 1 s1 = sum(dy), s2 = sum(dy x_hat), barrier, the
// finalize (dgamma, dbeta and the per-channel k, c1, c2, cv), barrier,
// phase 2 dx = T(((dy k - c1) - (x - mean) c2) + x cv)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1) bn_bwd_kernel(BwdArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) float red[kThreads * (V > 2 ? V : 2)];
  __shared__ uint64_t bars[kPieces];
  const int C = a.C;
  if (a.keep > 0) {
    if (thread_rank() == 0) {
      for (int p = 0; p < kPieces; ++p) hopper::mbar_init(&bars[p], 1);
      hopper::mbar_init_fence();
    }
    __syncthreads();
  }

  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const Unit w = unit<V>(u, a.ctiles, a.units, a.rows, C);
    const int keep = int(min(int64_t(a.keep), w.r1 - w.r0));
    T* res_dy = reinterpret_cast<T*>(smem);
    T* res_x = res_dy + int64_t(keep) * w.width;
    if (keep > 0) {
      const T* src[2] = {a.dy, a.x};
      T* const dst[2] = {res_dy, res_x};
      load_resident<T, 2>(src, dst, C, w, keep, bars);
    }
    float mu[V], inv[V], s1[V], s2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) mu[i] = inv[i] = s1[i] = s2[i] = 0.f;
    if (w.active) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        mu[i] = a.mean[w.c0 + i];
        inv[i] = rsqrtf(__fadd_rn(a.var[w.c0 + i], a.eps));
      }
      auto add = [&](int64_t, const Pair<V>& q) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s1[i] += q.g.v[i];
          s2[i] = fmaf(q.g.v[i],
                       __fmul_rn(__fsub_rn(q.x.v[i], mu[i]), inv[i]), s2[i]);
        }
      };
      walk<false>(w.r0 + keep, w.r1,
                  [&](int64_t r) {
                    return Pair<V>{vload<T, V>(a.dy + r * C + w.c0),
                                   vload<T, V>(a.x + r * C + w.c0)};
                  },
                  add);
      const int off = w.c0 - w.cbase;
      for (int p = 0; p < kPieces && keep > 0; ++p) {
        hopper::mbar_wait(&bars[p], 0);
        walk<false>(piece_row(keep, p), piece_row(keep, p + 1),
                    [&](int64_t r) {
                      return Pair<V>{vload<T, V>(res_dy + r * w.width + off),
                                     vload<T, V>(res_x + r * w.width + off)};
                    },
                    add);
      }
    }
    write_partials<V>(a.part, C, w, red, s1, s2);
  }

  grid_sync(a.count, 1);
  finalize(a.part, C, blockDim.x * V, a.ctiles, a.units, red,
           [&](int c, float s1, float s2) {
             const float n = float(a.rows);
             const float inv = rsqrtf(__fadd_rn(a.var[c], a.eps));
             const float k = __fmul_rn(a.gamma[c], inv);
             const float dvn = __fdiv_rn(a.dvar[c], n);
             a.dgamma[c] = s2;
             a.dbeta[c] = s1;
             a.prm[c] = k;
             a.prm[C + c] = __fadd_rn(
                 __fsub_rn(__fmul_rn(__fdiv_rn(s1, n), k),
                           __fdiv_rn(a.dmean[c], n)),
                 __fmul_rn(__fmul_rn(dvn, 2.f), a.mean[c]));
             a.prm[2 * C + c] =
                 __fmul_rn(__fmul_rn(__fdiv_rn(s2, n), k), inv);
             a.prm[3 * C + c] = __fmul_rn(dvn, 2.f);
           });
  grid_sync(a.count, 2);

  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const Unit w = unit<V>(u, a.ctiles, a.units, a.rows, C);
    float sc[4][V], mu[V];  // k, c1, c2, cv
    load_scalars<V, 4>(a.prm, C, w, red, sc);
    if (!w.active) continue;
    const int keep = int(min(int64_t(a.keep), w.r1 - w.r0));
    const T* res_dy = reinterpret_cast<const T*>(smem);
    const T* res_x = res_dy + int64_t(keep) * w.width;
#pragma unroll
    for (int i = 0; i < V; ++i) mu[i] = a.mean[w.c0 + i];
    auto put = [&](int64_t r, Pair<V> q) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float g = q.g.v[i], v = q.x.v[i];
        const float p = __fsub_rn(__fmul_rn(g, sc[0][i]), sc[1][i]);
        const float b = __fmul_rn(__fsub_rn(v, mu[i]), sc[2][i]);
        q.g.v[i] = __fadd_rn(__fsub_rn(p, b), __fmul_rn(v, sc[3][i]));
      }
      store<T, V>(a.dx + r * C + w.c0, q.g.v);
    };
    const int off = w.c0 - w.cbase;
    walk<false>(0, keep,
                [&](int64_t r) {
                  return Pair<V>{vload<T, V>(res_dy + r * w.width + off),
                                 vload<T, V>(res_x + r * w.width + off)};
                },
                [&](int64_t r, const Pair<V>& q) { put(w.r0 + r, q); });
    walk<true>(w.r0 + keep, w.r1,
               [&](int64_t r) {
                 return Pair<V>{
                     vload<T, V>(a.dy + r * C + w.c0),
                     vload<T, V>(a.x + r * C + w.c0)};
               },
               put);
  }
}

// ---------------------------------------------------------------------------
// the split form: batch norm over a batch split across processes
// ---------------------------------------------------------------------------
// When the batch's rows lie on several processes, one grid barrier cannot
// span them: each direction splits at its reduction.  The wrapper
// (ops/fused_bn.py) runs, for the forward,
//   stats:  part = per-channel f32 (sum(x - shift), sum((x - shift)^2)) of
//           the local rows, shift = the global row 0 (broadcast from the
//           first rank of the data group);
//   all_reduce of the [2, C] sums over the data group;
//   apply:  mean, var over the global n and y, with the one-launch
//           kernel's finalize and normalize arithmetic;
// and for the backward
//   stats:  (sum(dy), sum(dy x_hat)) of the local rows;
//   all_reduce of [s1, s2, dmean, dvar] ([4, C]);
//   apply:  dx from the global sums (dgamma, dbeta are the local sums: the
//           estimator's gradient all-reduce adds them up).
// The stats launch is a grid of (channel tile x row split) blocks, each
// writing its partials to [split][2][C], and a second small launch sums
// the splits per channel in a fixed order; no atomics, so one input gives
// one result.  The apply launch is a grid of the same shape over the rows.

template <typename T>
struct SplitArgs {
  const T* x;
  const T* dy;          // the backward's
  const float* shift;   // the forward's [C]
  const float* mean;    // the backward's saved statistics
  const float* var;
  float* part;          // [splits][2][C]
  int64_t rows;
  int C, ctiles, units;
  float eps;
};

// stats: each block's partial sums of its unit's rows
template <typename T, int V, bool kBwd>
__global__ void __launch_bounds__(kThreads) bn_split_sums_kernel(
    SplitArgs<T> a) {
  __shared__ __align__(16) float red[kThreads * (V > 2 ? V : 2)];
  const Unit w = unit<V>(blockIdx.x, a.ctiles, a.units, a.rows, a.C);
  const int C = a.C;
  float s1[V], s2[V], k0[V], k1[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = k0[i] = k1[i] = 0.f;
  if (w.active) {
    if constexpr (kBwd) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        k0[i] = a.mean[w.c0 + i];
        k1[i] = rsqrtf(__fadd_rn(a.var[w.c0 + i], a.eps));
      }
      walk<false>(w.r0, w.r1,
                  [&](int64_t r) {
                    return Pair<V>{vload<T, V>(a.dy + r * C + w.c0),
                                   vload<T, V>(a.x + r * C + w.c0)};
                  },
                  [&](int64_t, const Pair<V>& q) {
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                      s1[i] += q.g.v[i];
                      s2[i] = fmaf(q.g.v[i],
                                   __fmul_rn(__fsub_rn(q.x.v[i], k0[i]),
                                             k1[i]),
                                   s2[i]);
                    }
                  });
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) k0[i] = a.shift[w.c0 + i];
      walk<false>(w.r0, w.r1,
                  [&](int64_t r) { return vload<T, V>(a.x + r * C + w.c0); },
                  [&](int64_t, const Vec<V>& v) {
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                      const float d = v.v[i] - k0[i];
                      s1[i] += d;
                      s2[i] = fmaf(d, d, s2[i]);
                    }
                  });
    }
  }
  write_partials<V>(a.part, C, w, red, s1, s2);
}

// stats' second launch: out[j][c] = sum over the splits of part[s][j][c],
// in split order
__global__ void bn_split_reduce_kernel(const float* part, float* out, int C,
                                       int splits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int s = 0; s < splits; ++s) {
    a += part[int64_t(s) * 2 * C + c];
    b += part[int64_t(s) * 2 * C + C + c];
  }
  out[c] = a;
  out[C + c] = b;
}

template <typename T>
struct SplitFwdApply {
  const T* x;
  T* y;
  const float* gamma;
  const float* beta;
  const float* sums;   // [2][C], summed over every process
  const float* shift;  // [C]
  float* mean;
  float* var;
  int64_t rows, n;     // local rows, global rows
  int C, ctiles, units;
  float eps;
};

// the forward's apply: each thread derives its channels' scalars from the
// global sums (the one-launch finalize's arithmetic), blocks of split 0
// write mean and var, and every block writes y for its rows
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bn_split_fwd_apply_kernel(
    SplitFwdApply<T> a) {
  const Unit w = unit<V>(blockIdx.x, a.ctiles, a.units, a.rows, a.C);
  if (!w.active) return;
  const int C = a.C;
  float sc[3][V];  // mean_c, T(inv), T(sh)
  const float n = float(a.n);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = w.c0 + i;
    const float m1 = __fdiv_rn(a.sums[c], n);
    const float m2 = __fdiv_rn(a.sums[C + c], n);
    const float mean = __fadd_rn(m1, a.shift[c]);
    const float d = __fsub_rn(m2, __fmul_rn(m1, m1));
    const float var = d != d ? d : fmaxf(d, 0.f);
    const float inv = __fmul_rn(rsqrtf(__fadd_rn(var, a.eps)), a.gamma[c]);
    const float mean_c = round_t<T>(mean);
    const float sh =
        __fadd_rn(__fmul_rn(__fsub_rn(mean_c, mean), inv), a.beta[c]);
    sc[0][i] = mean_c;
    sc[1][i] = round_t<T>(inv);
    sc[2][i] = round_t<T>(sh);
    if (w.split == 0 && threadIdx.y == 0) {
      a.mean[c] = mean;
      a.var[c] = var;
    }
  }
  walk<false>(w.r0, w.r1,
              [&](int64_t r) { return vload<T, V>(a.x + r * C + w.c0); },
              [&](int64_t r, Vec<V> v) {
#pragma unroll
                for (int i = 0; i < V; ++i) {
                  const float d = round_t<T>(__fsub_rn(v.v[i], sc[0][i]));
                  const float p = round_t<T>(__fmul_rn(d, sc[1][i]));
                  v.v[i] = __fadd_rn(p, sc[2][i]);
                }
                store<T, V>(a.y + r * C + w.c0, v.v);
              });
}

template <typename T>
struct SplitBwdApply {
  const T* dy;
  const T* x;
  const float* gamma;
  const float* mean;
  const float* var;
  const float* sums;  // [4][C]: s1, s2, dmean, dvar, summed over processes
  T* dx;
  int64_t rows, n;
  int C, ctiles, units;
  float eps;
};

// the backward's apply: k, c1, c2, cv from the global sums (the one-launch
// finalize's arithmetic), then dx = T(((dy k - c1) - (x - mean) c2) + x cv)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bn_split_bwd_apply_kernel(
    SplitBwdApply<T> a) {
  const Unit w = unit<V>(blockIdx.x, a.ctiles, a.units, a.rows, a.C);
  if (!w.active) return;
  const int C = a.C;
  float sc[4][V], mu[V];
  const float n = float(a.n);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = w.c0 + i;
    const float s1 = a.sums[c], s2 = a.sums[C + c];
    const float inv = rsqrtf(__fadd_rn(a.var[c], a.eps));
    const float k = __fmul_rn(a.gamma[c], inv);
    const float dvn = __fdiv_rn(a.sums[3 * C + c], n);
    mu[i] = a.mean[c];
    sc[0][i] = k;
    sc[1][i] = __fadd_rn(__fsub_rn(__fmul_rn(__fdiv_rn(s1, n), k),
                                   __fdiv_rn(a.sums[2 * C + c], n)),
                         __fmul_rn(__fmul_rn(dvn, 2.f), mu[i]));
    sc[2][i] = __fmul_rn(__fmul_rn(__fdiv_rn(s2, n), k), inv);
    sc[3][i] = __fmul_rn(dvn, 2.f);
  }
  walk<false>(w.r0, w.r1,
              [&](int64_t r) {
                return Pair<V>{vload<T, V>(a.dy + r * C + w.c0),
                               vload<T, V>(a.x + r * C + w.c0)};
              },
              [&](int64_t r, Pair<V> q) {
#pragma unroll
                for (int i = 0; i < V; ++i) {
                  const float g = q.g.v[i], v = q.x.v[i];
                  const float p = __fsub_rn(__fmul_rn(g, sc[0][i]), sc[1][i]);
                  const float b = __fmul_rn(__fsub_rn(v, mu[i]), sc[2][i]);
                  q.g.v[i] = __fadd_rn(__fsub_rn(p, b), __fmul_rn(v, sc[3][i]));
                }
                store<T, V>(a.dx + r * C + w.c0, q.g.v);
              });
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Blocks of `kernel` the device `dev` holds resident at once with the most
// dynamic shared memory a launch asks for: read once per kernel and device,
// when the kernel's shared memory limit is raised.
cudaError_t resident_blocks(const void* kernel, int dev, int& out) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> cache;
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find({kernel, dev});
  if (it != cache.end()) {
    out = it->second;
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kResidentBytes);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, kResidentBytes);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  out = cache[{kernel, dev}] = per_sm * sms;
  return cudaSuccess;
}

// The launch's shape for [rows, C] in vectors of V channels of `maps` maps
// of `itemsize` bytes kept on chip; false if the plan does not fit.
struct Shape {
  dim3 block;
  int ctiles, units, splits;
  size_t smem;
};

inline bool make_shape(int64_t rows, int C, int V, int blocks, int keep,
                       int maps, int itemsize, Shape& s) {
  if (rows < 1 || C < 1 || C % V || blocks < 1 || keep < 0) return false;
  const int nvec = C / V;
  const int tx = nvec < kThreads ? nvec : kThreads;  // a tile: whole rows
  s.block = dim3(tx, kThreads / tx);
  s.ctiles = (nvec + tx - 1) / tx;
  s.units = blocks > s.ctiles ? blocks : s.ctiles;
  s.splits = (s.units + s.ctiles - 1) / s.ctiles;
  s.smem = size_t(keep) * tx * V * itemsize * maps;
  if (keep > 0 && (V == 1 || s.units > blocks)) return false;
  return s.smem <= size_t(kResidentBytes);
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, int blocks, const Shape& s, unsigned* count,
                   cudaStream_t stream, const Args& args) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = resident_blocks((const void*)kernel, dev, most);
  if (err != cudaSuccess) return err;
  if (blocks > most) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(count, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = s.block;
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int V>
cudaError_t fwd(const T* x, T* y, const float* gamma, const float* beta,
                float* work, int64_t rows, int C, int blocks, int keep,
                float eps, cudaStream_t stream) {
  Shape s;
  if (!make_shape(rows, C, V, blocks, keep, 1, sizeof(T), s))
    return cudaErrorInvalidValue;
  FwdArgs<T> a;
  a.x = x;
  a.y = y;
  a.gamma = gamma;
  a.beta = beta;
  a.mean = work;
  a.var = work + C;
  a.part = work + 2 * int64_t(C);
  a.prm = a.part + int64_t(s.splits) * 2 * C;
  a.count = reinterpret_cast<unsigned*>(a.prm + 4 * int64_t(C));
  a.rows = rows;
  a.C = C;
  a.ctiles = s.ctiles;
  a.units = s.units;
  a.keep = keep;
  a.eps = eps;
  return launch(bn_fwd_kernel<T, V>, blocks, s, a.count, stream, a);
}

template <typename T, int V>
cudaError_t bwd(const T* dy, const T* x, const float* gamma, const float* mean,
                const float* var, const float* dmean, const float* dvar, T* dx,
                float* work, int64_t rows, int C, int blocks, int keep,
                float eps, cudaStream_t stream) {
  Shape s;
  if (!make_shape(rows, C, V, blocks, keep, 2, sizeof(T), s))
    return cudaErrorInvalidValue;
  BwdArgs<T> a;
  a.dy = dy;
  a.x = x;
  a.gamma = gamma;
  a.mean = mean;
  a.var = var;
  a.dmean = dmean;
  a.dvar = dvar;
  a.dx = dx;
  a.dgamma = work;
  a.dbeta = work + C;
  a.part = work + 2 * int64_t(C);
  a.prm = a.part + int64_t(s.splits) * 2 * C;
  a.count = reinterpret_cast<unsigned*>(a.prm + 4 * int64_t(C));
  a.rows = rows;
  a.C = C;
  a.ctiles = s.ctiles;
  a.units = s.units;
  a.keep = keep;
  a.eps = eps;
  return launch(bn_bwd_kernel<T, V>, blocks, s, a.count, stream, a);
}

// The split form's grid over [rows, C]: (channel tile x `splits` row
// ranges) blocks of (tx, ty) threads; false if the shape does not fit.
inline bool split_shape(int64_t rows, int C, int V, int splits, dim3& block,
                        int& ctiles, int& units) {
  if (rows < 1 || C < 1 || C % V || splits < 1) return false;
  const int nvec = C / V;
  const int tx = nvec < kThreads ? nvec : kThreads;
  block = dim3(tx, kThreads / tx);
  ctiles = (nvec + tx - 1) / tx;
  units = ctiles * splits;
  return true;
}

template <typename T, int V, bool kBwd>
cudaError_t split_stats(const T* dy, const T* x, const float* shift,
                        const float* mean, const float* var, float* work,
                        float* out, int64_t rows, int C, int splits,
                        float eps, cudaStream_t stream) {
  SplitArgs<T> a;
  dim3 block;
  if (!split_shape(rows, C, V, splits, block, a.ctiles, a.units))
    return cudaErrorInvalidValue;
  a.x = x;
  a.dy = dy;
  a.shift = shift;
  a.mean = mean;
  a.var = var;
  a.part = work;
  a.rows = rows;
  a.C = C;
  a.eps = eps;
  bn_split_sums_kernel<T, V, kBwd><<<a.units, block, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_split_reduce_kernel<<<(C + 255) / 256, 256, 0, stream>>>(work, out, C,
                                                             splits);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t split_fwd_apply(const T* x, T* y, const float* gamma,
                            const float* beta, const float* sums,
                            const float* shift, float* mean, float* var,
                            int64_t rows, int64_t n, int C, int splits,
                            float eps, cudaStream_t stream) {
  SplitFwdApply<T> a;
  dim3 block;
  if (!split_shape(rows, C, V, splits, block, a.ctiles, a.units) || n < rows)
    return cudaErrorInvalidValue;
  a.x = x;
  a.y = y;
  a.gamma = gamma;
  a.beta = beta;
  a.sums = sums;
  a.shift = shift;
  a.mean = mean;
  a.var = var;
  a.rows = rows;
  a.n = n;
  a.C = C;
  a.eps = eps;
  bn_split_fwd_apply_kernel<T, V><<<a.units, block, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t split_bwd_apply(const T* dy, const T* x, const float* gamma,
                            const float* mean, const float* var,
                            const float* sums, T* dx, int64_t rows, int64_t n,
                            int C, int splits, float eps,
                            cudaStream_t stream) {
  SplitBwdApply<T> a;
  dim3 block;
  if (!split_shape(rows, C, V, splits, block, a.ctiles, a.units) || n < rows)
    return cudaErrorInvalidValue;
  a.dy = dy;
  a.x = x;
  a.gamma = gamma;
  a.mean = mean;
  a.var = var;
  a.sums = sums;
  a.dx = dx;
  a.rows = rows;
  a.n = n;
  a.C = C;
  a.eps = eps;
  bn_split_bwd_apply_kernel<T, V><<<a.units, block, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes.  x, y, dy, dx: contiguous [rows,
// C] of the entry's dtype; gamma, beta, mean, var, dmean, dvar: f32 [C];
// work: f32 [2 C + 2 splits C + 4 C + 1]: the forward's mean and var (the
// backward's dgamma and dbeta), the partials, the per-channel scalars, the
// barrier's counter, where splits = ceil(max(blocks, ctiles) / ctiles) and
// ctiles = ceil((C / v) / min(C / v, 512)) for v the vector width.
// `blocks` is the grid (at most what the card holds resident), `keep` the
// rows of each block kept in shared memory (0 unless `vec`, and unless
// every block owns one unit).
// `vec` != 0 takes 16-byte vectors of channels (C a multiple of 8 for
// bf16, 4 for f32, every map pointer 16-byte aligned); 0 one channel a
// thread.  Zero the counter and launch one cooperative kernel on `stream`;
// do not synchronise, allocate nothing; return the first failure's
// cudaError_t (0 on success).
#define FUSED_BN_ENTRIES(SUFFIX, T, V)                                        \
  extern "C" int fused_bn_fwd_##SUFFIX(                                       \
      const void* x, void* y, const void* gamma, const void* beta,            \
      void* work, long long rows, int C, int blocks, int keep, int vec,       \
      float eps, void* stream) {                                              \
    auto s = static_cast<cudaStream_t>(stream);                               \
    auto args = [&](auto v) {                                                 \
      return fwd<T, decltype(v)::value>(                                      \
          static_cast<const T*>(x), static_cast<T*>(y),                       \
          static_cast<const float*>(gamma), static_cast<const float*>(beta),  \
          static_cast<float*>(work), rows, C, blocks, keep, eps, s);          \
    };                                                                        \
    return vec ? args(std::integral_constant<int, V>())                       \
               : args(std::integral_constant<int, 1>());                      \
  }                                                                           \
  extern "C" int fused_bn_bwd_##SUFFIX(                                       \
      const void* dy, const void* x, const void* gamma, const void* mean,     \
      const void* var, const void* dmean, const void* dvar, void* dx,         \
      void* work, long long rows, int C, int blocks, int keep, int vec,       \
      float eps, void* stream) {                                              \
    auto s = static_cast<cudaStream_t>(stream);                               \
    auto args = [&](auto v) {                                                 \
      return bwd<T, decltype(v)::value>(                                      \
          static_cast<const T*>(dy), static_cast<const T*>(x),                \
          static_cast<const float*>(gamma), static_cast<const float*>(mean),  \
          static_cast<const float*>(var), static_cast<const float*>(dmean),   \
          static_cast<const float*>(dvar), static_cast<T*>(dx),               \
          static_cast<float*>(work), rows, C, blocks, keep, eps, s);          \
    };                                                                        \
    return vec ? args(std::integral_constant<int, V>())                       \
               : args(std::integral_constant<int, 1>());                      \
  }

FUSED_BN_ENTRIES(f32, float, 4)
FUSED_BN_ENTRIES(bf16, __nv_bfloat16, 8)

// The split form's entry pairs (see "the split form" above).  x, dy, y, dx:
// contiguous [rows, C] of the entry's dtype; shift, gamma, beta, mean, var:
// f32 [C]; work: f32 [splits][2][C]; out: f32 [2][C] (the local sums);
// sums: f32 [2][C] (forward) or [4][C] (backward: s1, s2, dmean, dvar),
// summed over every process; n: the global rows.  `splits` row ranges a
// channel tile; `vec` as above.  Each launches on `stream`, does not
// synchronise and allocates nothing; returns the first failure's
// cudaError_t (0 on success).
#define FUSED_BN_SPLIT_ENTRIES(SUFFIX, T, V)                                  \
  extern "C" int fused_bn_split_fwd_stats_##SUFFIX(                           \
      const void* x, const void* shift, void* work, void* out,                \
      long long rows, int C, int splits, int vec, void* stream) {             \
    auto s = static_cast<cudaStream_t>(stream);                               \
    auto run = [&](auto v) {                                                  \
      return split_stats<T, decltype(v)::value, false>(                       \
          nullptr, static_cast<const T*>(x),                                  \
          static_cast<const float*>(shift), nullptr, nullptr,                 \
          static_cast<float*>(work), static_cast<float*>(out), rows, C,       \
          splits, 0.f, s);                                                    \
    };                                                                        \
    return vec ? run(std::integral_constant<int, V>())                        \
               : run(std::integral_constant<int, 1>());                       \
  }                                                                           \
  extern "C" int fused_bn_split_fwd_apply_##SUFFIX(                           \
      const void* x, void* y, const void* gamma, const void* beta,            \
      const void* sums, const void* shift, void* mean, void* var,             \
      long long rows, long long n, int C, int splits, int vec, float eps,     \
      void* stream) {                                                         \
    auto s = static_cast<cudaStream_t>(stream);                               \
    auto run = [&](auto v) {                                                  \
      return split_fwd_apply<T, decltype(v)::value>(                          \
          static_cast<const T*>(x), static_cast<T*>(y),                       \
          static_cast<const float*>(gamma), static_cast<const float*>(beta),  \
          static_cast<const float*>(sums), static_cast<const float*>(shift),  \
          static_cast<float*>(mean), static_cast<float*>(var), rows, n, C,    \
          splits, eps, s);                                                    \
    };                                                                        \
    return vec ? run(std::integral_constant<int, V>())                        \
               : run(std::integral_constant<int, 1>());                       \
  }                                                                           \
  extern "C" int fused_bn_split_bwd_stats_##SUFFIX(                           \
      const void* dy, const void* x, const void* mean, const void* var,       \
      void* work, void* out, long long rows, int C, int splits, int vec,      \
      float eps, void* stream) {                                              \
    auto s = static_cast<cudaStream_t>(stream);                               \
    auto run = [&](auto v) {                                                  \
      return split_stats<T, decltype(v)::value, true>(                        \
          static_cast<const T*>(dy), static_cast<const T*>(x), nullptr,       \
          static_cast<const float*>(mean), static_cast<const float*>(var),    \
          static_cast<float*>(work), static_cast<float*>(out), rows, C,       \
          splits, eps, s);                                                    \
    };                                                                        \
    return vec ? run(std::integral_constant<int, V>())                        \
               : run(std::integral_constant<int, 1>());                       \
  }                                                                           \
  extern "C" int fused_bn_split_bwd_apply_##SUFFIX(                           \
      const void* dy, const void* x, const void* gamma, const void* mean,     \
      const void* var, const void* sums, void* dx, long long rows,            \
      long long n, int C, int splits, int vec, float eps, void* stream) {     \
    auto s = static_cast<cudaStream_t>(stream);                               \
    auto run = [&](auto v) {                                                  \
      return split_bwd_apply<T, decltype(v)::value>(                          \
          static_cast<const T*>(dy), static_cast<const T*>(x),                \
          static_cast<const float*>(gamma), static_cast<const float*>(mean),  \
          static_cast<const float*>(var), static_cast<const float*>(sums),    \
          static_cast<T*>(dx), rows, n, C, splits, eps, s);                   \
    };                                                                        \
    return vec ? run(std::integral_constant<int, V>())                        \
               : run(std::integral_constant<int, 1>());                       \
  }

FUSED_BN_SPLIT_ENTRIES(f32, float, 4)
FUSED_BN_SPLIT_ENTRIES(bf16, __nv_bfloat16, 8)

#ifdef FUSED_BN_TRACE
extern "C" int fused_bn_trace(void* out) {
  return cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
#endif

extern "C" const char* fused_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
