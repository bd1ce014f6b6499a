// Flash-attention backward for Hopper (sm_90a): float32 and bfloat16 inputs,
// f32 accumulation throughout.
//
// Replaces analytics_zoo_tpu/ops/flash_attention.py::_blocked_bwd_jax (the
// backward of the JAX package's flash-attention custom_vjp, reached through
// _flash_vjp_bwd).  For q, k, v, out, dout laid out [BH, T, d] and
// contiguous, lse [BH, Tq] f32 from the forward:
//   delta_i = sum_c out[i, c] * dout[i, c]                         (f32)
//   P_ij    = exp(scale * q_i . k_j - lse_i), 0 where masked
//   dS_ij   = P_ij * (dout_i . v_j - delta_i) * scale
//   dq_i = sum_j dS_ij k_j    dk_j = sum_i dS_ij q_i    dv_j = sum_i P_ij dout_i
// with key positions >= Tk masked and, under `causal`, q < k masked
// (absolute positions, so Tq != Tk works).  Masked logits are -1e30 in the
// JAX math, so their P is exactly 0; here they are never exponentiated.
// Gradients are written in the input dtype.
//
// What bounds it.  About 10 * BH * Tq * Tk * d FLOP (the five products of
// the FA2 backward; this design recomputes S and dP once more in the dQ
// pass) against q, k, v, out, dout read once and dq, dk, dv written once:
// at BERT-base training (BH 384, T 512, d 64) some 640 FLOP per byte in
// bf16, far above the H100's ridge, so it is bound by operations.
//
// Design (the FA2 split, three launches on one stream, no atomics, so two
// identical steps give identical gradients):
//   1. delta: one warp per query row.
//   2. dK/dV: one block per (key tile, bh), looping over the q tiles that
//      can see it (under `causal`, from the tile holding the diagonal): the
//      block's K and V are staged once, each q tile's Q and dO in turn, and
//      dK and dV accumulate in registers.
//   3. dQ: one block per (q tile, bh), looping over key tiles (under
//      `causal`, up to the diagonal): Q and dO staged once, K and V per
//      tile, dQ in registers.
// Three designs share that structure:
//   * bf16 with head widths up to 64 (d a multiple of 8; the wrapper pads
//     others), BERT's path: the tensor cores.  mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate) in blocks of 4 warps; each warp owns 16 keys (dK/dV)
//     or 16 q rows (dQ) of a 64 x 64 tile.  S^T = K Q^T and dP^T = V dO^T
//     (dK/dV) or S = Q K^T and dP = dO V^T (dQ) take the warp's K and V (or
//     Q and dO) A-fragments from registers, loaded once, and the other side
//     by ldmatrix; P and dS are computed on the f32 accumulator fragments
//     (2^x by ex2.approx with scale * log2(e) folded in), rounded to bf16
//     in place and fed straight back as the A operand of dV += P^T dO,
//     dK += dS^T Q or dQ += dS K, whose B operands come by ldmatrix.trans
//     (the fragment layouts are in warp_mma.cuh).  The streamed 64-row
//     tiles are double-buffered by cp.async 16-byte copies; rows >= T and
//     columns >= d are zero-filled by the copy.
//   * f32, and bf16 wider than 64, up to 256: scalar f32 FMAs from shared
//     memory (tiles transposed, f32), 256 threads in a 16 x 16 grid: in
//     dK/dV thread (ty, tx) owns keys ty*KR.. of S^T and dP^T and columns
//     tx + 16 j of dK and dV; dQ mirrors the forward's f32 kernel, with dS
//     through shared memory.  Tiles 64 x 64 up to d 128 and 32 x 32 at
//     d 256; loads are element-wise, so any d works.
//   * head dims 257..1024: the wide kernels, 16 x 16 tiles, the head dim
//     staged in chunks of 64 columns, each block owning a chunk of 256
//     output columns (S and dP are recomputed once per chunk).
// Kernels are instantiated for padded widths and take the true d at run
// time.  What it leaves: wgmma with a TMA-fed ring, and tensor cores for
// bf16 heads wider than 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;  // 16 x 16 thread grid

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(out * dout), one warp per row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ delta, int64_t rows, int d) {
  const int64_t row = int64_t(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * d;
  const T* g = dout + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(to_f(o[c]), to_f(g[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// 2. dK / dV, head widths up to 256
// ---------------------------------------------------------------------------

template <int D, int BK, int BQ>
struct DkdvLayout {
  static constexpr int KS = BK + 4;  // Kt / Vt / Ps / dSs row stride
  static constexpr int QS = BQ + 1;  // Qt / dOt row stride (odd: no conflicts)
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * size_t(D) * KS    // Kt, Vt  [D][KS]
                       + 2 * size_t(D) * QS  // Qt, dOt [D][QS]
                       + 2 * size_t(BQ) * KS // Ps, dSs [BQ][KS]
                       + 2 * size_t(BQ));    // lse, delta
};

template <typename T, int D, int BK, int BQ>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, int d,
                int n_ktiles, float scale, int causal) {
  using L = DkdvLayout<D, BK, BQ>;
  constexpr int KS = L::KS, QS = L::QS;
  constexpr int KR = BK / 16;  // keys per thread
  constexpr int QR = BQ / 16;  // q rows per thread in S^T / dP^T
  constexpr int DJ = D / 16;   // output columns per thread
  static_assert(BK % 16 == 0 && BQ % 16 == 0 && D % 16 == 0, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;              // [D][KS]
  float* Vt = Kt + D * KS;       // [D][KS]
  float* Qt = Vt + D * KS;       // [D][QS]
  float* dOt = Qt + D * QS;      // [D][QS]
  float* Ps = dOt + D * QS;      // [BQ][KS]: P^T as [row][key]
  float* dSs = Ps + BQ * KS;     // [BQ][KS]
  float* lse_s = dSs + BQ * KS;  // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]

  const int64_t bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * BK;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const T* qb = q + bh * tq * d;
  const T* gb = dout + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  const float* lb = lse + bh * tq;
  const float* db = delta + bh * tq;

  for (int idx = tid; idx < BK * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const bool in = k0 + r < tk && c < d;
    const int64_t off = int64_t(k0 + r) * d + c;
    Kt[c * KS + r] = in ? to_f(kb[off]) : 0.f;
    Vt[c * KS + r] = in ? to_f(vb[off]) : 0.f;
  }

  float acc_k[KR][DJ], acc_v[KR][DJ];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // rows before k0 see no key of this tile under `causal`
  const int qstart = causal ? (min(k0, tq) / BQ) * BQ : 0;
  for (int q0 = qstart; q0 < tq; q0 += BQ) {
    __syncthreads();  // previous q tile fully consumed (and Kt, Vt written)
    for (int idx = tid; idx < BQ * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool in = q0 + r < tq && c < d;
      const int64_t off = int64_t(q0 + r) * d + c;
      Qt[c * QS + r] = in ? to_f(qb[off]) : 0.f;
      dOt[c * QS + r] = in ? to_f(gb[off]) : 0.f;
    }
    for (int r = tid; r < BQ; r += kThreads) {
      const bool in = q0 + r < tq;
      lse_s[r] = in ? lb[q0 + r] : 0.f;
      delta_s[r] = in ? db[q0 + r] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for keys ty*KR.. x rows tx + 16 j
    float s[KR][QR], dp[KR][QR];
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < QR; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float kv[KR], vv[KR], qv[QR], gv[QR];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        kv[i] = Kt[c * KS + ty * KR + i];
        vv[i] = Vt[c * KS + ty * KR + i];
      }
#pragma unroll
      for (int j = 0; j < QR; ++j) {
        qv[j] = Qt[c * QS + tx + 16 * j];
        gv[j] = dOt[c * QS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int j = 0; j < QR; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < QR; ++j) {
        const int key = k0 + ty * KR + i;
        const int rl = tx + 16 * j;
        const int row = q0 + rl;
        const bool keep = key < tk && row < tq && (!causal || row >= key);
        const float p = keep ? expf(fmaf(s[i][j], scale, -lse_s[rl])) : 0.f;
        Ps[rl * KS + ty * KR + i] = p;
        dSs[rl * KS + ty * KR + i] = p * (dp[i][j] - delta_s[rl]) * scale;
      }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over this tile's rows
    const int rn = min(BQ, tq - q0);
#pragma unroll 2
    for (int r = 0; r < rn; ++r) {
      float pv[KR], sv[KR];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        pv[i] = Ps[r * KS + ty * KR + i];
        sv[i] = dSs[r * KS + ty * KR + i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float g = dOt[(tx + 16 * j) * QS + r];
        const float qq = Qt[(tx + 16 * j) * QS + r];
#pragma unroll
        for (int i = 0; i < KR; ++i) {
          acc_v[i][j] = fmaf(pv[i], g, acc_v[i][j]);
          acc_k[i][j] = fmaf(sv[i], qq, acc_k[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int key = k0 + ty * KR + i;
    if (key >= tk) continue;
    T* krow = dk + (bh * tk + key) * d;
    T* vrow = dv + (bh * tk + key) * d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        krow[c] = from_f<T>(acc_k[i][j]);
        vrow[c] = from_f<T>(acc_v[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ, head widths up to 256
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
struct DqLayout {
  static constexpr int QS = BQ + 4;  // Qt / dOt / dSs row stride
  static constexpr int KS = BK + 1;  // Kt / Vt row stride (odd: no conflicts)
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * size_t(D) * QS    // Qt, dOt [D][QS]
                       + 2 * size_t(D) * KS  // Kt, Vt  [D][KS]
                       + size_t(BK) * QS);   // dSs [BK][QS]: dS^T
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int tq, int tk, int d, int n_qtiles,
              float scale, int causal) {
  using L = DqLayout<D, BQ, BK>;
  constexpr int QS = L::QS, KS = L::KS;
  constexpr int QR = BQ / 16;  // q rows per thread
  constexpr int KJ = BK / 16;  // keys per thread in S / dP
  constexpr int DJ = D / 16;   // output columns per thread
  static_assert(BK % 16 == 0 && BQ % 16 == 0 && D % 16 == 0, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;           // [D][QS]
  float* dOt = Qt + D * QS;   // [D][QS]
  float* Kt = dOt + D * QS;   // [D][KS]
  float* Vt = Kt + D * KS;    // [D][KS]
  float* dSs = Vt + D * KS;   // [BK][QS]

  const int64_t bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const T* qb = q + bh * tq * d;
  const T* gb = dout + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const bool in = q0 + r < tq && c < d;
    const int64_t off = int64_t(q0 + r) * d + c;
    Qt[c * QS + r] = in ? to_f(qb[off]) : 0.f;
    dOt[c * QS + r] = in ? to_f(gb[off]) : 0.f;
  }
  float lse_r[QR], delta_r[QR], acc[QR][DJ];
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int row = q0 + ty * QR + i;
    lse_r[i] = row < tq ? lse[bh * tq + row] : 0.f;
    delta_r[i] = row < tq ? delta[bh * tq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // keys past the last q row of this tile are all masked under `causal`
  const int kend = causal ? min(tk, q0 + BQ) : tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and Qt, dOt written)
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < tk && c < d;
      const int64_t off = int64_t(k0 + r) * d + c;
      Kt[c * KS + r] = in ? to_f(kb[off]) : 0.f;
      Vt[c * KS + r] = in ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[QR][KJ], dp[QR][KJ];
#pragma unroll
    for (int i = 0; i < QR; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[QR], gv[QR], kv[KJ], vv[KJ];
#pragma unroll
      for (int i = 0; i < QR; ++i) {
        qv[i] = Qt[c * QS + ty * QR + i];
        gv[i] = dOt[c * QS + ty * QR + i];
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        kv[j] = Kt[c * KS + tx + 16 * j];
        vv[j] = Vt[c * KS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < QR; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < QR; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int row = q0 + ty * QR + i;
        const int key = k0 + tx + 16 * j;
        const bool keep = key < tk && row < tq && (!causal || row >= key);
        const float p = keep ? expf(fmaf(s[i][j], scale, -lse_r[i])) : 0.f;
        dSs[(tx + 16 * j) * QS + ty * QR + i] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    __syncthreads();

    const int kn = min(BK, tk - k0);  // masked keys have dS == 0
#pragma unroll 2
    for (int kk = 0; kk < kn; ++kk) {
      float sv[QR];
#pragma unroll
      for (int i = 0; i < QR; ++i) sv[i] = dSs[kk * QS + ty * QR + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk_c = Kt[(tx + 16 * j) * KS + kk];
#pragma unroll
        for (int i = 0; i < QR; ++i) acc[i][j] = fmaf(sv[i], kk_c, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int row = q0 + ty * QR + i;
    if (row >= tq) continue;
    T* qrow = dq + (bh * tq + row) * d;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (tx + 16 * j < d) qrow[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// Wide head dims (257..1024): 16 x 16 tiles, head dim staged in chunks
// ---------------------------------------------------------------------------

constexpr int kWT = 16;          // q rows and keys per wide tile
constexpr int kWChunk = 64;      // head-dim columns staged at a time
constexpr int kWCols = kThreads; // output columns per block
constexpr int kWS = kWChunk + 1; // staged row stride (odd: no conflicts)

struct WideSmem {
  float a[kWT][kWS], b[kWT][kWS], c[kWT][kWS], e[kWT][kWS];
  float p[kWT][kWT + 1], ds[kWT][kWT + 1];
  float lse[kWT], delta[kWT];
};

// S and dP for the (16 q rows from q0) x (16 keys from k0) tile over the
// whole head dim: thread (a = tid / 16, b = tid % 16) returns row a, key b.
// Rows or keys out of range read zeros.
template <typename T>
__device__ __forceinline__ void wide_s_dp(WideSmem& sm, const T* qb,
                                          const T* gb, const T* kb,
                                          const T* vb, int q0, int k0,
                                          int tq, int tk, int d, float& s,
                                          float& dp) {
  const int tid = threadIdx.x;
  const int a = tid >> 4, b = tid & 15;
  s = dp = 0.f;
  for (int c0 = 0; c0 < d; c0 += kWChunk) {
    __syncthreads();  // previous chunk consumed
    for (int idx = tid; idx < kWT * kWChunk; idx += kThreads) {
      const int r = idx / kWChunk, c = idx % kWChunk;
      const bool cin = c0 + c < d;
      const bool qin = cin && q0 + r < tq, kin = cin && k0 + r < tk;
      const int64_t qo = int64_t(q0 + r) * d + c0 + c;
      const int64_t ko = int64_t(k0 + r) * d + c0 + c;
      sm.a[r][c] = qin ? to_f(qb[qo]) : 0.f;
      sm.b[r][c] = qin ? to_f(gb[qo]) : 0.f;
      sm.c[r][c] = kin ? to_f(kb[ko]) : 0.f;
      sm.e[r][c] = kin ? to_f(vb[ko]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kWChunk; ++c) {
      s = fmaf(sm.a[a][c], sm.c[b][c], s);
      dp = fmaf(sm.b[a][c], sm.e[b][c], dp);
    }
  }
}

// P and dS of one tile into shared memory (synchronised for the caller).
__device__ __forceinline__ void wide_p_ds(WideSmem& sm, float s, float dp,
                                          int q0, int k0, int tq, int tk,
                                          float scale, int causal) {
  const int tid = threadIdx.x;
  const int a = tid >> 4, b = tid & 15;
  const int row = q0 + a, key = k0 + b;
  const bool keep = key < tk && row < tq && (!causal || row >= key);
  const float p = keep ? expf(fmaf(s, scale, -sm.lse[a])) : 0.f;
  sm.p[a][b] = p;
  sm.ds[a][b] = p * (dp - sm.delta[a]) * scale;
  __syncthreads();
}

__device__ __forceinline__ void wide_row_stats(WideSmem& sm,
                                               const float* lb,
                                               const float* db, int q0,
                                               int tq) {
  const int tid = threadIdx.x;
  if (tid < kWT) {
    const bool in = q0 + tid < tq;
    sm.lse[tid] = in ? lb[q0 + tid] : 0.f;
    sm.delta[tid] = in ? db[q0 + tid] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int tq, int tk, int d, int n_ktiles,
                     int n_chunks, float scale, int causal) {
  __shared__ WideSmem sm;
  const int64_t bh = blockIdx.x / (int64_t(n_ktiles) * n_chunks);
  const int rest = blockIdx.x % (n_ktiles * n_chunks);
  const int k0 = (rest / n_chunks) * kWT;
  const int col = (rest % n_chunks) * kWCols + threadIdx.x;
  const T* qb = q + bh * tq * d;
  const T* gb = dout + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;

  float acc_k[kWT], acc_v[kWT];
#pragma unroll
  for (int i = 0; i < kWT; ++i) acc_k[i] = acc_v[i] = 0.f;

  const int qstart = causal ? (min(k0, tq) / kWT) * kWT : 0;
  for (int q0 = qstart; q0 < tq; q0 += kWT) {
    float s, dp;
    wide_row_stats(sm, lse + bh * tq, delta + bh * tq, q0, tq);
    wide_s_dp(sm, qb, gb, kb, vb, q0, k0, tq, tk, d, s, dp);
    wide_p_ds(sm, s, dp, q0, k0, tq, tk, scale, causal);
    if (col < d) {
      const int rn = min(kWT, tq - q0);
      for (int r = 0; r < rn; ++r) {
        const int64_t off = int64_t(q0 + r) * d + col;
        const float g = to_f(gb[off]), qq = to_f(qb[off]);
#pragma unroll
        for (int i = 0; i < kWT; ++i) {
          acc_v[i] = fmaf(sm.p[r][i], g, acc_v[i]);
          acc_k[i] = fmaf(sm.ds[r][i], qq, acc_k[i]);
        }
      }
    }
  }
  if (col < d) {
#pragma unroll
    for (int i = 0; i < kWT; ++i) {
      const int key = k0 + i;
      if (key < tk) {
        dk[(bh * tk + key) * d + col] = from_f<T>(acc_k[i]);
        dv[(bh * tk + key) * d + col] = from_f<T>(acc_v[i]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int tq, int tk, int d, int n_qtiles, int n_chunks,
                   float scale, int causal) {
  __shared__ WideSmem sm;
  const int64_t bh = blockIdx.x / (int64_t(n_qtiles) * n_chunks);
  const int rest = blockIdx.x % (n_qtiles * n_chunks);
  const int q0 = (rest / n_chunks) * kWT;
  const int col = (rest % n_chunks) * kWCols + threadIdx.x;
  const T* qb = q + bh * tq * d;
  const T* gb = dout + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;

  float acc[kWT];
#pragma unroll
  for (int i = 0; i < kWT; ++i) acc[i] = 0.f;
  wide_row_stats(sm, lse + bh * tq, delta + bh * tq, q0, tq);

  const int kend = causal ? min(tk, q0 + kWT) : tk;
  for (int k0 = 0; k0 < kend; k0 += kWT) {
    float s, dp;
    wide_s_dp(sm, qb, gb, kb, vb, q0, k0, tq, tk, d, s, dp);
    wide_p_ds(sm, s, dp, q0, k0, tq, tk, scale, causal);
    if (col < d) {
      const int kn = min(kWT, tk - k0);
      for (int j = 0; j < kn; ++j) {
        const float kc = to_f(kb[int64_t(k0 + j) * d + col]);
#pragma unroll
        for (int i = 0; i < kWT; ++i) acc[i] = fmaf(sm.ds[i][j], kc, acc[i]);
      }
    }
    // the next tile's staging overwrites sm.ds only after wide_s_dp's
    // first __syncthreads, which every thread reaches after this loop
  }
  if (col < d) {
#pragma unroll
    for (int i = 0; i < kWT; ++i)
      if (q0 + i < tq) dq[(bh * tq + q0 + i) * d + col] = from_f<T>(acc[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores, head widths up to 64
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaTile = 64;      // q rows and keys per tile
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct MmaLayout {
  static constexpr int S = DP + 8;  // bf16 per shared row (+16 bytes)
  static constexpr int kTile = kMmaTile * S;
  // six 64-row tiles (dK/dV: K, V, then Q and dO in two stages; dQ: Q, dO,
  // then K and V in two stages) and two stages of 64 lse and delta values
  static constexpr size_t kSmemBytes =
      6 * size_t(kTile) * sizeof(bf16) + 4 * kMmaTile * sizeof(float);
};

// Rows [row0, row0 + 64) and columns [0, DP) of a [nrows, d] bf16 matrix
// into a shared tile; rows >= nrows and columns >= d are zero-filled.
template <int DP>
__device__ __forceinline__ void mma_load_tile(bf16* tile, const bf16* g,
                                              int row0, int nrows, int d,
                                              int tid) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  constexpr int kPerThread = kMmaTile * kChunks / kMmaThreads;
  static_assert(kMmaTile * kChunks % kMmaThreads == 0,
                "DP must be a multiple of 16");
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = tid + i * kMmaThreads;
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < nrows && col < d;
    const bf16* src = ok ? g + int64_t(row0 + r) * d + col : g;
    warp_mma::cp_async_16(tile + r * MmaLayout<DP>::S + col, src, ok);
  }
}

// The A fragment of one k16 step from the f32 C fragments of two adjacent
// n8 tiles, rounded to bf16 (see warp_mma.cuh).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = warp_mma::pack_bf16(c0[0], c0[1]);
  a[1] = warp_mma::pack_bf16(c0[2], c0[3]);
  a[2] = warp_mma::pack_bf16(c1[0], c1[1]);
  a[3] = warp_mma::pack_bf16(c1[2], c1[3]);
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int tq, int tk, int d,
                    int n_ktiles, float scale, int causal) {
  using namespace warp_mma;
  using L = MmaLayout<DP>;
  constexpr int S = L::S;
  constexpr int KD = DP / 16;        // k16 steps over the head dim
  constexpr int ND = DP / 8;         // n8 tiles over the head dim
  constexpr int NQ = kMmaTile / 8;   // n8 tiles over a q tile

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + L::kTile;
  bf16* Qs = Vs + L::kTile;       // two stages
  bf16* Gs = Qs + 2 * L::kTile;   // two stages (dO)
  float* lse_s = reinterpret_cast<float*>(Gs + 2 * L::kTile);  // x log2(e)
  float* delta_s = lse_s + 2 * kMmaTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * kMmaTile;
  const int key_w = warp * 16;  // this warp's first key in the tile
  const bf16* qb = q + bh * tq * d;
  const bf16* gb = dout + bh * tq * d;
  const bf16* kb = k + bh * tk * d;
  const bf16* vb = v + bh * tk * d;
  const float* lb = lse + bh * tq;
  const float* db = delta + bh * tq;
  const float scale_log2 = scale * kLog2e;

  // rows before k0 see no key of this tile under `causal`
  const int qstart = causal ? (min(k0, tq) / kMmaTile) * kMmaTile : 0;
  const int n_qt = (tq - qstart + kMmaTile - 1) / kMmaTile;
  auto stage_rows = [&](int st, int q0) {
    if (tid < kMmaTile) {
      const bool in = q0 + tid < tq;
      lse_s[st * kMmaTile + tid] = in ? lb[q0 + tid] * kLog2e : 0.f;
      delta_s[st * kMmaTile + tid] = in ? db[q0 + tid] : 0.f;
    }
  };

  mma_load_tile<DP>(Ks, kb, k0, tk, d, tid);
  mma_load_tile<DP>(Vs, vb, k0, tk, d, tid);
  if (n_qt > 0) {
    mma_load_tile<DP>(Qs, qb, qstart, tq, d, tid);
    mma_load_tile<DP>(Gs, gb, qstart, tq, d, tid);
    stage_rows(0, qstart);
  }
  cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;
  uint32_t kf[KD][4], vf[KD][4];
  // lane offsets of ldmatrix: A from row-major rows, B from row-major
  // [n][k] rows, and B transposed from row-major [k][n] rows
  const int a_off = (key_w + (lane & 15)) * S + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * S +
                    ((lane >> 3) & 1) * 8;
  const int bt_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * S +
                     (lane >> 4) * 8;

  for (int j = 0; j < n_qt; ++j) {
    const int st = j & 1;
    const int q0 = qstart + j * kMmaTile;
    if (j + 1 < n_qt) {
      mma_load_tile<DP>(Qs + (st ^ 1) * L::kTile, qb, q0 + kMmaTile, tq, d,
                        tid);
      mma_load_tile<DP>(Gs + (st ^ 1) * L::kTile, gb, q0 + kMmaTile, tq, d,
                        tid);
      stage_rows(st ^ 1, q0 + kMmaTile);
      cp_async_commit();
      cp_async_wait<1>();  // everything but q tile j + 1 has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... for every thread's copies
    if (j == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        ldmatrix_x4(kf[kd], Ks + a_off + kd * 16);
        ldmatrix_x4(vf[kd], Vs + a_off + kd * 16);
      }
    }
    const bf16* Qt = Qs + st * L::kTile;
    const bf16* Gt = Gs + st * L::kTile;
    const float* l2 = lse_s + st * kMmaTile;
    const float* dl = delta_s + st * kMmaTile;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 64 rows
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int nb = 0; nb < NQ / 2; ++nb) {
        uint32_t b[4];
        ldmatrix_x4(b, Qt + nb * 16 * S + b_off + kd * 16);
        mma_bf16_16816(s[2 * nb], kf[kd], b[0], b[1]);
        mma_bf16_16816(s[2 * nb + 1], kf[kd], b[2], b[3]);
        ldmatrix_x4(b, Gt + nb * 16 * S + b_off + kd * 16);
        mma_bf16_16816(dp[2 * nb], vf[kd], b[0], b[1]);
        mma_bf16_16816(dp[2 * nb + 1], vf[kd], b[2], b[3]);
      }
    }
    // P^T and dS^T in place (q rows run along the n dimension here)
#pragma unroll
    for (int jn = 0; jn < NQ; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + key_w + g + (e >> 1) * 8;
        const int rl = jn * 8 + 2 * t + (e & 1);
        const int row = q0 + rl;
        const bool keep = key < tk && row < tq && (!causal || row >= key);
        const float p =
            keep ? exp2_approx(fmaf(s[jn][e], scale_log2, -l2[rl])) : 0.f;
        s[jn][e] = p;
        dp[jn][e] = p * (dp[jn][e] - dl[rl]) * scale;
      }
    // dV += P^T dO, dK += dS^T Q over the tile's 64 rows
#pragma unroll
    for (int kk = 0; kk < kMmaTile / 16; ++kk) {
      uint32_t ap[4], as[4];
      c_to_a(ap, s[2 * kk], s[2 * kk + 1]);
      c_to_a(as, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < ND / 2; ++dd) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Gt + kk * 16 * S + bt_off + dd * 16);
        mma_bf16_16816(acc_v[2 * dd], ap, b[0], b[1]);
        mma_bf16_16816(acc_v[2 * dd + 1], ap, b[2], b[3]);
        ldmatrix_x4_trans(b, Qt + kk * 16 * S + bt_off + dd * 16);
        mma_bf16_16816(acc_k[2 * dd], as, b[0], b[1]);
        mma_bf16_16816(acc_k[2 * dd + 1], as, b[2], b[3]);
      }
    }
    __syncthreads();  // stage st fully read before q tile j + 2 lands in it
  }
  cp_async_wait<0>();  // no copy outlives the block (none ran if n_qt == 0)

#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + key_w + g + 8 * r;
      const int col = nd * 8 + 2 * t;
      if (key < tk && col < d) {
        const int64_t off = (bh * tk + key) * d + col;
        *reinterpret_cast<uint32_t*>(dk + off) =
            pack_bf16(acc_k[nd][2 * r], acc_k[nd][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + off) =
            pack_bf16(acc_v[nd][2 * r], acc_v[nd][2 * r + 1]);
      }
    }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int tq, int tk, int d, int n_qtiles, float scale,
                  int causal) {
  using namespace warp_mma;
  using L = MmaLayout<DP>;
  constexpr int S = L::S;
  constexpr int KD = DP / 16;
  constexpr int ND = DP / 8;
  constexpr int NK = kMmaTile / 8;  // n8 tiles over a key tile

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + L::kTile;       // dO
  bf16* Ks = Gs + L::kTile;       // two stages
  bf16* Vs = Ks + 2 * L::kTile;   // two stages

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x / n_qtiles;
  // the last q tile (the longest under `causal`) is scheduled first
  const int q0 = (n_qtiles - 1 - blockIdx.x % n_qtiles) * kMmaTile;
  const int row_w = warp * 16;
  const bf16* qb = q + bh * tq * d;
  const bf16* gb = dout + bh * tq * d;
  const bf16* kb = k + bh * tk * d;
  const bf16* vb = v + bh * tk * d;
  const float scale_log2 = scale * kLog2e;

  // keys past the last q row of this tile are all masked under `causal`
  const int kend = causal ? min(tk, q0 + kMmaTile) : tk;
  const int n_tiles = (kend + kMmaTile - 1) / kMmaTile;

  mma_load_tile<DP>(Qs, qb, q0, tq, d, tid);
  mma_load_tile<DP>(Gs, gb, q0, tq, d, tid);
  mma_load_tile<DP>(Ks, kb, 0, tk, d, tid);
  mma_load_tile<DP>(Vs, vb, 0, tk, d, tid);
  cp_async_commit();

  float lse2_r[2], delta_r[2];  // rows g and g + 8 of the warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_w + g + 8 * r;
    lse2_r[r] = row < tq ? lse[bh * tq + row] * kLog2e : 0.f;
    delta_r[r] = row < tq ? delta[bh * tq + row] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  uint32_t qf[KD][4], gf[KD][4];
  const int a_off = (row_w + (lane & 15)) * S + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * S +
                    ((lane >> 3) & 1) * 8;
  const int bt_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * S +
                     (lane >> 4) * 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    const int k0 = j * kMmaTile;
    if (j + 1 < n_tiles) {
      mma_load_tile<DP>(Ks + (st ^ 1) * L::kTile, kb, k0 + kMmaTile, tk, d,
                        tid);
      mma_load_tile<DP>(Vs + (st ^ 1) * L::kTile, vb, k0 + kMmaTile, tk, d,
                        tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        ldmatrix_x4(qf[kd], Qs + a_off + kd * 16);
        ldmatrix_x4(gf[kd], Gs + a_off + kd * 16);
      }
    }
    const bf16* Kt = Ks + st * L::kTile;
    const bf16* Vt = Vs + st * L::kTile;

    // S = Q K^T and dP = dO V^T: the warp's 16 rows x 64 keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int nb = 0; nb < NK / 2; ++nb) {
        uint32_t b[4];
        ldmatrix_x4(b, Kt + nb * 16 * S + b_off + kd * 16);
        mma_bf16_16816(s[2 * nb], qf[kd], b[0], b[1]);
        mma_bf16_16816(s[2 * nb + 1], qf[kd], b[2], b[3]);
        ldmatrix_x4(b, Vt + nb * 16 * S + b_off + kd * 16);
        mma_bf16_16816(dp[2 * nb], gf[kd], b[0], b[1]);
        mma_bf16_16816(dp[2 * nb + 1], gf[kd], b[2], b[3]);
      }
    }
    // dS in place of dP
#pragma unroll
    for (int jn = 0; jn < NK; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + jn * 8 + 2 * t + (e & 1);
        const int row = q0 + row_w + g + (e >> 1) * 8;
        const bool keep = key < tk && row < tq && (!causal || row >= key);
        const float p = keep ? exp2_approx(fmaf(s[jn][e], scale_log2,
                                                -lse2_r[e >> 1]))
                             : 0.f;
        dp[jn][e] = p * (dp[jn][e] - delta_r[e >> 1]) * scale;
      }
    // dQ += dS K over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < kMmaTile / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < ND / 2; ++dd) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Kt + kk * 16 * S + bt_off + dd * 16);
        mma_bf16_16816(acc[2 * dd], a, b[0], b[1]);
        mma_bf16_16816(acc[2 * dd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // stage st fully read before key tile j + 2 lands
  }

#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row_w + g + 8 * r;
      const int col = nd * 8 + 2 * t;
      if (row < tq && col < d)
        *reinterpret_cast<uint32_t*>(dq + (bh * tq + row) * d + col) =
            pack_bf16(acc[nd][2 * r], acc[nd][2 * r + 1]);
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *out, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int bh, tq, tk, d, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int BT>
cudaError_t launch_small(const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const int n_ktiles = (a.tk + BT - 1) / BT;
  const int n_qtiles = (a.tq + BT - 1) / BT;
  if (int64_t(a.bh) * n_ktiles > INT32_MAX ||
      int64_t(a.bh) * n_qtiles > INT32_MAX)
    return cudaErrorInvalidValue;

  constexpr size_t kv_smem = DkdvLayout<D, BT, BT>::kSmemBytes;
  const auto dkdv = bwd_dkdv_kernel<T, D, BT, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kv_smem));
  if (err != cudaSuccess) return err;
  dkdv<<<a.bh * n_ktiles, kThreads, kv_smem, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.tq, a.tk, a.d, n_ktiles, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t q_smem = DqLayout<D, BT, BT>::kSmemBytes;
  const auto dqk = bwd_dq_kernel<T, D, BT, BT>;
  err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, int(q_smem));
  if (err != cudaSuccess) return err;
  dqk<<<a.bh * n_qtiles, kThreads, q_smem, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<T*>(a.dq), a.tq, a.tk, a.d,
      n_qtiles, a.scale, a.causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_mma(const Args& a) {
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* g = static_cast<const bf16*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const int n_ktiles = (a.tk + kMmaTile - 1) / kMmaTile;
  const int n_qtiles = (a.tq + kMmaTile - 1) / kMmaTile;
  if (int64_t(a.bh) * n_ktiles > INT32_MAX ||
      int64_t(a.bh) * n_qtiles > INT32_MAX)
    return cudaErrorInvalidValue;
  constexpr size_t smem = MmaLayout<DP>::kSmemBytes;
  const auto dkdv = bwd_dkdv_mma_kernel<DP>;
  const auto dqk = bwd_dq_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dkdv<<<a.bh * n_ktiles, kMmaThreads, smem, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.tq, a.tk, a.d, n_ktiles, a.scale,
      a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<a.bh * n_qtiles, kMmaThreads, smem, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<bf16*>(a.dq), a.tq, a.tk, a.d,
      n_qtiles, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const int n_chunks = (a.d + kWCols - 1) / kWCols;
  const int n_ktiles = (a.tk + kWT - 1) / kWT;
  const int n_qtiles = (a.tq + kWT - 1) / kWT;
  if (int64_t(a.bh) * n_ktiles * n_chunks > INT32_MAX ||
      int64_t(a.bh) * n_qtiles * n_chunks > INT32_MAX)
    return cudaErrorInvalidValue;
  bwd_dkdv_wide_kernel<T><<<a.bh * n_ktiles * n_chunks, kThreads, 0,
                            a.stream>>>(
      q, k, v, g, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.tq, a.tk, a.d, n_ktiles, n_chunks, a.scale, a.causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_wide_kernel<T><<<a.bh * n_qtiles * n_chunks, kThreads, 0,
                          a.stream>>>(
      q, k, v, g, lse, delta, static_cast<T*>(a.dq), a.tq, a.tk, a.d,
      n_qtiles, n_chunks, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a) {
  if (a.bh < 1 || a.tq < 1 || a.tk < 1 || a.d < 1 || a.d > 1024)
    return cudaErrorInvalidValue;
  const int64_t rows = int64_t(a.bh) * a.tq;
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  bwd_delta_kernel<T><<<int(blocks), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout),
      static_cast<float*>(a.delta), rows, a.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, bf16>::value) {
    if (a.d <= 64) {
      // the tensor cores take rows of whole 16-byte pieces, 16-byte
      // aligned (the wrapper pads d and copies a misaligned view)
      const uintptr_t addr =
          reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
          reinterpret_cast<uintptr_t>(a.v) |
          reinterpret_cast<uintptr_t>(a.dout) |
          reinterpret_cast<uintptr_t>(a.dq) |
          reinterpret_cast<uintptr_t>(a.dk) | reinterpret_cast<uintptr_t>(a.dv);
      if (a.d % 8 || addr % 16) return cudaErrorInvalidValue;
      if (a.d <= 16) return launch_mma<16>(a);
      if (a.d <= 32) return launch_mma<32>(a);
      return launch_mma<64>(a);
    }
  } else {  // f32 only: bf16 heads up to 64 took the tensor cores above
    if (a.d <= 16) return launch_small<T, 16, 64>(a);
    if (a.d <= 32) return launch_small<T, 32, 64>(a);
    if (a.d <= 64) return launch_small<T, 64, 64>(a);
  }
  if (a.d <= 128) return launch_small<T, 128, 64>(a);
  if (a.d <= 256) return launch_small<T, 256, 32>(a);
  return launch_wide<T>(a);
}

}  // namespace

// Plain C entry points, bound with ctypes.  Take any 1 <= d <= 1024 and
// contiguous [BH, T, d] tensors of the entry's dtype (bf16 with d <= 64:
// d a multiple of 8 and every pointer 16-byte aligned); `delta` is f32
// scratch of BH * Tq floats.  Launch on `stream` (delta, then dK/dV, then dQ), do not
// synchronise, allocate nothing; return the first failing launch's
// cudaError_t (0 on success).
#define FLASH_BWD_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* out, const void* dout, const void* lse,   \
                      void* delta, void* dq, void* dk, void* dv, int bh,    \
                      int tq, int tk, int d, int causal, float scale,       \
                      void* stream) {                                       \
    const Args a{q,  k,  v,  out, dout, lse, delta, dq,    dk,              \
                 dv, bh, tq, tk,  d,    causal, scale,                      \
                 static_cast<cudaStream_t>(stream)};                        \
    return launch<T>(a);                                                    \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_f32, float)
FLASH_BWD_ENTRY(flash_attention_bwd_bf16, __nv_bfloat16)

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
