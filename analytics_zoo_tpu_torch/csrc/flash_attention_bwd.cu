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
// Six designs share that structure (`design` below picks one):
//   * bf16 with head widths 33-64 (d a multiple of 8; the wrapper pads
//     others), BERT's path: wgmma fed by TMA (hopper.cuh).  A block is one
//     warpgroup owning 64 keys (dK/dV) or 64 q rows (dQ), which streams
//     64-row tiles of the other side through a ring of kStages TMA
//     stages, one mbarrier each, refilled by one thread.  Every
//     tile is 64 bf16 wide, one 128-byte swizzle atom: a 3-D tensor map
//     over [BH, T, d] (box 1 x 64 x 64) zero-fills rows >= T of its own
//     head and columns >= d.  Per tile, S^T = K Q^T and dP^T = V dO^T
//     (dK/dV; S = Q K^T and dP = dO V^T in dQ) are m64n64k16 products with
//     both operands K-major in shared memory; P and dS are computed on the
//     f32 accumulators (2^x by ex2.approx, scale * log2(e) folded in;
//     masks only on tiles that hold the last key, the last q row or the
//     causal diagonal), rounded to bf16 in registers and fed as the
//     register A operand of dV += P^T dO, dK += dS^T Q or dQ += dS K,
//     whose B operands are the staged tiles read MN-major (the transpose
//     bit).  Three (dK/dV) or four (dQ) such blocks share an SM, so one's
//     softmax algebra overlaps another's products.  Its delta pass reads
//     out and dO in 16-byte pieces.
//   * bf16 with head widths 65-256 (wgmma_pair): the same on tiles of up
//     to four 64-wide swizzle atoms, a block two warpgroups that split the
//     products instead of the rows (one S^T, P and dV, the other dP^T, dS
//     and dK; in dQ one S and P, the other dP and dS, each half of dQ's
//     columns), P and dS handed over as bf16 fragments in shared memory.
//     Section "two warpgroups a block" below.
//   * bf16 with head widths up to 32: the tensor cores by mma.sync.m16n8k16
//     in blocks of 4 warps; each warp owns 16 keys (dK/dV) or 16 q rows
//     (dQ) of a 64 x 64 tile, takes its K and V (or Q and dO) A-fragments
//     from registers and the other side by ldmatrix; P and dS, rounded to
//     bf16 in place, are the A operand of the second products, whose B
//     operands come by ldmatrix.trans (layouts in warp_mma.cuh).  The
//     streamed tiles are double-buffered by cp.async 16-byte copies.
//   * f32 with head widths up to 64 (BERT's f32 path): wgmma in 3xTF32,
//     each f32 product three tf32 products of big and small parts, which
//     keeps about f32's accuracy at the tensor cores' tf32 rate (495
//     TFLOP/s dense against 67 for f32 FMAs: the bound at BERT-base
//     training, 3 x 10 BH T^2 d FLOP, is 0.39 ms against the FMAs' 0.96).
//     wgmma takes tf32 from shared memory only K-major, so a split pass
//     first writes every operand's parts in the layouts the products read
//     (q, k, v, dO as they are; q, dO, k transposed); the passes then run
//     as the bf16 design's, with 32-row streamed tiles and one block an SM
//     (the parts of a block's tiles fill 160-192 KB).  Section "f32 on the
//     tensor cores" below.
//   * f32 wider than 64, up to 256: scalar f32 FMAs from shared
//     memory (tiles transposed, f32), 256 threads in a 16 x 16 grid: in
//     dK/dV thread (ty, tx) owns keys ty*KR.. of S^T and dP^T and columns
//     tx + 16 j of dK and dV; dQ mirrors the forward's f32 kernel, with dS
//     through shared memory.  Tiles 64 x 64 up to d 128 and 32 x 32 at
//     d 256; loads are element-wise, so any d works.
//   * head dims above 256: the wide kernels, 16 x 16 tiles, the head dim
//     staged in chunks of 64 columns, each block owning a chunk of 256
//     output columns (S and dP are recomputed once per chunk).
// Kernels are instantiated for padded widths and take the true d at run
// time.  What it leaves: in the wgmma design a producer warp, persistent
// blocks, and an overlap of softmax and products inside a block (one
// tile's dV/dK products in flight with the next tile's S/dP: ptxas
// serialised that form, C7515; or FlashAttention-3's ping-pong of two
// warpgroups); tensor cores for f32 heads wider than 64 and for heads
// wider than 256; in the 3xTF32
// design, splitting in shared memory after the TMA load instead of the
// split pass's extra traffic, and more than one block an SM.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "flash_tf32.cuh"
#include "hopper.cuh"
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
// Wide head dims (above 256): 16 x 16 tiles, head dim staged in chunks
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
// bf16 on the tensor cores by mma.sync, head widths up to 32
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
// bf16 on the tensor cores by wgmma fed by TMA, head widths 33-64
// ---------------------------------------------------------------------------

constexpr int kWgRows = hopper::kTileRows;  // rows per block and tile
constexpr int kWgThreads = 128;
constexpr uint32_t kWgTileBytes = kWgRows * 64 * sizeof(bf16);  // 8 KB

// Stages of the ring.  A block is one warpgroup: at BERT's shape two
// warpgroups a block (sharing the streamed tiles) ran 6-30% slower, in
// lockstep through the per-tile barrier, and a third stage added nothing
// (PERF.md).
constexpr int kStages = 2;

// Shared memory of both passes, in bytes from a 1024-aligned base: the
// two tiles held for the whole block (K and V, or Q and dO), kStages ring
// stages of each of the two streamed ones, the streamed rows' lse (x
// log2 e) and delta (dK/dV only; two slots of 64), and kStages + 1
// mbarriers (the stages', the held tiles').
struct WgmmaSmem {
  static constexpr uint32_t kHeld0 = 0;
  static constexpr uint32_t kHeld1 = kHeld0 + kWgTileBytes;
  static constexpr uint32_t kRing0 = kHeld1 + kWgTileBytes;
  static constexpr uint32_t kRing1 = kRing0 + kStages * kWgTileBytes;
  static constexpr uint32_t kLse = kRing1 + kStages * kWgTileBytes;
  static constexpr uint32_t kDelta = kLse + 2 * kWgRows * sizeof(float);
  static constexpr uint32_t kBar = kDelta + 2 * kWgRows * sizeof(float);
  static constexpr size_t kBytes =
      kBar + (kStages + 1) * sizeof(uint64_t) + 1024;
};

// The 1024-aligned base inside the dynamic shared memory.
__device__ __forceinline__ unsigned char* wgmma_smem_base(
    unsigned char* raw) {
  const uint32_t addr = warp_mma::smem_addr(raw);
  return raw + ((1024 - (addr & 1023)) & 1023);
}

// P and dS of one m64n64 tile from its S and dP accumulators (f32, the
// wgmma layout; this thread's elements are at row row0 + 8 (e >> 1) and
// column col0 + 8 i + (e & 1)), rounded to bf16 straight into the A
// fragments of the next products: ap[kk] / as[kk] hold k16 step kk of P /
// dS, and s and dp are only read.  kKeysAreRows: S^T of the dK/dV pass
// (rows are keys, columns q rows), and lse2[8 i + u] / dlt[8 i + u] are
// the lse (x log2 e) and delta of column col0 + 8 i + u (shared memory);
// else S of the dQ pass, and lse2[h] / dlt[h] are those of row row0 + 8 h.
// With kMask, elements outside [row < tq, key < tk, !causal || row >=
// key] get 0 and are never exponentiated.
template <bool kMask, bool kKeysAreRows>
__device__ __forceinline__ void wgmma_p_ds(const float (&s)[32],
                                           const float (&dp)[32],
                                           uint32_t (&ap)[4][4],
                                           uint32_t (&as)[4][4],
                                           const float* lse2,
                                           const float* dlt,
                                           float scale_log2, float scale,
                                           int row0, int col0, int tq,
                                           int tk, int causal) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // elements e = 2 h and 2 h + 1
      float p[2], ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int x = 4 * i + 2 * h + u;
        const float l = kKeysAreRows ? lse2[8 * i + u] : lse2[h];
        const float dd = kKeysAreRows ? dlt[8 * i + u] : dlt[h];
        bool keep = true;
        if (kMask) {
          const int r = row0 + h * 8, c = col0 + 8 * i + u;
          const int key = kKeysAreRows ? r : c, row = kKeysAreRows ? c : r;
          keep = key < tk && row < tq && (!causal || row >= key);
        }
        p[u] = keep ? warp_mma::exp2_approx(fmaf(s[x], scale_log2, -l))
                    : 0.f;
        ds[u] = p[u] * (dp[x] - dd) * scale;
      }
      // element 4 i + 2 h is element 2 (2 (i % 2) + h) of step i / 2
      ap[i / 2][2 * (i % 2) + h] = warp_mma::pack_bf16(p[0], p[1]);
      as[i / 2][2 * (i % 2) + h] = warp_mma::pack_bf16(ds[0], ds[1]);
    }
}

// d0 = A0 B0^T and d1 = A1 B1^T over a depth of 64, A and B 64-row K-major
// tiles at the given shared addresses, issued as one group.
__device__ __forceinline__ void issue_s_dp(float (&d0)[32], float (&d1)[32],
                                           uint32_t a0, uint32_t b0,
                                           uint32_t a1, uint32_t b1) {
  using namespace hopper;
  wgmma_fence();
  wgmma_ss<false>(d0, desc_k_major(a0, 0), desc_k_major(b0, 0));
#pragma unroll
  for (int kd = 1; kd < 4; ++kd)
    wgmma_ss<true>(d0, desc_k_major(a0, kd), desc_k_major(b0, kd));
  wgmma_ss<false>(d1, desc_k_major(a1, 0), desc_k_major(b1, 0));
#pragma unroll
  for (int kd = 1; kd < 4; ++kd)
    wgmma_ss<true>(d1, desc_k_major(a1, kd), desc_k_major(b1, kd));
  wgmma_commit();
}

// delta = rowsum(out * dout) for rows of d bf16 (a multiple of 8, 16-byte
// aligned): 8 lanes a row, each 16-byte pieces 64 columns apart of both.
__global__ void __launch_bounds__(kThreads)
bwd_delta_x8_kernel(const bf16* __restrict__ out,
                    const bf16* __restrict__ dout, float* __restrict__ delta,
                    int64_t rows, int d) {
  const int64_t row = (int64_t(blockIdx.x) * kThreads + threadIdx.x) / 8;
  float s = 0.f;
  for (int c = (threadIdx.x & 7) * 8; row < rows && c < d; c += 64) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + row * d + c);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + row * d + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]);
      const float2 b = __bfloat1622float2(g2[i]);
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 7) == 0 && row < rows) delta[row] = s;
}

// Per tile, a block waits for the tile's copy, issues S and dP, waits,
// computes P and dS, issues the products that use them and waits again;
// the products of one block overlap the softmax algebra of another on the
// same SM.  Tile m sits in stage m % kStages; a stage is refilled (by
// thread 0) once every warp has finished the tile in it, which leaves
// kStages - 1 tiles of lead for TMA.

// 168 registers a thread: three blocks an SM.
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap g_map,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int tq, int tk, int d,
                      int n_ktiles, float scale, int causal) {
  using namespace hopper;
  using L = WgmmaSmem;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wgmma_smem_base(smem_raw);
  const uint32_t sbase = warp_mma::smem_addr(base);
  float* lse_s = reinterpret_cast<float*>(base + L::kLse);
  float* delta_s = reinterpret_cast<float*>(base + L::kDelta);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);  // stages
  uint64_t* held = full + kStages;                                 // K, V

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * kWgRows;  // the block's keys
  const float* lb = lse + int64_t(bh) * tq;
  const float* db = delta + int64_t(bh) * tq;
  const float scale_log2 = scale * kLog2e;

  // rows before k0 see no key of this tile under `causal`
  const int qstart = causal ? (min(k0, tq) / kWgRows) * kWgRows : 0;
  const int n_qt = (tq - qstart + kWgRows - 1) / kWgRows;
  auto stage_rows = [&](int j) {  // lse and delta of q tile j, slot j & 1
    if (tid < kWgRows) {
      const int row = qstart + j * kWgRows + tid;
      const bool in = row < tq;
      lse_s[(j & 1) * kWgRows + tid] = in ? lb[row] * kLog2e : 0.f;
      delta_s[(j & 1) * kWgRows + tid] = in ? db[row] : 0.f;
    }
  };
  auto load_q_tile = [&](int j) {  // one thread: Q and dO of q tile j
    const int st = j % kStages;
    mbar_expect_tx(&full[st], 2 * kWgTileBytes);
    tma_load_3d(base + L::kRing0 + st * kWgTileBytes, &q_map, &full[st], 0,
                qstart + j * kWgRows, bh);
    tma_load_3d(base + L::kRing1 + st * kWgTileBytes, &g_map, &full[st], 0,
                qstart + j * kWgRows, bh);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && n_qt > 0) {
    mbar_expect_tx(held, 2 * kWgTileBytes);
    tma_load_3d(base + L::kHeld0, &k_map, held, 0, k0, bh);
    tma_load_3d(base + L::kHeld1, &v_map, held, 0, k0, bh);
    for (int j = 0; j < kStages && j < n_qt; ++j) load_q_tile(j);
  }
  if (n_qt > 0) stage_rows(0);
  __syncthreads();

  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
  const uint32_t k_addr = sbase + L::kHeld0;
  const uint32_t v_addr = sbase + L::kHeld1;
  if (n_qt > 0) mbar_wait(held, 0);

  for (int j = 0; j < n_qt; ++j) {
    const int st = j % kStages;
    const int q0 = qstart + j * kWgRows;
    const uint32_t q_addr = sbase + L::kRing0 + st * kWgTileBytes;
    const uint32_t g_addr = sbase + L::kRing1 + st * kWgTileBytes;
    if (j + 1 < n_qt) stage_rows(j + 1);
    // every thread waits for the tile, so no copy outlives the block.
    // Every tile is computed: the masks zero what the block's keys cannot
    // see (keys >= Tk, or under `causal` a tile wholly before them).
    mbar_wait(&full[st], (j / kStages) & 1);
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q rows
    float s[32], dp[32];
    issue_s_dp(s, dp, k_addr, q_addr, v_addr, g_addr);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const int row0 = k0 + 16 * warp + g, col0 = q0 + 2 * t;
    // this thread's columns' lse and delta: 8 i + 2 t + u of the slot
    const float* l2 = lse_s + (j & 1) * kWgRows + 2 * t;
    const float* dl = delta_s + (j & 1) * kWgRows + 2 * t;
    uint32_t ap[4][4], as[4][4];
    if (q0 + kWgRows > tq || k0 + kWgRows > tk ||
        (causal && q0 < k0 + kWgRows - 1))
      wgmma_p_ds<true, true>(s, dp, ap, as, l2, dl, scale_log2, scale, row0,
                             col0, tq, tk, causal);
    else
      wgmma_p_ds<false, true>(s, dp, ap, as, l2, dl, scale_log2, scale,
                              row0, col0, tq, tk, causal);
    // dV += P^T dO and dK += dS^T Q over the tile's 64 q rows
    fence_regs(ap);
    fence_regs(as);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc_v, ap[kk], desc_mn_major(g_addr, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc_k, as[kk], desc_mn_major(q_addr, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(ap);
    fence_regs(as);
    __syncthreads();  // stage st read by every warp; rows j+1 staged
    if (tid == 0 && j + kStages < n_qt) load_q_tile(j + kStages);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + 16 * warp + g + 8 * r;
      const int col = 8 * i + 2 * t;
      if (key < tk && col < d) {
        const int64_t off = (int64_t(bh) * tk + key) * d + col;
        *reinterpret_cast<uint32_t*>(dk + off) =
            warp_mma::pack_bf16(acc_k[4 * i + 2 * r], acc_k[4 * i + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + off) =
            warp_mma::pack_bf16(acc_v[4 * i + 2 * r], acc_v[4 * i + 2 * r + 1]);
      }
    }
}

// Bounded for four blocks an SM (at most 128 registers a thread, 126
// used; 134 unbounded, and three blocks ran 7% slower).
__global__ void __launch_bounds__(kWgThreads, 4)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap g_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int tq, int tk, int d, int n_qtiles, float scale,
                    int causal) {
  using namespace hopper;
  using L = WgmmaSmem;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wgmma_smem_base(smem_raw);
  const uint32_t sbase = warp_mma::smem_addr(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);  // stages
  uint64_t* held = full + kStages;                                 // Q, dO

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_qtiles;
  // the block's q rows; the last tile (the longest under `causal`) first
  const int q0 = (n_qtiles - 1 - blockIdx.x % n_qtiles) * kWgRows;
  const float scale_log2 = scale * kLog2e;

  // keys past the block's last q row are all masked under `causal`
  const int kend = causal ? min(tk, q0 + kWgRows) : tk;
  const int n_kt = (kend + kWgRows - 1) / kWgRows;
  auto load_kv_tile = [&](int j) {  // one thread: K and V of key tile j
    const int st = j % kStages;
    mbar_expect_tx(&full[st], 2 * kWgTileBytes);
    tma_load_3d(base + L::kRing0 + st * kWgTileBytes, &k_map, &full[st], 0,
                j * kWgRows, bh);
    tma_load_3d(base + L::kRing1 + st * kWgTileBytes, &v_map, &full[st], 0,
                j * kWgRows, bh);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(held, 2 * kWgTileBytes);
    tma_load_3d(base + L::kHeld0, &q_map, held, 0, q0, bh);
    tma_load_3d(base + L::kHeld1, &g_map, held, 0, q0, bh);
    for (int j = 0; j < kStages && j < n_kt; ++j) load_kv_tile(j);
  }

  // lse (x log2 e) and delta of this thread's rows g and g + 8
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    l2[h] = row < tq ? lse[int64_t(bh) * tq + row] * kLog2e : 0.f;
    dl[h] = row < tq ? delta[int64_t(bh) * tq + row] : 0.f;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint32_t q_addr = sbase + L::kHeld0;
  const uint32_t g_addr = sbase + L::kHeld1;
  mbar_wait(held, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kStages;
    const int k0 = j * kWgRows;
    const uint32_t k_addr = sbase + L::kRing0 + st * kWgTileBytes;
    const uint32_t v_addr = sbase + L::kRing1 + st * kWgTileBytes;
    // every thread waits for the tile, so no copy outlives the block;
    // every tile is computed, the masks zero rows >= Tq and, under
    // `causal`, keys after them
    mbar_wait(&full[st], (j / kStages) & 1);
    // S = Q K^T and dP = dO V^T: 64 q rows x 64 keys
    float s[32], dp[32];
    issue_s_dp(s, dp, q_addr, k_addr, g_addr, v_addr);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const int row0 = q0 + 16 * warp + g, col0 = k0 + 2 * t;
    uint32_t unused[4][4], a[4][4];  // P's fragments are not needed here
    if (q0 + kWgRows > tq || k0 + kWgRows > tk ||
        (causal && k0 + kWgRows - 1 > q0))
      wgmma_p_ds<true, false>(s, dp, unused, a, l2, dl, scale_log2, scale,
                              row0, col0, tq, tk, causal);
    else
      wgmma_p_ds<false, false>(s, dp, unused, a, l2, dl, scale_log2, scale,
                               row0, col0, tq, tk, causal);
    // dQ += dS K over the tile's 64 keys
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, a[kk], desc_mn_major(k_addr, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a);
    __syncthreads();  // stage st read by every warp
    if (tid == 0 && j + kStages < n_kt) load_kv_tile(j + kStages);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      const int col = 8 * i + 2 * t;
      if (row < tq && col < d)
        *reinterpret_cast<uint32_t*>(dq + (int64_t(bh) * tq + row) * d +
                                     col) =
            warp_mma::pack_bf16(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores by wgmma, head widths 65-256: two warpgroups a
// block, one on P and one on dS (wgmma_pair)
// ---------------------------------------------------------------------------
//
// The wgmma design above with tiles NA = ceil(d / 64) swizzle atoms wide: a
// 64-row tile of width d is NA 64 x 64 atoms, each its own 8 KB box of the
// same tensor map (columns 64 a .. 64 a + 63; those >= d read zeros), all
// completing on one mbarrier.  The products that sum over d (S^T and dP^T,
// S and dP) walk the atoms in k16 steps; those whose N runs over d (dV, dK,
// dQ) issue one m64n64k16 per atom and k16 step, with B at that atom.
//
// A warpgroup's dK and dV accumulators for 64 keys take d registers a
// thread (256 at d 256), which cannot fit beside S^T and dP^T.  So a block
// is two warpgroups that split the pass's products instead of its rows.  In
// dK/dV warpgroup 0 computes S^T and P and accumulates dV; warpgroup 1
// computes dP^T, takes P from warpgroup 0 through shared memory (its bf16 A
// fragments, 8 KB, the same thread layout on both sides), computes dS and
// accumulates dK.  In dQ warpgroup 0 computes S and P, warpgroup 1 dP and
// dS, which it hands back through the same buffer, and each accumulates
// half of dQ's columns.  Each thread holds at most 4 x 32 accumulators;
// nothing is computed twice, and S^T and dP^T (S and dP) run side by side
// on the tensor cores.  dS is computed from P as rounded to bf16 (the
// fragment it is handed as) and is rounded to bf16 for its product, as in
// the design above.  Still three passes and no atomics.
//
// What bounds it: operations, the FA2 backward's 10 BH T^2 d FLOP (0.130
// ms at BH 384 x T 512 x d 128 on an H100); the passes do 14 BH T^2 d, dQ
// computing S and dP again so that no block adds into another's rows.
// Registers decide the overlap: with P and dS held in place of S^T and dP^T
// (below), dK/dV takes 128 a thread at d 65-128, two blocks an SM, so one
// block's softmax algebra and barriers overlap the other's products.

constexpr int kPairThreads = 2 * kWgThreads;

// Shared memory of the two-warpgroup passes for tiles of NA atoms, in bytes
// from a 1024-aligned base: the two held tiles, kStages ring stages of the
// two streamed ones (the first RA0 atoms wide: dQ's K takes both
// warpgroups' atoms), the fragments the warpgroups hand each other (16
// words a thread), the streamed rows' lse (x log2 e) and delta (dK/dV
// only; two slots of 64), and kStages + 1 mbarriers.
template <int NA, int RA0>
struct PairSmem {
  static constexpr uint32_t kTile = NA * kWgTileBytes;
  static constexpr uint32_t kHeld0 = 0;
  static constexpr uint32_t kHeld1 = kHeld0 + kTile;
  static constexpr uint32_t kRing0 = kHeld1 + kTile;
  static constexpr uint32_t kStage0 = RA0 * kWgTileBytes;
  static constexpr uint32_t kRing1 = kRing0 + kStages * kStage0;
  static constexpr uint32_t kXfer = kRing1 + kStages * kTile;
  static constexpr uint32_t kLse = kXfer + 16 * kWgThreads * sizeof(uint32_t);
  static constexpr uint32_t kDelta = kLse + 2 * kWgRows * sizeof(float);
  static constexpr uint32_t kBar = kDelta + 2 * kWgRows * sizeof(float);
  static constexpr size_t kBytes =
      kBar + (kStages + 1) * sizeof(uint64_t) + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// Barrier `id` (1 or 2; 0 is __syncthreads's) over both warpgroups.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kPairThreads) : "memory");
}

// d = A B^T over a depth of NA atoms, A and B 64-row K-major tiles of NA
// atoms at the given shared addresses; one group.
template <int NA>
__device__ __forceinline__ void issue_atoms_abt(float (&d)[32], uint32_t a,
                                                uint32_t b) {
  using namespace hopper;
  wgmma_ss<false>(d, desc_k_major(a, 0), desc_k_major(b, 0));
#pragma unroll
  for (int at = 0; at < NA; ++at)
#pragma unroll
    for (int kd = at == 0 ? 1 : 0; kd < 4; ++kd)
      wgmma_ss<true>(d, desc_k_major(a + at * kWgTileBytes, kd),
                     desc_k_major(b + at * kWgTileBytes, kd));
  wgmma_commit();
}

// The fragments of P or dS live in place in the accumulator array they
// were computed from: word r of k16 step kk (elements 8 kk + 2 r and + 1,
// rounded to bf16 and packed) overwrites x[8 kk + r], whose own element
// was already read.  So x[8 kk .. 8 kk + 3] is the A fragment of step kk,
// and no second set of 16 registers is held beside the accumulators: the
// dK/dV pass at d 65-128 then fits in 128 registers, two blocks an SM.
__device__ __forceinline__ uint32_t frag_word(const float (&x)[32], int kk,
                                             int r) {
  return __float_as_uint(x[8 * kk + r]);
}

// acc[at] += A B_at for atoms at < N over a depth of 64: A the fragments
// held in x, B_at atom `at` of the 64-row tile at b, read MN-major; one
// group.
template <int N>
__device__ __forceinline__ void issue_atoms_ab(float (&acc)[N][32],
                                               const float (&x)[32],
                                               uint32_t b) {
  using namespace hopper;
#pragma unroll
  for (int at = 0; at < N; ++at)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {frag_word(x, kk, 0), frag_word(x, kk, 1),
                             frag_word(x, kk, 2), frag_word(x, kk, 3)};
      wgmma_rs(acc[at], a, desc_mn_major(b + at * kWgTileBytes, kk));
    }
  wgmma_commit();
}

// P of one 64 x 64 tile from its S^T (kKeysAreRows) or S accumulators in
// x, in place as above; lse2 and the masks as wgmma_p_ds's.
template <bool kMask, bool kKeysAreRows>
__device__ __forceinline__ void pair_p(float (&x)[32], const float* lse2,
                                       float scale_log2, int row0, int col0,
                                       int tq, int tk, int causal) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // elements 8 kk + 2 r + u are e = 2 h + u of accumulator chunk i
      const int i = 2 * kk + (r >> 1), h = r & 1;
      float p[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float l = kKeysAreRows ? lse2[8 * i + u] : lse2[h];
        bool keep = true;
        if (kMask) {
          const int rw = row0 + h * 8, c = col0 + 8 * i + u;
          const int key = kKeysAreRows ? rw : c, row = kKeysAreRows ? c : rw;
          keep = key < tk && row < tq && (!causal || row >= key);
        }
        p[u] = keep ? warp_mma::exp2_approx(
                          fmaf(x[8 * kk + 2 * r + u], scale_log2, -l))
                    : 0.f;
      }
      x[8 * kk + r] = __uint_as_float(warp_mma::pack_bf16(p[0], p[1]));
    }
}

// dS = P (dP - delta) scale from dP's (or dP^T's) accumulators in x and
// P's fragment words in shared memory (word 4 kk + r of thread wt at
// (4 kk + r) * 128 + wt), in place in x as above; dlt as wgmma_p_ds's.
// Masked elements have P 0, so dS 0.
template <bool kKeysAreRows>
__device__ __forceinline__ void pair_ds(float (&x)[32], const uint32_t* buf,
                                        int wt, const float* dlt,
                                        float scale) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 2 * kk + (r >> 1), h = r & 1;
      const uint32_t w = buf[(4 * kk + r) * kWgThreads + wt];
      const float p[2] = {__uint_as_float(w << 16),
                          __uint_as_float(w & 0xffff0000u)};
      float ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float dd = kKeysAreRows ? dlt[8 * i + u] : dlt[h];
        ds[u] = p[u] * (x[8 * kk + 2 * r + u] - dd) * scale;
      }
      x[8 * kk + r] = __uint_as_float(warp_mma::pack_bf16(ds[0], ds[1]));
    }
}

// A warpgroup's 16 fragment words (held in x) to and from shared memory:
// word 4 kk + r of thread wt at (4 kk + r) * 128 + wt (no bank
// conflicts).
__device__ __forceinline__ void frag_store(uint32_t* buf,
                                           const float (&x)[32], int wt) {
#pragma unroll
  for (int n = 0; n < 16; ++n)
    buf[n * kWgThreads + wt] = frag_word(x, n / 4, n % 4);
}

__device__ __forceinline__ void frag_load(const uint32_t* buf,
                                          float (&x)[32], int wt) {
#pragma unroll
  for (int n = 0; n < 16; ++n)
    x[8 * (n / 4) + n % 4] = __uint_as_float(buf[n * kWgThreads + wt]);
}

// Per q tile: both warpgroups wait for the tile's copy and issue their
// product over d (S^T or dP^T); warpgroup 0 turns S^T into P and hands it
// over; warpgroup 1 turns dP^T into dS; each issues its NA products into
// dV or dK; then the stage is refilled (by thread 0) once every warp has
// finished with it, as in the design above.
// At NA 2 (d 65-128) two blocks share an SM: 128 registers, 106 KB.
template <int NA>
__global__ void __launch_bounds__(kPairThreads, NA == 2 ? 2 : 1)
bwd_dkdv_pair_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap g_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int tq, int tk, int d,
                     int n_ktiles, float scale, int causal) {
  using namespace hopper;
  using L = PairSmem<NA, NA>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wgmma_smem_base(smem_raw);
  const uint32_t sbase = warp_mma::smem_addr(base);
  float* lse_s = reinterpret_cast<float*>(base + L::kLse);
  float* delta_s = reinterpret_cast<float*>(base + L::kDelta);
  uint32_t* xfer = reinterpret_cast<uint32_t*>(base + L::kXfer);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);  // stages
  uint64_t* held = full + kStages;                                 // K, V

  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads, wt = tid % kWgThreads;
  const int warp = wt / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * kWgRows;  // the block's keys
  const float* lb = lse + int64_t(bh) * tq;
  const float* db = delta + int64_t(bh) * tq;
  const float scale_log2 = scale * kLog2e;

  // rows before k0 see no key of this tile under `causal`
  const int qstart = causal ? (min(k0, tq) / kWgRows) * kWgRows : 0;
  const int n_qt = (tq - qstart + kWgRows - 1) / kWgRows;
  auto stage_rows = [&](int j) {  // lse and delta of q tile j, slot j & 1
    if (tid < kWgRows) {
      const int row = qstart + j * kWgRows + tid;
      const bool in = row < tq;
      lse_s[(j & 1) * kWgRows + tid] = in ? lb[row] * kLog2e : 0.f;
      delta_s[(j & 1) * kWgRows + tid] = in ? db[row] : 0.f;
    }
  };
  auto load_q_tile = [&](int j) {  // one thread: Q and dO of q tile j
    const int st = j % kStages, row = qstart + j * kWgRows;
    mbar_expect_tx(&full[st], 2 * L::kTile);
#pragma unroll
    for (int at = 0; at < NA; ++at) {
      const uint32_t off = (st * NA + at) * kWgTileBytes;
      tma_load_3d(base + L::kRing0 + off, &q_map, &full[st], 64 * at, row,
                  bh);
      tma_load_3d(base + L::kRing1 + off, &g_map, &full[st], 64 * at, row,
                  bh);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && n_qt > 0) {
    mbar_expect_tx(held, 2 * L::kTile);
#pragma unroll
    for (int at = 0; at < NA; ++at) {
      tma_load_3d(base + L::kHeld0 + at * kWgTileBytes, &k_map, held,
                  64 * at, k0, bh);
      tma_load_3d(base + L::kHeld1 + at * kWgTileBytes, &v_map, held,
                  64 * at, k0, bh);
    }
    for (int j = 0; j < kStages && j < n_qt; ++j) load_q_tile(j);
  }
  if (n_qt > 0) stage_rows(0);
  __syncthreads();

  float acc[NA][32];  // warpgroup 0: dV; warpgroup 1: dK
#pragma unroll
  for (int at = 0; at < NA; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[at][i] = 0.f;
  // warpgroup 0: S^T = K Q^T, then dV += P^T dO; warpgroup 1: dP^T = V
  // dO^T, then dK += dS^T Q
  const uint32_t held_a = sbase + (wg ? L::kHeld1 : L::kHeld0);
  const uint32_t ring_b1 = sbase + (wg ? L::kRing1 : L::kRing0);
  const uint32_t ring_b2 = sbase + (wg ? L::kRing0 : L::kRing1);
  if (n_qt > 0) mbar_wait(held, 0);

  for (int j = 0; j < n_qt; ++j) {
    const int st = j % kStages;
    const int q0 = qstart + j * kWgRows;
    if (j + 1 < n_qt) stage_rows(j + 1);
    // every thread waits for the tile, so no copy outlives the block;
    // every tile is computed, the masks zero what the keys cannot see
    mbar_wait(&full[st], (j / kStages) & 1);
    float x[32];  // S^T or dP^T: 64 keys x 64 q rows
    wgmma_fence();
    issue_atoms_abt<NA>(x, held_a, ring_b1 + st * L::kTile);
    wgmma_wait<0>();
    fence_regs(x);
    const int row0 = k0 + 16 * warp + g, col0 = q0 + 2 * t;
    const int slot = (j & 1) * kWgRows + 2 * t;  // columns' lse and delta
    if (wg == 0) {  // P, handed over
      if (q0 + kWgRows > tq || k0 + kWgRows > tk ||
          (causal && q0 < k0 + kWgRows - 1))
        pair_p<true, true>(x, lse_s + slot, scale_log2, row0, col0, tq, tk,
                           causal);
      else
        pair_p<false, true>(x, lse_s + slot, scale_log2, row0, col0, tq, tk,
                            causal);
      frag_store(xfer, x, wt);
    }
    pair_sync(1);
    if (wg == 1) pair_ds<true>(x, xfer, wt, delta_s + slot, scale);
    // dV += P^T dO or dK += dS^T Q over the tile's 64 q rows
    fence_regs(x);
    wgmma_fence();
    issue_atoms_ab<NA>(acc, x, ring_b2 + st * L::kTile);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(x);
    __syncthreads();  // stage st and the fragments read; rows j+1 staged
    if (tid == 0 && j + kStages < n_qt) load_q_tile(j + kStages);
  }

  bf16* grad = wg ? dk : dv;
#pragma unroll
  for (int at = 0; at < NA; ++at)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = k0 + 16 * warp + g + 8 * r;
        const int col = 64 * at + 8 * i + 2 * t;
        if (key < tk && col < d)
          *reinterpret_cast<uint32_t*>(grad + (int64_t(bh) * tk + key) * d +
                                       col) =
              warp_mma::pack_bf16(acc[at][4 * i + 2 * r],
                                  acc[at][4 * i + 2 * r + 1]);
      }
}

// Per key tile: warpgroup 0 computes S and P and hands P over; warpgroup 1
// computes dP and dS and hands dS back; each accumulates dQ += dS K over
// its H atoms of dQ's columns.  The ring's K stages hold 2 H atoms; an atom
// past NA is never loaded, and only feeds columns >= d, which are never
// stored.
template <int NA>
__global__ void __launch_bounds__(kPairThreads, 1)
bwd_dq_pair_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap g_map,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int tq, int tk, int d, int n_qtiles, float scale,
                   int causal) {
  using namespace hopper;
  constexpr int H = (NA + 1) / 2;  // dQ's atoms a warpgroup
  using L = PairSmem<NA, 2 * H>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wgmma_smem_base(smem_raw);
  const uint32_t sbase = warp_mma::smem_addr(base);
  uint32_t* xfer = reinterpret_cast<uint32_t*>(base + L::kXfer);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);  // stages
  uint64_t* held = full + kStages;                                 // Q, dO

  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads, wt = tid % kWgThreads;
  const int warp = wt / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_qtiles;
  // the block's q rows; the last tile (the longest under `causal`) first
  const int q0 = (n_qtiles - 1 - blockIdx.x % n_qtiles) * kWgRows;
  const float scale_log2 = scale * kLog2e;

  // keys past the block's last q row are all masked under `causal`
  const int kend = causal ? min(tk, q0 + kWgRows) : tk;
  const int n_kt = (kend + kWgRows - 1) / kWgRows;
  auto load_kv_tile = [&](int j) {  // one thread: K and V of key tile j
    const int st = j % kStages;
    mbar_expect_tx(&full[st], 2 * L::kTile);
#pragma unroll
    for (int at = 0; at < NA; ++at) {
      tma_load_3d(base + L::kRing0 + st * L::kStage0 + at * kWgTileBytes,
                  &k_map, &full[st], 64 * at, j * kWgRows, bh);
      tma_load_3d(base + L::kRing1 + (st * NA + at) * kWgTileBytes, &v_map,
                  &full[st], 64 * at, j * kWgRows, bh);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(held, 2 * L::kTile);
#pragma unroll
    for (int at = 0; at < NA; ++at) {
      tma_load_3d(base + L::kHeld0 + at * kWgTileBytes, &q_map, held,
                  64 * at, q0, bh);
      tma_load_3d(base + L::kHeld1 + at * kWgTileBytes, &g_map, held,
                  64 * at, q0, bh);
    }
    for (int j = 0; j < kStages && j < n_kt; ++j) load_kv_tile(j);
  }

  // lse (x log2 e) and delta of this thread's rows g and g + 8
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    l2[h] = row < tq ? lse[int64_t(bh) * tq + row] * kLog2e : 0.f;
    dl[h] = row < tq ? delta[int64_t(bh) * tq + row] : 0.f;
  }
  float acc[H][32];
#pragma unroll
  for (int at = 0; at < H; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[at][i] = 0.f;
  // warpgroup 0: S = Q K^T; warpgroup 1: dP = dO V^T
  const uint32_t held_a = sbase + (wg ? L::kHeld1 : L::kHeld0);
  mbar_wait(held, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kStages;
    const int k0 = j * kWgRows;
    const uint32_t k_addr = sbase + L::kRing0 + st * L::kStage0;
    const uint32_t v_addr = sbase + L::kRing1 + st * L::kTile;
    // every thread waits for the tile, so no copy outlives the block;
    // every tile is computed, the masks zero rows >= Tq and, under
    // `causal`, keys after them
    mbar_wait(&full[st], (j / kStages) & 1);
    float x[32];  // S or dP: 64 q rows x 64 keys
    wgmma_fence();
    issue_atoms_abt<NA>(x, held_a, wg ? v_addr : k_addr);
    wgmma_wait<0>();
    fence_regs(x);
    const int row0 = q0 + 16 * warp + g, col0 = k0 + 2 * t;
    if (wg == 0) {  // P, handed over
      if (q0 + kWgRows > tq || k0 + kWgRows > tk ||
          (causal && k0 + kWgRows - 1 > q0))
        pair_p<true, false>(x, l2, scale_log2, row0, col0, tq, tk, causal);
      else
        pair_p<false, false>(x, l2, scale_log2, row0, col0, tq, tk, causal);
      frag_store(xfer, x, wt);
    }
    pair_sync(1);
    if (wg == 1) {  // dS, handed back
      pair_ds<false>(x, xfer, wt, dl, scale);
      frag_store(xfer, x, wt);
    }
    pair_sync(2);
    if (wg == 0) frag_load(xfer, x, wt);
    // dQ += dS K over the tile's 64 keys, this warpgroup's H atoms
    fence_regs(x);
    wgmma_fence();
    issue_atoms_ab<H>(acc, x, k_addr + wg * H * kWgTileBytes);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(x);
    __syncthreads();  // stage st and the fragments read by every warp
    if (tid == 0 && j + kStages < n_kt) load_kv_tile(j + kStages);
  }

#pragma unroll
  for (int at = 0; at < H; ++at)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + 16 * warp + g + 8 * r;
        const int col = 64 * (wg * H + at) + 8 * i + 2 * t;
        if (row < tq && col < d)
          *reinterpret_cast<uint32_t*>(dq + (int64_t(bh) * tq + row) * d +
                                       col) =
              warp_mma::pack_bf16(acc[at][4 * i + 2 * r],
                                  acc[at][4 * i + 2 * r + 1]);
      }
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores by wgmma in 3xTF32, head widths up to 64
// ---------------------------------------------------------------------------
//
// The bf16 design's three passes with f32 operands: every product is three
// tf32 products (hopper.cuh: big and small parts, small terms first, f32
// sums).  wgmma reads tf32 from shared memory only K-major, so a split pass
// writes each operand's parts once, in the layouts the products read:
// q, k, v and dO as they are ([BH, T, 64]: the K-major A and B of S^T =
// K Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T), and q, dO and k
// transposed ([BH, 64, T]: the B of dK += dS^T Q, dV += P^T dO and dQ +=
// dS K, whose depth is T), T in the order hopper.cuh gives within each
// group of 8 so that P and dS pass from their accumulators to register A
// fragments without a shuffle.  P and dS are split in registers.  A block
// is one warpgroup (64 keys, or 64 q rows) holding its own tiles' parts
// (64 KB) and streaming 32-row tiles of the other side through a 2-stage
// TMA ring; the shared memory (192 KB in dK/dV, 160 KB in dQ) allows one
// block an SM.

// kTfHeld (64) keys (dK/dV) or q rows (dQ) a block, kTfRows (32) rows a
// streamed tile, and the parts' layouts: flash_tf32.cuh.
constexpr int kTfStages = 2;

// Shared memory of a pass, bytes from a 1024-aligned base: the held tiles'
// parts (two operands x big, small), kTfStages stages of the streamed
// operands' parts, the streamed rows' lse and delta (dK/dV only; two slots
// of 32), then kTfStages + 1 mbarriers.
template <bool kDkdv>
struct TfSmem {
  static constexpr uint32_t kHeld0 = 0;
  static constexpr uint32_t kHeld1 = 2 * kTfHeldPart;
  static constexpr uint32_t kRing = 4 * kTfHeldPart;
  // dK/dV: Q, dO (32 x 64) then Q^T, dO^T (64 x 32); dQ: K, V, then K^T
  static constexpr uint32_t kStage =
      kDkdv ? 4 * kTfRowPart + 4 * kTfColPart : 4 * kTfRowPart + 2 * kTfColPart;
  static constexpr uint32_t kRows = kRing + kTfStages * kStage;
  static constexpr uint32_t kBar =
      kRows + (kDkdv ? 4 * kTfRows * sizeof(float) : 0);
  static constexpr size_t kBytes =
      kBar + (kTfStages + 1) * sizeof(uint64_t) + 1024;
};
static_assert(TfSmem<true>::kBytes <= 232448, "dK/dV shared memory");

// d = A B^T over a depth of 64 (8 k8 steps) in 3xTF32, A and B K-major
// parts (big at a / b, small `part` bytes after) whose 32-wide atoms lie
// `atom` bytes apart; one group of products, not committed.
template <int N>
__device__ __forceinline__ void tf32x3_ss_d64(float (&d)[N / 2], uint32_t a,
                                              uint32_t a_part, uint32_t a_atom,
                                              uint32_t b, uint32_t b_part,
                                              uint32_t b_atom) {
  using namespace hopper;
  wgmma_tf32_ss<false, N>(d, desc_tf32(a, 0, a_atom),
                          desc_tf32(b + b_part, 0, b_atom));
  wgmma_tf32_ss<true, N>(d, desc_tf32(a + a_part, 0, a_atom),
                         desc_tf32(b, 0, b_atom));
  wgmma_tf32_ss<true, N>(d, desc_tf32(a, 0, a_atom), desc_tf32(b, 0, b_atom));
#pragma unroll
  for (int kk = 1; kk < 8; ++kk) {
    wgmma_tf32_ss<true, N>(d, desc_tf32(a, kk, a_atom),
                           desc_tf32(b + b_part, kk, b_atom));
    wgmma_tf32_ss<true, N>(d, desc_tf32(a + a_part, kk, a_atom),
                           desc_tf32(b, kk, b_atom));
    wgmma_tf32_ss<true, N>(d, desc_tf32(a, kk, a_atom),
                           desc_tf32(b, kk, b_atom));
  }
}

// P and dS of one m64n32 tile from its S and dP accumulators (f32; this
// thread's elements at row row0 + 8 (e >> 1), column col0 + 8 i + (e & 1)),
// split into big and small tf32 parts straight into the A fragments of the
// next products (k8 step i = n8 chunk i, hopper.cuh's order: a0 = e 0, a1
// = e 2, a2 = e 1, a3 = e 3).  kKeysAreRows: S^T of the dK/dV pass, lse /
// dlt of column col0 + 8 i + u at [8 i + u]; else S of the dQ pass, lse /
// dlt of row row0 + 8 h at [h].  kWantP: P's fragments too (dK/dV).  With
// kMask, elements outside [row < tq, key < tk, !causal || row >= key] get
// 0 and are never exponentiated.
template <bool kMask, bool kKeysAreRows, bool kWantP>
__device__ __forceinline__ void tf32_p_ds(
    const float (&s)[16], const float (&dp)[16], uint32_t (&pb)[4][4],
    uint32_t (&ps)[4][4], uint32_t (&db)[4][4], uint32_t (&dsm)[4][4],
    const float* lse, const float* dlt, float scale, int row0, int col0,
    int tq, int tk, int causal) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int x = 4 * i + 2 * h + u;
        const float l = kKeysAreRows ? lse[8 * i + u] : lse[h];
        const float dd = kKeysAreRows ? dlt[8 * i + u] : dlt[h];
        bool keep = true;
        if (kMask) {
          const int r = row0 + h * 8, c = col0 + 8 * i + u;
          const int key = kKeysAreRows ? r : c, row = kKeysAreRows ? c : r;
          keep = key < tk && row < tq && (!causal || row >= key);
        }
        const float p = keep ? expf(fmaf(s[x], scale, -l)) : 0.f;
        const int a = 2 * u + h;  // e = 2 h + u -> register a
        if (kWantP) hopper::tf32_split(p, pb[i][a], ps[i][a]);
        hopper::tf32_split(p * (dp[x] - dd) * scale, db[i][a], dsm[i][a]);
      }
}

// out[row][c] = acc (row < rows, c < d) for this thread's rows row0 and
// row0 + 8 of an m64n64 accumulator (columns 8 i + 2 t, + 1).
__device__ __forceinline__ void tf32_store(const float (&acc)[32],
                                           float* out, int row0, int rows,
                                           int d, int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r, col = 8 * i + 2 * t;
      if (row >= rows) continue;
      float* o = out + int64_t(row) * d;
      if (col < d) o[col] = acc[4 * i + 2 * r];
      if (col + 1 < d) o[col + 1] = acc[4 * i + 2 * r + 1];
    }
}

// Per q tile of 32 rows, a block waits for the tile's parts, issues S^T
// and dP^T (48 products), waits, computes P and dS, issues dV += P^T dO
// and dK += dS^T Q (24 each) and waits again; a stage is refilled once every
// warp has finished the tile in it.
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_dkdv_tf32_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap g_map,
                     const __grid_constant__ CUtensorMap qt_map,
                     const __grid_constant__ CUtensorMap gt_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int tq, int tk, int d,
                     int n_ktiles, float scale, int causal) {
  using namespace hopper;
  using L = TfSmem<true>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wgmma_smem_base(smem_raw);
  const uint32_t sbase = warp_mma::smem_addr(base);
  float* lse_s = reinterpret_cast<float*>(base + L::kRows);
  float* delta_s = lse_s + 2 * kTfRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);  // stages
  uint64_t* held = full + kTfStages;                               // K, V

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * kTfHeld;  // the block's keys
  const float* lb = lse + int64_t(bh) * tq;
  const float* db = delta + int64_t(bh) * tq;

  // rows before k0 see no key of this tile under `causal`
  const int qstart = causal ? (min(k0, tq) / kTfRows) * kTfRows : 0;
  const int n_qt = (tq - qstart + kTfRows - 1) / kTfRows;
  auto stage_rows = [&](int j) {  // lse and delta of q tile j, slot j & 1
    if (tid < kTfRows) {
      const int row = qstart + j * kTfRows + tid;
      const bool in = row < tq;
      lse_s[(j & 1) * kTfRows + tid] = in ? lb[row] : 0.f;
      delta_s[(j & 1) * kTfRows + tid] = in ? db[row] : 0.f;
    }
  };
  auto load_held = [&](const CUtensorMap* map, uint32_t off) {
    for (int part = 0; part < 2; ++part)
      for (int a = 0; a < 2; ++a)
        tma_load_3d(base + off + part * kTfHeldPart + a * kTfHeldAtom, map,
                    held, 32 * a, k0, 2 * bh + part);
  };
  auto load_q_tile = [&](int j) {  // one thread: q tile j's parts
    const int st = j % kTfStages, q0 = qstart + j * kTfRows;
    unsigned char* s = base + L::kRing + st * L::kStage;
    mbar_expect_tx(&full[st], L::kStage);
    for (int part = 0; part < 2; ++part) {
      for (int a = 0; a < 2; ++a) {
        tma_load_3d(s + part * kTfRowPart + a * kTfRowAtom, &q_map, &full[st],
                    32 * a, q0, 2 * bh + part);
        tma_load_3d(s + (2 + part) * kTfRowPart + a * kTfRowAtom, &g_map,
                    &full[st], 32 * a, q0, 2 * bh + part);
      }
      tma_load_3d(s + 4 * kTfRowPart + part * kTfColPart, &qt_map, &full[st],
                  q0, 0, 2 * bh + part);
      tma_load_3d(s + 4 * kTfRowPart + (2 + part) * kTfColPart, &gt_map,
                  &full[st], q0, 0, 2 * bh + part);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kTfStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && n_qt > 0) {
    mbar_expect_tx(held, 4 * kTfHeldPart);
    load_held(&k_map, L::kHeld0);
    load_held(&v_map, L::kHeld1);
    for (int j = 0; j < kTfStages && j < n_qt; ++j) load_q_tile(j);
  }
  if (n_qt > 0) stage_rows(0);
  __syncthreads();

  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
  const uint32_t k_addr = sbase + L::kHeld0;
  const uint32_t v_addr = sbase + L::kHeld1;
  if (n_qt > 0) mbar_wait(held, 0);

  for (int j = 0; j < n_qt; ++j) {
    const int st = j % kTfStages;
    const int q0 = qstart + j * kTfRows;
    const uint32_t q_addr = sbase + L::kRing + st * L::kStage;
    const uint32_t g_addr = q_addr + 2 * kTfRowPart;
    const uint32_t qt_addr = q_addr + 4 * kTfRowPart;
    const uint32_t gt_addr = qt_addr + 2 * kTfColPart;
    if (j + 1 < n_qt) stage_rows(j + 1);
    mbar_wait(&full[st], (j / kTfStages) & 1);
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 q rows
    float s[16], dp[16];
    wgmma_fence();
    tf32x3_ss_d64<32>(s, k_addr, kTfHeldPart, kTfHeldAtom, q_addr,
                      kTfRowPart, kTfRowAtom);
    tf32x3_ss_d64<32>(dp, v_addr, kTfHeldPart, kTfHeldAtom, g_addr,
                      kTfRowPart, kTfRowAtom);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const int row0 = k0 + 16 * warp + g, col0 = q0 + 2 * t;
    // this thread's columns' lse and delta: 8 i + 2 t + u of the slot
    const float* ls = lse_s + (j & 1) * kTfRows + 2 * t;
    const float* dl = delta_s + (j & 1) * kTfRows + 2 * t;
    uint32_t pb[4][4], ps[4][4], sb[4][4], ss[4][4];
    if (q0 + kTfRows > tq || k0 + kTfHeld > tk ||
        (causal && q0 < k0 + kTfHeld - 1))
      tf32_p_ds<true, true, true>(s, dp, pb, ps, sb, ss, ls, dl, scale, row0,
                                  col0, tq, tk, causal);
    else
      tf32_p_ds<false, true, true>(s, dp, pb, ps, sb, ss, ls, dl, scale,
                                   row0, col0, tq, tk, causal);
    // dV += P^T dO and dK += dS^T Q over the tile's 32 q rows
    fence_regs(pb);
    fence_regs(ps);
    fence_regs(sb);
    fence_regs(ss);
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32x3_rs<64>(acc_v, pb[kk], ps[kk], desc_tf32(gt_addr, kk, 0),
                          desc_tf32(gt_addr + kTfColPart, kk, 0));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32x3_rs<64>(acc_k, sb[kk], ss[kk], desc_tf32(qt_addr, kk, 0),
                          desc_tf32(qt_addr + kTfColPart, kk, 0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(pb);
    fence_regs(ps);
    fence_regs(sb);
    fence_regs(ss);
    __syncthreads();  // stage st read by every warp; rows j+1 staged
    if (tid == 0 && j + kTfStages < n_qt) load_q_tile(j + kTfStages);
  }

  const int64_t off = int64_t(bh) * tk * d;
  tf32_store(acc_k, dk + off, k0 + 16 * warp + g, tk, d, t);
  tf32_store(acc_v, dv + off, k0 + 16 * warp + g, tk, d, t);
}

// Per key tile of 32, as the dK/dV pass: S = Q K^T and dP = dO V^T, then
// dQ += dS K.
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap g_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap kt_map,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int tq, int tk, int d, int n_qtiles, float scale,
                   int causal) {
  using namespace hopper;
  using L = TfSmem<false>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wgmma_smem_base(smem_raw);
  const uint32_t sbase = warp_mma::smem_addr(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);  // stages
  uint64_t* held = full + kTfStages;                               // Q, dO

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_qtiles;
  // the block's q rows; the last tile (the longest under `causal`) first
  const int q0 = (n_qtiles - 1 - blockIdx.x % n_qtiles) * kTfHeld;

  // keys past the block's last q row are all masked under `causal`
  const int kend = causal ? min(tk, q0 + kTfHeld) : tk;
  const int n_kt = (kend + kTfRows - 1) / kTfRows;
  auto load_held = [&](const CUtensorMap* map, uint32_t off) {
    for (int part = 0; part < 2; ++part)
      for (int a = 0; a < 2; ++a)
        tma_load_3d(base + off + part * kTfHeldPart + a * kTfHeldAtom, map,
                    held, 32 * a, q0, 2 * bh + part);
  };
  auto load_kv_tile = [&](int j) {  // one thread: key tile j's parts
    const int st = j % kTfStages, k0 = j * kTfRows;
    unsigned char* s = base + L::kRing + st * L::kStage;
    mbar_expect_tx(&full[st], L::kStage);
    for (int part = 0; part < 2; ++part) {
      for (int a = 0; a < 2; ++a) {
        tma_load_3d(s + part * kTfRowPart + a * kTfRowAtom, &k_map, &full[st],
                    32 * a, k0, 2 * bh + part);
        tma_load_3d(s + (2 + part) * kTfRowPart + a * kTfRowAtom, &v_map,
                    &full[st], 32 * a, k0, 2 * bh + part);
      }
      tma_load_3d(s + 4 * kTfRowPart + part * kTfColPart, &kt_map, &full[st],
                  k0, 0, 2 * bh + part);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kTfStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(held, 4 * kTfHeldPart);
    load_held(&q_map, L::kHeld0);
    load_held(&g_map, L::kHeld1);
    for (int j = 0; j < kTfStages && j < n_kt; ++j) load_kv_tile(j);
  }

  // lse and delta of this thread's rows g and g + 8
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    lr[h] = row < tq ? lse[int64_t(bh) * tq + row] : 0.f;
    dr[h] = row < tq ? delta[int64_t(bh) * tq + row] : 0.f;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint32_t q_addr = sbase + L::kHeld0;
  const uint32_t g_addr = sbase + L::kHeld1;
  mbar_wait(held, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kTfStages;
    const int k0 = j * kTfRows;
    const uint32_t k_addr = sbase + L::kRing + st * L::kStage;
    const uint32_t v_addr = k_addr + 2 * kTfRowPart;
    const uint32_t kt_addr = k_addr + 4 * kTfRowPart;
    mbar_wait(&full[st], (j / kTfStages) & 1);
    // S = Q K^T and dP = dO V^T: 64 q rows x 32 keys
    float s[16], dp[16];
    wgmma_fence();
    tf32x3_ss_d64<32>(s, q_addr, kTfHeldPart, kTfHeldAtom, k_addr,
                      kTfRowPart, kTfRowAtom);
    tf32x3_ss_d64<32>(dp, g_addr, kTfHeldPart, kTfHeldAtom, v_addr,
                      kTfRowPart, kTfRowAtom);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const int row0 = q0 + 16 * warp + g, col0 = k0 + 2 * t;
    uint32_t unused[4][4], sb[4][4], ss[4][4];  // P's parts: not needed
    if (q0 + kTfHeld > tq || k0 + kTfRows > tk ||
        (causal && k0 + kTfRows - 1 > q0))
      tf32_p_ds<true, false, false>(s, dp, unused, unused, sb, ss, lr, dr,
                                    scale, row0, col0, tq, tk, causal);
    else
      tf32_p_ds<false, false, false>(s, dp, unused, unused, sb, ss, lr, dr,
                                     scale, row0, col0, tq, tk, causal);
    // dQ += dS K over the tile's 32 keys
    fence_regs(sb);
    fence_regs(ss);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32x3_rs<64>(acc, sb[kk], ss[kk], desc_tf32(kt_addr, kk, 0),
                          desc_tf32(kt_addr + kTfColPart, kk, 0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(sb);
    fence_regs(ss);
    __syncthreads();  // stage st read by every warp
    if (tid == 0 && j + kTfStages < n_kt) load_kv_tile(j + kTfStages);
  }

  tf32_store(acc, dq + int64_t(bh) * tq * d, q0 + 16 * warp + g, tq, d, t);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *out, *dout, *lse;
  void *delta, *work, *dq, *dk, *dv;
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

  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  constexpr size_t kv_smem = DkdvLayout<D, BT, BT>::kSmemBytes;
  const auto dkdv = bwd_dkdv_kernel<T, D, BT, BT>;
  static hopper::SmemLimit dkdv_limit, dq_limit;
  if ((err = dkdv_limit.raise(dkdv, dev, kv_smem)) != cudaSuccess) return err;
  dkdv<<<a.bh * n_ktiles, kThreads, kv_smem, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.tq, a.tk, a.d, n_ktiles, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t q_smem = DqLayout<D, BT, BT>::kSmemBytes;
  const auto dqk = bwd_dq_kernel<T, D, BT, BT>;
  if ((err = dq_limit.raise(dqk, dev, q_smem)) != cudaSuccess) return err;
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
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static hopper::SmemLimit dkdv_limit, dq_limit;
  if ((err = dkdv_limit.raise(dkdv, dev, smem)) != cudaSuccess ||
      (err = dq_limit.raise(dqk, dev, smem)) != cudaSuccess)
    return err;
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

// The wgmma designs' three passes (delta in 16-byte pieces, dK/dV, dQ):
// one warpgroup a block (d 33-64: NA 1) or two (d 65-256: NA 2-4 atoms).
template <int NA>
cudaError_t launch_wgmma(const Args& a) {
  const int64_t rows = int64_t(a.bh) * a.tq;
  const int64_t delta_blocks = (rows * 8 + kThreads - 1) / kThreads;
  if (delta_blocks > INT32_MAX) return cudaErrorInvalidValue;
  using hopper::tile_map;
  CUtensorMap qm, km, vm, gm;
  cudaError_t err;
  if ((err = tile_map(&qm, a.q, a.bh, a.tq, a.d)) != cudaSuccess ||
      (err = tile_map(&km, a.k, a.bh, a.tk, a.d)) != cudaSuccess ||
      (err = tile_map(&vm, a.v, a.bh, a.tk, a.d)) != cudaSuccess ||
      (err = tile_map(&gm, a.dout, a.bh, a.tq, a.d)) != cudaSuccess)
    return err;
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  const int n_ktiles = (a.tk + kWgRows - 1) / kWgRows;
  const int n_qtiles = (a.tq + kWgRows - 1) / kWgRows;
  if (int64_t(a.bh) * n_ktiles > INT32_MAX ||
      int64_t(a.bh) * n_qtiles > INT32_MAX)
    return cudaErrorInvalidValue;
  int threads = kWgThreads;
  size_t kv_smem = WgmmaSmem::kBytes, q_smem = WgmmaSmem::kBytes;
  auto dkdv = bwd_dkdv_wgmma_kernel;
  auto dqk = bwd_dq_wgmma_kernel;
  if constexpr (NA > 1) {
    threads = kPairThreads;
    kv_smem = PairSmem<NA, NA>::kBytes;
    q_smem = PairSmem<NA, 2 * ((NA + 1) / 2)>::kBytes;
    dkdv = bwd_dkdv_pair_kernel<NA>;
    dqk = bwd_dq_pair_kernel<NA>;
  }
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  static hopper::SmemLimit dkdv_limit, dq_limit;
  if ((err = dkdv_limit.raise(dkdv, dev, kv_smem)) != cudaSuccess ||
      (err = dq_limit.raise(dqk, dev, q_smem)) != cudaSuccess)
    return err;
  bwd_delta_x8_kernel<<<int(delta_blocks), kThreads, 0, a.stream>>>(
      static_cast<const bf16*>(a.out), static_cast<const bf16*>(a.dout),
      delta, rows, a.d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv<<<a.bh * n_ktiles, threads, kv_smem, a.stream>>>(
      qm, km, vm, gm, lse, delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.tq, a.tk, a.d, n_ktiles, a.scale,
      a.causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dqk<<<a.bh * n_qtiles, threads, q_smem, a.stream>>>(
      qm, km, vm, gm, lse, delta, static_cast<bf16*>(a.dq), a.tq, a.tk, a.d,
      n_qtiles, a.scale, a.causal);
  return cudaGetLastError();
}

// The f32 workspace of the 3xTF32 design, in floats: the split parts of
// q, k, v and dO ([2 bh][t][dp] each) and of q, dO and k transposed ([2
// bh][dp][round8(t)] each).
int64_t tf32_work_floats(int64_t bh, int64_t tq, int64_t tk, int d) {
  const int64_t dp = (d + 7) / 8 * 8;
  const int64_t tqp = (tq + 7) / 8 * 8, tkp = (tk + 7) / 8 * 8;
  return 2 * bh * dp * (2 * tq + 2 * tk + 2 * tqp + tkp);
}

// The 3xTF32 design's passes: split (into `work`), delta, dK/dV, dQ.
cudaError_t launch_tf32(const Args& a) {
  const int dp = (a.d + 7) / 8 * 8;
  const int tqp = (a.tq + 7) / 8 * 8, tkp = (a.tk + 7) / 8 * 8;
  const int64_t bh = a.bh;
  float* nat_q = static_cast<float*>(a.work);
  float* nat_k = nat_q + 2 * bh * a.tq * dp;
  float* nat_v = nat_k + 2 * bh * a.tk * dp;
  float* nat_g = nat_v + 2 * bh * a.tk * dp;
  float* tr_q = nat_g + 2 * bh * a.tq * dp;
  float* tr_g = tr_q + 2 * bh * dp * tqp;
  float* tr_k = tr_g + 2 * bh * dp * tqp;
  const int tiles = ((tqp > tkp ? tqp : tkp) + kTfRows - 1) / kTfRows;
  const int n_ktiles = (a.tk + kTfHeld - 1) / kTfHeld;
  const int n_qtiles = (a.tq + kTfHeld - 1) / kTfHeld;
  const int64_t rows = bh * a.tq;
  const int64_t delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (bh * tiles > INT32_MAX || bh * n_ktiles > INT32_MAX ||
      bh * n_qtiles > INT32_MAX || 2 * bh > INT32_MAX ||
      delta_blocks > INT32_MAX || a.work == nullptr ||
      reinterpret_cast<uintptr_t>(a.work) % 16)
    return cudaErrorInvalidValue;
  const SplitJobs jobs{{{static_cast<const float*>(a.q), nat_q, tr_q, a.tq,
                         tqp},
                        {static_cast<const float*>(a.k), nat_k, tr_k, a.tk,
                         tkp},
                        {static_cast<const float*>(a.v), nat_v, nullptr, a.tk,
                         tkp},
                        {static_cast<const float*>(a.dout), nat_g, tr_g, a.tq,
                         tqp}}};
  split_tf32_kernel<<<dim3(unsigned(bh * tiles), 4), kTfSplitThreads, 0,
                      a.stream>>>(jobs, tiles, a.d, dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* delta = static_cast<float*>(a.delta);
  bwd_delta_kernel<float><<<int(delta_blocks), kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.out), static_cast<const float*>(a.dout),
      delta, rows, a.d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  using hopper::tile_map_f32;
  const int planes = int(2 * bh);
  CUtensorMap km, vm, qm, gm, qtm, gtm, qhm, ghm, krm, vrm, ktm;
  if ((err = tile_map_f32(&km, nat_k, planes, a.tk, dp, kTfHeld)) ||
      (err = tile_map_f32(&vm, nat_v, planes, a.tk, dp, kTfHeld)) ||
      (err = tile_map_f32(&qm, nat_q, planes, a.tq, dp, kTfRows)) ||
      (err = tile_map_f32(&gm, nat_g, planes, a.tq, dp, kTfRows)) ||
      (err = tile_map_f32(&qtm, tr_q, planes, dp, tqp, kTfHeld)) ||
      (err = tile_map_f32(&gtm, tr_g, planes, dp, tqp, kTfHeld)) ||
      (err = tile_map_f32(&qhm, nat_q, planes, a.tq, dp, kTfHeld)) ||
      (err = tile_map_f32(&ghm, nat_g, planes, a.tq, dp, kTfHeld)) ||
      (err = tile_map_f32(&krm, nat_k, planes, a.tk, dp, kTfRows)) ||
      (err = tile_map_f32(&vrm, nat_v, planes, a.tk, dp, kTfRows)) ||
      (err = tile_map_f32(&ktm, tr_k, planes, dp, tkp, kTfHeld)))
    return err;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  static hopper::SmemLimit dkdv_limit, dq_limit;
  if ((err = dkdv_limit.raise(bwd_dkdv_tf32_kernel, dev,
                              TfSmem<true>::kBytes)) != cudaSuccess ||
      (err = dq_limit.raise(bwd_dq_tf32_kernel, dev,
                            TfSmem<false>::kBytes)) != cudaSuccess)
    return err;
  const float* lse = static_cast<const float*>(a.lse);
  bwd_dkdv_tf32_kernel<<<int(bh * n_ktiles), kWgThreads, TfSmem<true>::kBytes,
                         a.stream>>>(km, vm, qm, gm, qtm, gtm, lse, delta,
                                     static_cast<float*>(a.dk),
                                     static_cast<float*>(a.dv), a.tq, a.tk,
                                     a.d, n_ktiles, a.scale, a.causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq_tf32_kernel<<<int(bh * n_qtiles), kWgThreads, TfSmem<false>::kBytes,
                       a.stream>>>(qhm, ghm, krm, vrm, ktm, lse, delta,
                                   static_cast<float*>(a.dq), a.tq, a.tk, a.d,
                                   n_qtiles, a.scale, a.causal);
  return cudaGetLastError();
}

// A check of the two wgmma operand forms alone, one warpgroup, 64 x 64 x
// 64: b_mn_major 0: c = a b^T, a and b [64][64] K-major, both through TMA
// (the form of S and dP); 1: c = a b, a from registers (loaded as the
// fragment of hopper.cuh), b [k][n] through TMA, MN-major (the form of dV,
// dK and dQ).  c is f32 [64][64].
__global__ void __launch_bounds__(kWgThreads)
wgmma_check_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap b_map,
                   const bf16* __restrict__ a, float* __restrict__ c,
                   int b_mn_major) {
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wgmma_smem_base(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + 2 * kWgTileBytes);
  const uint32_t a_addr = warp_mma::smem_addr(base);
  const uint32_t b_addr = a_addr + kWgTileBytes;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * kWgTileBytes);
    tma_load_3d(base, &a_map, bar, 0, 0, 0);
    tma_load_3d(base + kWgTileBytes, &b_map, bar, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float d[32];
  if (!b_mn_major) {
    wgmma_fence();
    wgmma_ss<false>(d, desc_k_major(a_addr, 0), desc_k_major(b_addr, 0));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      wgmma_ss<true>(d, desc_k_major(a_addr, kk), desc_k_major(b_addr, kk));
    wgmma_commit();
    wgmma_wait<0>();
  } else {
    uint32_t frag[4][4];
    const int r = 16 * warp + g;
    auto pair = [&](int row, int col) {
      return *reinterpret_cast<const uint32_t*>(a + row * 64 + col);
    };
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      frag[kk][0] = pair(r, 16 * kk + 2 * t);
      frag[kk][1] = pair(r + 8, 16 * kk + 2 * t);
      frag[kk][2] = pair(r, 16 * kk + 2 * t + 8);
      frag[kk][3] = pair(r + 8, 16 * kk + 2 * t + 8);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    fence_regs(frag);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(d, frag[kk], desc_mn_major(b_addr, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(frag);
  }
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(16 * warp + g + 8 * (e >> 1)) * 64 + 8 * i + 2 * t + (e & 1)] =
          d[4 * i + e];
}

// A check of the 3xTF32 operand forms alone, one warpgroup, 64 x 64 x 64,
// f32: form 0: c = a b^T, a and b [64][64] K-major, both through TMA as
// big and small parts (the form of S and dP); 1: c = a b^T with a from
// registers, loaded as an m64n64 accumulator would hold it and passed on
// in hopper.cuh's fragment order, b [n][k] K-major with k in that
// fragment order within each group of 8 (the form of dV, dK and dQ).  The
// parts arrays hold each operand's big and small parts ([2][64][64]); c is
// f32 [64][64].
__global__ void __launch_bounds__(kWgThreads)
tf32_check_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const float* __restrict__ a, float* __restrict__ c,
                  int form) {
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wgmma_smem_base(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + 4 * kTfHeldPart);
  const uint32_t a_addr = warp_mma::smem_addr(base);
  const uint32_t b_addr = a_addr + 2 * kTfHeldPart;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 4 * kTfHeldPart);
    for (int part = 0; part < 2; ++part)
      for (int at = 0; at < 2; ++at) {
        tma_load_3d(base + part * kTfHeldPart + at * kTfHeldAtom, &a_map, bar,
                    32 * at, 0, part);
        tma_load_3d(base + (2 + part) * kTfHeldPart + at * kTfHeldAtom,
                    &b_map, bar, 32 * at, 0, part);
      }
  }
  mbar_wait(bar, 0);
  float d[32];
  if (form == 0) {
    wgmma_fence();
    tf32x3_ss_d64<64>(d, a_addr, kTfHeldPart, kTfHeldAtom, b_addr,
                      kTfHeldPart, kTfHeldAtom);
    wgmma_commit();
    wgmma_wait<0>();
  } else {
    uint32_t big[8][4], small[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // accumulator element e of chunk kk
        const float x = a[(16 * warp + g + 8 * (e >> 1)) * 64 + 8 * kk +
                          2 * t + (e & 1)];
        const int r = 2 * (e & 1) + (e >> 1);
        tf32_split(x, big[kk][r], small[kk][r]);
      }
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    fence_regs(big);
    fence_regs(small);
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_tf32x3_rs<64>(d, big[kk], small[kk],
                          desc_tf32(b_addr, kk, kTfHeldAtom),
                          desc_tf32(b_addr + kTfHeldPart, kk, kTfHeldAtom));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(big);
    fence_regs(small);
  }
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(16 * warp + g + 8 * (e >> 1)) * 64 + 8 * i + 2 * t + (e & 1)] =
          d[4 * i + e];
}

// The backward's designs, as flash_attention.py's bwd_design names them.
// (kWgmmaWide is the forward's alone.)
enum Design {
  kScalar = 0,
  kMmaSync = 1,
  kWgmma = 2,
  kWide = 3,
  kWgmmaTf32 = 4,
  kWgmmaWide = 5,
  kWgmmaPair = 6
};

// The design that takes a head of (padded) width d.
Design design(bool is_bf16, int d) {
  if (d > 256) return kWide;
  if (is_bf16 && d <= 32) return kMmaSync;
  if (is_bf16 && d <= 64) return kWgmma;
  if (is_bf16) return kWgmmaPair;
  if (d <= 64) return kWgmmaTf32;
  return kScalar;
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
  if (a.bh < 1 || a.tq < 1 || a.tk < 1 || a.d < 1)
    return cudaErrorInvalidValue;
  const Design des = design(std::is_same<T, bf16>::value, a.d);
  if (des == kWgmmaTf32) return launch_tf32(a);  // with its own delta pass
  if (des == kMmaSync || des == kWgmma || des == kWgmmaPair) {
    // the tensor cores take rows of whole 16-byte pieces, 16-byte
    // aligned, by cp.async or TMA (the wrapper pads d and copies a
    // misaligned view)
    const uintptr_t addr =
        reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
        reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.out) |
        reinterpret_cast<uintptr_t>(a.dout) |
        reinterpret_cast<uintptr_t>(a.dq) |
        reinterpret_cast<uintptr_t>(a.dk) | reinterpret_cast<uintptr_t>(a.dv);
    if (a.d % 8 || addr % 16) return cudaErrorInvalidValue;
    // with their own delta pass
    if (des == kWgmma) return launch_wgmma<1>(a);
    if (des == kWgmmaPair)
      return a.d <= 128 ? launch_wgmma<2>(a)
             : a.d <= 192 ? launch_wgmma<3>(a) : launch_wgmma<4>(a);
  }
  const int64_t rows = int64_t(a.bh) * a.tq;
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  bwd_delta_kernel<T><<<int(blocks), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout),
      static_cast<float*>(a.delta), rows, a.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, bf16>::value) {
    if (des == kMmaSync) return a.d <= 16 ? launch_mma<16>(a)
                                          : launch_mma<32>(a);
  } else {
    if (a.d <= 128) return launch_small<T, 128, 64>(a);
    if (a.d <= 256) return launch_small<T, 256, 32>(a);
  }
  return launch_wide<T>(a);
}

}  // namespace

// Plain C entry points, bound with ctypes.  Take any d >= 1 and
// contiguous [BH, T, d] tensors of the entry's dtype (bf16 with d <= 256:
// d a multiple of 8 and every pointer 16-byte aligned); `delta` is f32
// scratch of BH * Tq floats, `work` f32 scratch of
// flash_attention_bwd_work_floats floats (16-byte aligned; null where
// that is 0).  Launch on `stream` (the 3xTF32 design's split, then delta,
// dK/dV, dQ), do not synchronise, allocate nothing; return the first
// failing launch's cudaError_t (0 on success).
#define FLASH_BWD_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* out, const void* dout, const void* lse,   \
                      void* delta, void* work, void* dq, void* dk,          \
                      void* dv, int bh, int tq, int tk, int d, int causal,  \
                      float scale, void* stream) {                          \
    const Args a{q,  k,  v,  out, dout,   lse,   delta, work, dq,           \
                 dk, dv, bh, tq,  tk, d, causal, scale,                     \
                 static_cast<cudaStream_t>(stream)};                        \
    return launch<T>(a);                                                    \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_f32, float)
FLASH_BWD_ENTRY(flash_attention_bwd_bf16, __nv_bfloat16)

// The design (Design above) the bf16 (is_bf16 != 0) or f32 entry takes for
// a head of width d.
extern "C" int flash_attention_bwd_design(int is_bf16, int d) {
  return design(is_bf16 != 0, d);
}

// The floats of `work` the bf16 (is_bf16 != 0) or f32 entry needs at these
// sizes: the 3xTF32 design's split parts, else 0.
extern "C" long long flash_attention_bwd_work_floats(int is_bf16, int bh,
                                                     int tq, int tk, int d) {
  if (design(is_bf16 != 0, d) != kWgmmaTf32) return 0;
  return tf32_work_floats(bh, tq, tk, d);
}

// wgmma_check_kernel on bf16 [64][64] a and b, writing f32 [64][64] c, on
// `stream`; returns the first failing call's cudaError_t.
extern "C" int flash_attention_bwd_wgmma_check(const void* a, const void* b,
                                               void* c, int b_mn_major,
                                               void* stream) {
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return cudaErrorInvalidValue;
  using hopper::tile_map;
  CUtensorMap am, bm;
  cudaError_t err;
  if ((err = tile_map(&am, a, 1, 64, 64)) != cudaSuccess ||
      (err = tile_map(&bm, b, 1, 64, 64)) != cudaSuccess)
    return err;
  const size_t smem = 2 * kWgTileBytes + sizeof(uint64_t) + 1024;
  wgmma_check_kernel<<<1, kWgThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      am, bm, static_cast<const bf16*>(a), static_cast<float*>(c),
      b_mn_major);
  return cudaGetLastError();
}

// tf32_check_kernel on f32 [64][64] a (and its parts [2][64][64] in
// a_parts) and b's parts b_parts [2][64][64], writing f32 [64][64] c, on
// `stream`; returns the first failing call's cudaError_t.
extern "C" int flash_attention_bwd_tf32_check(const void* a,
                                              const void* a_parts,
                                              const void* b_parts, void* c,
                                              int form, void* stream) {
  if ((reinterpret_cast<uintptr_t>(a_parts) |
       reinterpret_cast<uintptr_t>(b_parts)) %
      16)
    return cudaErrorInvalidValue;
  using hopper::tile_map_f32;
  CUtensorMap am, bm;
  cudaError_t err;
  if ((err = tile_map_f32(&am, a_parts, 2, 64, 64, kTfHeld)) != cudaSuccess ||
      (err = tile_map_f32(&bm, b_parts, 2, 64, 64, kTfHeld)) != cudaSuccess)
    return err;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  const size_t smem = 4 * kTfHeldPart + sizeof(uint64_t) + 1024;
  static hopper::SmemLimit limit;
  if ((err = limit.raise(tf32_check_kernel, dev, smem)) != cudaSuccess)
    return err;
  tf32_check_kernel<<<1, kWgThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      am, bm, static_cast<const float*>(a), static_cast<float*>(c), form);
  return cudaGetLastError();
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
