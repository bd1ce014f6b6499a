// Fused softmax cross-entropy over a vocabulary head, for Hopper (sm_90a).
//
// Replaces analytics_zoo_tpu/ops/fused_xent.py::_fused (the custom_vjp whose
// forward is _fused_fwd_impl and backward _fused_bwd).  For h [N, D] (bf16 or
// f32), W [D, V] (cast to h's dtype for the products), an f32 bias [V] and
// int64 labels [N]:
//   forward:  S = h W + b in f32, never written; lse[n] = logsumexp_v S[n, v]
//             (f32), loss = mean_n (lse[n] - S[n, label[n]]) (f32);
//   backward: dl = exp(S - lse) * (g / N) less g / N at the label, rounded
//             to h's dtype; dh = dl W^T (h's dtype); dW = h^T dl (f32 sums,
//             then w's dtype); db = the column sums of the f32 dl.
//
// What bounds it.  The forward is 2 N D V FLOP, the backward 6 N D V (the
// logits recomputed, then dh and dW), against h and W read once and dh, dW
// written once: at BERT-base's head (N 2048, D 768, V 30522) 9.6e10 and
// 2.9e11 FLOP for about 100 and 190 MB, so the tensor cores bound it (0.097
// and 0.291 ms at 989 TFLOP/s), not the memory (0.03 and 0.06 ms).
//
// Two designs of the backward (`bwd_design` below; ops/fused_xent.py's
// bwd_design names it), and one of the forward:
//
// wgmma, the bf16 backward (h bf16, W bf16 or f32): three products over
// every token, one launch each, on wgmma m64n128k16 fed by a TMA ring.
//   * a block is two warpgroups (256 threads) owning a 128 x 128 output
//     tile, each warpgroup 64 rows; 64-deep k slices of both operands
//     arrive as four 64 x 64 boxes (8 KB, the 128-byte swizzle, 1024-byte
//     aligned) in a ring of kWgStages stages, each completed on an
//     mbarrier; thread 0 refills the stage the products of the step before
//     read, once a block barrier shows both warpgroups done with it (one
//     group of products stays in flight across the barrier).  At 3 stages
//     (96 KB) and at most 128 registers two blocks share an SM, so one
//     block's epilogue overlaps the other's products;
//   * the three products read their operands in the three forms wgmma
//     takes: S = h W (h K-major, the packed W [D][round8(V)] MN-major),
//     dh = dl W^T (dl and W both K-major: W read as [n = d][k = v]), dW =
//     h^T dl (h and dl both MN-major: h is stored [token][d]);
//   * the dl pass recomputes S per tile (K = D) and writes dl = the
//     formula above in bf16 to a workspace [N][round8(V)] (zeros in the
//     pad columns), staged through shared memory for 16-byte stores, and
//     db's column partials per token tile; the dh pass splits the
//     vocabulary (K) so that the [N, D] output fills the card, f32
//     partials summed in split order by a reduce kernel; the dW pass runs
//     K = N, so every dW tile's f32 sum stays in registers from the first
//     token to the last and is written once, in W's dtype;
//   * grid order: token tiles fastest in the dl pass (the blocks sharing a
//     W tile run together; h stays in L2), d tiles fastest in the dW and
//     dh passes (the blocks sharing a dl tile run together);
//   * ragged edges read as zeros (TMA's out-of-bounds fill; the pack
//     kernel zeroes W's and h's pad columns); stores are masked to N, D, V.
//   Workspace (the wrapper's): dl [N][round8(V)] bf16, dh's partials
//   [splits][N][D] f32, db's [cdiv(N, 128)][V] f32, the packed W (f32 W or
//   V not a multiple of 8) and h (D not a multiple of 8); they grow with N.
//
// scalar, the f32 backward, and the forward of both dtypes: one main loop
// over 128 x 128 output tiles with 256 threads: bf16 operands (the
// forward's) on mma.sync m16n8k16 (f32 accumulate; 8 warps as 2 x 4, 64 x
// 32 each), their 32-deep k slices double-buffered in shared memory by
// 16-byte cp.async copies that zero-fill the ragged edges; f32 operands on
// scalar f32 FMAs (exact products, as JAX's f32 dot), 8 x 8 outputs a
// thread.  Its epilogues: the forward's row statistics (per token and
// vocabulary tile: the max, the sum of exp(S - max) and the label's logit,
// from the same f32 S); and, per chunk of tokens (the API's `chunk`, as the
// JAX op scans), dl into a [chunk][V] workspace with db's column sums,
// dh's split-K partials and dW's running sum (in dw itself when W is f32,
// else an f32 [D][V] buffer).
//
// No atomics anywhere.  The forward writes per-tile partials that a
// finalize kernel combines per token in tile order (online max rescaling),
// then one block reduces the mean; dh's splits and db's tiles are summed in
// order; each dW tile is owned by one block.  Two runs give identical bits.
// What it leaves: a producer warp and persistent blocks that overlap a
// tile's epilogue with the next tile's products, the forward and the f32
// backward on wgmma, and fusing the dh and dW products so that dl never
// leaves the chip.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace warp_mma;

constexpr int kTile = 128;     // output tile: rows and columns
constexpr int kThreads = 256;
constexpr int kBK = 32;        // tensor-core route: k per shared stage
constexpr int kBKs = 16;       // scalar route: k per shared stage
constexpr int kSlots = 16;     // threads that share one row (or column)
constexpr int kSmemBytes = 40960;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// c += a * b for m tile mt and n tile nt of acc (see TensorCores)
__device__ __forceinline__ void mma_at(float (&acc)[8][8], int mt, int nt,
                                       const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[2 * mt][2 * nt]), "+f"(acc[2 * mt][2 * nt + 1]),
        "+f"(acc[2 * mt + 1][2 * nt]), "+f"(acc[2 * mt + 1][2 * nt + 1])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ROWS x COLS tile at (r0, c0) of a row-major matrix of `ld` elements a row
// into shared rows of COLS + 8 (the 16-byte pad puts the eight row addresses
// of every ldmatrix in distinct bank groups); rows >= r_lim and 8-element
// chunks at columns >= c_lim are zero-filled, never read.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_async(bf16* s, const bf16* g, int ld,
                                           int r0, int r_lim, int c0,
                                           int c_lim) {
  constexpr int kChunks = COLS / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "tile shape");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = r0 + r < r_lim && c0 + col < c_lim;
    const bf16* src = ok ? g + size_t(r0 + r) * ld + c0 + col : g;
    cp_async_16(s + r * (COLS + 8) + col, src, ok);
  }
}

// bf16 operands on the tensor cores (the forward's).  acc[i][j] is element
// (row(i), col(j)) of the block's tile: warp w = 4 wm + wn holds rows
// [64 wm, 64 wm + 64) and columns [32 wn, 32 wn + 32) as 4 x 4 m16n8 tiles,
// whose C fragments (warp_mma.cuh) put rows g and g + 8, columns 2t and
// 2t + 1 in each lane.
struct TensorCores {
  __device__ static int row(int i) {
    return (threadIdx.x >> 7) * 64 + (i >> 1) * 16 + (i & 1) * 8 +
           ((threadIdx.x & 31) >> 2);
  }
  __device__ static int col(int j) {
    return ((threadIdx.x >> 5) & 3) * 32 + (j >> 1) * 8 +
           2 * (threadIdx.x & 3) + (j & 1);
  }
  // this thread's place among the 16 that share each of its rows
  __device__ static int row_slot() {
    return ((threadIdx.x >> 5) & 3) * 4 + (threadIdx.x & 3);
  }

  // acc = A[m0.., k0..k1) B[k0..k1), n0..]: A stored [m][k], B stored
  // [k][n]; rows/columns of m >= m_lim, n >= n_lim and k >= k1 read as
  // zero.
  template <bool kAT, bool kBT, typename TA, typename TB>
  __device__ static void mainloop(float (&acc)[8][8], const TA* A, int lda,
                                  int m0, int m_lim, const TB* B, int ldb,
                                  int n0, int n_lim, int k0, int k1,
                                  unsigned char* smem_raw) {
    static_assert(!kAT && !kBT, "the forward's operand forms only");
    constexpr int SA = kBK + 8;
    constexpr int SB = kTile + 8;
    constexpr int kStage = kTile * (kBK + 8);  // >= kBK * (kTile + 8)
    static_assert(4 * kStage * sizeof(bf16) <= kSmemBytes, "shared memory");
    bf16* As = reinterpret_cast<bf16*>(smem_raw);  // two stages
    bf16* Bs = As + 2 * kStage;                    // two stages
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    auto load = [&](int st, int k) {
      bf16* as = As + st * kStage;
      bf16* bs = Bs + st * kStage;
      load_async<kTile, kBK>(as, A, lda, m0, m_lim, k, k1);
      load_async<kBK, kTile>(bs, B, ldb, k, k1, n0, n_lim);
      cp_async_commit();
    };

    const int nk = k1 > k0 ? (k1 - k0 + kBK - 1) / kBK : 0;
    if (nk > 0) load(0, k0);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        load((kt + 1) & 1, k0 + (kt + 1) * kBK);
        cp_async_wait<1>();  // everything but slice kt + 1 has landed
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // ... for every thread's copies
      const bf16* as = As + (kt & 1) * kStage;
      const bf16* bs = Bs + (kt & 1) * kStage;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4(a[mt], as + (wm * 64 + mt * 16 + (lane & 15)) * SA +
                                 ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SB +
                     wn * 32 + nb * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma_at(acc, mt, 2 * nb, a[mt], b[0], b[1]);
            mma_at(acc, mt, 2 * nb + 1, a[mt], b[2], b[3]);
          }
        }
      }
      __syncthreads();  // stage kt & 1 fully read before it is refilled
    }
  }
};

// f32 (or bf16, read as f32) operands on scalar FMAs: thread (ty, tx) holds
// rows ty + 16 i and columns tx + 16 j of the tile.
struct ScalarF32 {
  __device__ static int row(int i) { return (threadIdx.x >> 4) + 16 * i; }
  __device__ static int col(int j) { return (threadIdx.x & 15) + 16 * j; }
  __device__ static int row_slot() { return threadIdx.x & 15; }
  __device__ static int col_slot() { return threadIdx.x >> 4; }

  template <bool kAT, bool kBT, typename TA, typename TB>
  __device__ static void mainloop(float (&acc)[8][8], const TA* A, int lda,
                                  int m0, int m_lim, const TB* B, int ldb,
                                  int n0, int n_lim, int k0, int k1,
                                  unsigned char* smem_raw) {
    constexpr int S = kTile + 4;
    static_assert(2 * kBKs * S * sizeof(float) <= kSmemBytes, "shared memory");
    float* As = reinterpret_cast<float*>(smem_raw);  // [k][m]
    float* Bs = As + kBKs * S;                       // [k][n]
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k = k0; k < k1; k += kBKs) {
      // consecutive threads on the operand's contiguous dimension
#pragma unroll
      for (int i = 0; i < kTile * kBKs / kThreads; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int am = kAT ? e % kTile : e / kBKs;
        const int ak = kAT ? e / kTile : e % kBKs;
        const bool aok = m0 + am < m_lim && k + ak < k1;
        As[ak * S + am] =
            aok ? to_f(kAT ? A[size_t(k + ak) * lda + m0 + am]
                           : A[size_t(m0 + am) * lda + k + ak])
                : 0.f;
        const int bn = kBT ? e / kBKs : e % kTile;
        const int bk = kBT ? e % kBKs : e / kTile;
        const bool bok = n0 + bn < n_lim && k + bk < k1;
        Bs[bk * S + bn] =
            bok ? to_f(kBT ? B[size_t(n0 + bn) * ldb + k + bk]
                           : B[size_t(k + bk) * ldb + n0 + bn])
                : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBKs; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[kk * S + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[kk * S + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
};

// -- forward ---------------------------------------------------------------

// One 128-token x 128-column tile of S = h W + b (blockIdx.x: tokens,
// blockIdx.y: vocabulary tile): per token the tile's max, sum of
// exp(S - max) and, where the label falls in the tile, its logit (else 0),
// as part[q][tile][token] for q = 0, 1, 2.  The logits never leave the chip.
template <class E, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
xent_fwd_tiles(const TA* h, int ldh, const TB* w, int ldw, int w_lim,
               const float* __restrict__ bias,
               const int64_t* __restrict__ labels, int n, int d, int v,
               float* __restrict__ part) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  float acc[8][8];
  E::template mainloop<false, false>(acc, h, ldh, m0, n, w, ldw, n0, w_lim, 0,
                                     d, smem);
  // [3][kTile rows][kSlots]: each thread's part of its rows
  float* red = reinterpret_cast<float*>(smem);
  const int slot = E::row_slot();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = E::row(i);
    const int64_t lab = m0 + r < n ? labels[m0 + r] : -1;
    float mx = -INFINITY, lab_logit = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + E::col(j);
      if (c < v) {
        acc[i][j] += bias[c];
        mx = fmaxf(mx, acc[i][j]);
        if (c == lab) lab_logit = acc[i][j];
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (n0 + E::col(j) < v) sum += expf(acc[i][j] - mx);
    red[(0 * kTile + r) * kSlots + slot] = mx;
    red[(1 * kTile + r) * kSlots + slot] = sum;
    red[(2 * kTile + r) * kSlots + slot] = lab_logit;
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < kTile && m0 + r < n) {
    float mx = -INFINITY, sum = 0.f, lab_logit = 0.f;
    for (int s = 0; s < kSlots; ++s)
      mx = fmaxf(mx, red[(0 * kTile + r) * kSlots + s]);
    for (int s = 0; s < kSlots; ++s) {
      const float ms = red[(0 * kTile + r) * kSlots + s];
      if (ms != -INFINITY)
        sum += red[(1 * kTile + r) * kSlots + s] * expf(ms - mx);
      lab_logit += red[(2 * kTile + r) * kSlots + s];
    }
    const size_t tiles = gridDim.y, t = blockIdx.y;
    part[(0 * tiles + t) * n + m0 + r] = mx;
    part[(1 * tiles + t) * n + m0 + r] = sum;
    part[(2 * tiles + t) * n + m0 + r] = lab_logit;
  }
}

// Per token, the vocabulary tiles' partials combined in tile order: 32
// tokens a block, 8 groups of threads over the tiles, then the groups in
// order.  lse = max + log(sum); the token's loss is lse - logit[label].
__global__ void __launch_bounds__(kThreads)
xent_fwd_finalize(const float* __restrict__ part, int tiles, int n,
                  float* __restrict__ lse, float* __restrict__ loss_tok) {
  __shared__ float red[3][8][33];
  const int tl = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int tok = blockIdx.x * 32 + tl;
  float m = -INFINITY, l = 0.f, lab = 0.f;
  if (tok < n) {
    for (int t = grp; t < tiles; t += 8) {
      const float mt = part[size_t(t) * n + tok];
      const float lt = part[size_t(tiles + t) * n + tok];
      lab += part[size_t(2 * tiles + t) * n + tok];
      const float mn = fmaxf(m, mt);
      l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + lt * expf(mt - mn);
      m = mn;
    }
  }
  red[0][grp][tl] = m;
  red[1][grp][tl] = l;
  red[2][grp][tl] = lab;
  __syncthreads();
  if (grp == 0 && tok < n) {
    float mx = -INFINITY, sum = 0.f, lab_logit = 0.f;
    for (int q = 0; q < 8; ++q) mx = fmaxf(mx, red[0][q][tl]);
    for (int q = 0; q < 8; ++q) {
      if (red[0][q][tl] != -INFINITY)
        sum += red[1][q][tl] * expf(red[0][q][tl] - mx);
      lab_logit += red[2][q][tl];
    }
    const float ls = mx + logf(sum);
    lse[tok] = ls;
    loss_tok[tok] = ls - lab_logit;
  }
}

// The mean of the tokens' losses: one block, a fixed order.
__global__ void __launch_bounds__(1024)
xent_mean(const float* __restrict__ loss_tok, int n,
          float* __restrict__ loss) {
  __shared__ float red[1024];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += 1024) s += loss_tok[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int width = 512; width > 0; width >>= 1) {
    if (threadIdx.x < width) red[threadIdx.x] += red[threadIdx.x + width];
    __syncthreads();
  }
  if (threadIdx.x == 0) *loss = red[0] / float(n);
}

// -- backward, f32: per chunk, the scalar main loop --------------------------

// Pass 1, one chunk of `rows` tokens: S recomputed per tile, then
// dl = exp(S - lse) * scale less scale at the label (scale = g / n_total),
// stored in TD (h's dtype) to dl[rows][ldl] (zeros in the columns
// v <= c < ldl), and the tile's column sums of the f32 dl as row
// dbp_row0 + blockIdx.x of dbp[][v].
template <class E, typename TA, typename TB, typename TD>
__global__ void __launch_bounds__(kThreads)
xent_bwd_dl(const TA* h, int ldh, const TB* w, int ldw, int w_lim,
            const float* __restrict__ bias, const int64_t* __restrict__ labels,
            const float* __restrict__ lse, const float* __restrict__ g,
            int n_total, int rows, int d, int v, TD* __restrict__ dl, int ldl,
            float* __restrict__ dbp, int dbp_row0) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  float acc[8][8];
  E::template mainloop<false, false>(acc, h, ldh, m0, rows, w, ldw, n0, w_lim,
                                     0, d, smem);
  const float scale = g[0] / float(n_total);
  float colsum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) colsum[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + E::row(i);
    if (r >= rows) continue;
    const float ls = lse[r];
    const int64_t lab = labels[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + E::col(j);
      float x = 0.f;
      if (c < v) {
        x = expf(acc[i][j] + bias[c] - ls) * scale;
        if (c == lab) x += -scale;
        colsum[j] += x;
      }
      acc[i][j] = x;
    }
    TD* out = dl + size_t(r) * ldl;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + E::col(j);
      if (c < ldl) out[c] = from_f<TD>(acc[i][j]);
    }
  }
  float* red = reinterpret_cast<float*>(smem);  // [kTile columns][kSlots]
  const int slot = E::col_slot();
#pragma unroll
  for (int j = 0; j < 8; ++j) red[E::col(j) * kSlots + slot] = colsum[j];
  __syncthreads();
  const int c = threadIdx.x;
  if (c < kTile && n0 + c < v) {
    float s = 0.f;
    for (int q = 0; q < kSlots; ++q) s += red[c * kSlots + q];
    dbp[size_t(dbp_row0 + blockIdx.x) * v + n0 + c] = s;
  }
}

// Pass 2, one chunk: dh_c = dl W^T over the vocabulary range of split
// blockIdx.z, as f32 partials part[split][rows][d].
template <class E, typename TD, typename TB>
__global__ void __launch_bounds__(kThreads)
xent_bwd_dh(const TD* dl, int ldl, const TB* w, int ldw, int rows, int d,
            int k_lim, int split_len, float* __restrict__ part) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int k0 = blockIdx.z * split_len;
  const int k1 = min(k0 + split_len, k_lim);
  float acc[8][8];
  E::template mainloop<false, true>(acc, dl, ldl, m0, rows, w, ldw, n0, d, k0,
                                    k1, smem);
  float* out = part + size_t(blockIdx.z) * rows * d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + E::row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + E::col(j);
      if (r < rows && c < d) out[size_t(r) * d + c] = acc[i][j];
    }
  }
}

// dh = the sum of the splits' partials, in split order, in TH (both
// designs).
template <typename TH>
__global__ void xent_dh_reduce(const float* __restrict__ part, int splits,
                               size_t count, TH* __restrict__ dh) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < count;
       i += size_t(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * count + i];
    dh[i] = from_f<TH>(s);
  }
}

// Pass 3, one chunk: dW[d][v] += h_c^T dl, each 128 x 128 tile owned by one
// block.  The first chunk writes, later ones add to acc_buf (f32); the last
// writes out in w's dtype (acc_buf and out may be one f32 buffer).
template <class E, typename TA, typename TD, typename TO>
__global__ void __launch_bounds__(kThreads)
xent_bwd_dw(const TA* h, int ldh, int h_lim, const TD* dl, int ldl,
            int dl_lim, int rows, int d, int v, float* acc_buf, TO* out,
            int first, int last) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  float acc[8][8];
  E::template mainloop<true, false>(acc, h, ldh, m0, h_lim, dl, ldl, n0,
                                    dl_lim, 0, rows, smem);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + E::row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + E::col(j);
      if (r < d && c < v) {
        const size_t idx = size_t(r) * v + c;
        float x = acc[i][j];
        if (!first) x = acc_buf[idx] + x;
        if (last)
          out[idx] = from_f<TO>(x);
        else
          acc_buf[idx] = x;
      }
    }
  }
}

// db[c] = the sum of the token tiles' partials, in tile order.
__global__ void xent_db(const float* __restrict__ dbp, int tiles, int v,
                        float* __restrict__ db) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < v) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += dbp[size_t(t) * v + c];
    db[c] = s;
  }
}

// dst[r][c] = bf16(src[r][c]) for c < cols, 0 for cols <= c < ld.
template <typename T>
__global__ void xent_pack(const T* __restrict__ src, int rows, int cols,
                          bf16* __restrict__ dst, int ld) {
  const size_t total = size_t(rows) * ld;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const size_t r = i / ld;
    const int c = int(i - r * ld);
    dst[i] = __float2bfloat16_rn(c < cols ? to_f(src[r * cols + c]) : 0.f);
  }
}

// -- backward, bf16: wgmma fed by a TMA ring -------------------------------

constexpr int kWgThreads = 256;  // two warpgroups, 64 output rows each
constexpr int kWgBK = 64;        // k per stage: one 128-byte swizzle atom
// Stages of the ring: at 3 two blocks share an SM; 2 stages ran 11% slower
// at the recipe's shape, 4 (one block an SM) 5% slower (PERF.md).
constexpr int kWgStages = 3;
constexpr uint32_t kWgBox = 64 * 64 * sizeof(bf16);  // one TMA box, 8 KB
constexpr uint32_t kWgStageBytes = 4 * kWgBox;       // A: 2 boxes, B: 2
// the stages, their mbarriers and the 1024-byte alignment of the base
constexpr size_t kWgSmemBytes =
    kWgStages * kWgStageBytes + kWgStages * sizeof(uint64_t) + 1024;
constexpr int kWgBlocksPerSm = 2;
static_assert(kWgBlocksPerSm * kWgSmemBytes <= 227 * 1024, "shared memory");

// The block's 1024-aligned shared memory.
__device__ __forceinline__ unsigned char* wg_base(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// acc = A B over k slices [k0, k0 + 64 nk) for the block's 128 x 128 tile
// at (m0, n0): thread (warpgroup w, warp wi, lane 4 g + t) holds rows 64 w
// + 16 wi + g + 8 (e >> 1) and columns 8 i + 2 t + (e & 1) as acc[4 i + e].
// Each stage holds A's two 64-row halves (warpgroup w reads half w) and B's
// 128 columns as two boxes.  A is read K-major from a map over [m][k]
// (kAT false) or MN-major from one over [k][m] (kAT true); likewise B from
// [n][k] (kBT false) or [k][n] (kBT true).  Rows and columns outside a map
// read as zeros.
template <bool kAT, bool kBT>
__device__ __forceinline__ void wg_mainloop(float (&acc)[64],
                                            const CUtensorMap* a_map,
                                            const CUtensorMap* b_map, int m0,
                                            int n0, int k0, int nk,
                                            unsigned char* base) {
  using namespace hopper;
  const int tid = threadIdx.x, wg = tid >> 7;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + kWgStages * kWgStageBytes);
  const uint32_t sbase = smem_addr(base);
  auto load = [&](int j) {  // one thread: k slice j into stage j % stages
    const int st = j % kWgStages, k = k0 + j * kWgBK;
    unsigned char* s = base + st * kWgStageBytes;
    mbar_expect_tx(&full[st], kWgStageBytes);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tma_load_3d(s + i * kWgBox, a_map, &full[st],
                  kAT ? m0 + 64 * i : k, kAT ? k : m0 + 64 * i, 0);
      tma_load_3d(s + (2 + i) * kWgBox, b_map, &full[st],
                  kBT ? n0 + 64 * i : k, kBT ? k : n0 + 64 * i, 0);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kWgStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < kWgStages && j < nk; ++j) load(j);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kWgStages;
    mbar_wait(&full[st], (kt / kWgStages) & 1);
    const uint32_t a_addr = sbase + st * kWgStageBytes + wg * kWgBox;
    const uint32_t b_addr = sbase + st * kWgStageBytes + 2 * kWgBox;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      const uint64_t a = kAT ? desc_sw128(a_addr + 2048 * kk, kWgBox, 1024)
                             : desc_k_major(a_addr, kk);
      const uint64_t b = kBT ? desc_sw128(b_addr + 2048 * kk, kWgBox, 1024)
                             : desc_k_major(b_addr, kk);
      wgmma_ss_n128<kAT, kBT>(acc, a, b);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products of step kt - 1 are done
    fence_regs(acc);
    __syncthreads();  // ... in both warpgroups: refill their stage
    if (tid == 0 && kt >= 1 && kt - 1 + kWgStages < nk)
      load(kt - 1 + kWgStages);
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// This thread's place in the tile: row 64 w + 16 wi + g (+ 8), column 2 t.
struct WgPos {
  int row, col;
  __device__ WgPos()
      : row((threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2)),
        col(2 * (threadIdx.x & 3)) {}
};

// out[r][c] = acc for r < m_lim, c < n_lim (row stride ld), in TO; two
// columns a store where ld is even.
template <typename TO>
__device__ __forceinline__ void wg_store(const float (&acc)[64], TO* out,
                                         int ld, int m0, int m_lim, int n0,
                                         int n_lim) {
  const WgPos p;
  const bool paired = (ld & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + p.row + 8 * h;
    if (r >= m_lim) continue;
    TO* o = out + size_t(r) * ld;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = n0 + 8 * i + p.col;
      const float x0 = acc[4 * i + 2 * h], x1 = acc[4 * i + 2 * h + 1];
      if (paired && c + 1 < n_lim) {
        if constexpr (sizeof(TO) == 4)
          *reinterpret_cast<float2*>(o + c) = make_float2(x0, x1);
        else
          *reinterpret_cast<uint32_t*>(o + c) = pack_bf16(x0, x1);
      } else {
        if (c < n_lim) o[c] = from_f<TO>(x0);
        if (c + 1 < n_lim) o[c + 1] = from_f<TO>(x1);
      }
    }
  }
}

// The dl pass: blockIdx.x a token tile, blockIdx.y a vocabulary tile.  S =
// h W over the (padded) width dp, then dl = exp(S + b - lse) * scale less
// scale at the label (scale = g / n), 0 past V or N; dl in bf16 to dl[n][ldl]
// (ldl = round8(V), its pad columns zero) and the tile's column sums of the
// f32 dl as row blockIdx.x of dbp[][v].
__global__ void __launch_bounds__(kWgThreads, kWgBlocksPerSm)
xent_wg_dl(const __grid_constant__ CUtensorMap h_map,
           const __grid_constant__ CUtensorMap w_map, int dp,
           const float* __restrict__ bias, const int64_t* __restrict__ labels,
           const float* __restrict__ lse, const float* __restrict__ g, int n,
           int v, bf16* __restrict__ dl, int ldl, float* __restrict__ dbp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wg_base(smem_raw);
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  float acc[64];
  wg_mainloop<false, true>(acc, &h_map, &w_map, m0, n0, 0,
                           (dp + kWgBK - 1) / kWgBK, base);
  const WgPos p;
  const float scale = g[0] / float(n);
  float ls[2];
  int64_t lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + p.row + 8 * h;
    ls[h] = r < n ? lse[r] : 0.f;
    lab[h] = r < n ? labels[r] : -1;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = n0 + 8 * i + p.col + u;
      const float bc = c < v ? bias[c] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = 0.f;
        if (c < v && m0 + p.row + 8 * h < n) {
          x = expf(acc[4 * i + 2 * h + u] + bc - ls[h]) * scale;
          if (c == lab[h]) x += -scale;
        }
        acc[4 * i + 2 * h + u] = x;
      }
    }
  // the bf16 tile through the ring's first 32 KB (two 64-column halves, in
  // the 128-byte swizzle: no bank conflicts), once both warpgroups' products
  // are done; the column sums' [8 warps][128] after it
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<uint32_t*>(
          base + (i >> 3) * (kTile * 128) +
          hopper::swizzled(p.row + 8 * h, 8 * (i & 7) + p.col)) =
          pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  float* red = reinterpret_cast<float*>(base + 2 * kTile * 128);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float cs = acc[4 * i + u] + acc[4 * i + 2 + u];
      cs += __shfl_xor_sync(0xffffffffu, cs, 4);
      cs += __shfl_xor_sync(0xffffffffu, cs, 8);
      cs += __shfl_xor_sync(0xffffffffu, cs, 16);
      if (lane < 4) red[warp * kTile + 8 * i + p.col + u] = cs;
    }
  __syncthreads();
  // 16-byte stores: a row's 256 bytes by 16 consecutive threads
#pragma unroll
  for (int j = 0; j < kTile * kTile / 8 / kWgThreads; ++j) {
    const int c = threadIdx.x + j * kWgThreads;
    const int row = c >> 4, half = (c >> 3) & 1, col = (c & 7) * 8;
    const int gc = n0 + 64 * half + col;
    if (m0 + row < n && gc < ldl)
      *reinterpret_cast<uint4*>(dl + size_t(m0 + row) * ldl + gc) =
          *reinterpret_cast<const uint4*>(base + half * (kTile * 128) +
                                          hopper::swizzled(row, col));
  }
  const int c = threadIdx.x;
  if (c < kTile && n0 + c < v) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWgThreads / 32; ++w) sum += red[w * kTile + c];
    dbp[size_t(blockIdx.x) * v + n0 + c] = sum;
  }
}

// The dh pass: blockIdx.x a d tile, blockIdx.y a token tile, blockIdx.z a
// split of the vocabulary [z split_len, (z + 1) split_len) within vp:
// part[z][n][d] = dl W^T over the split, in f32.
__global__ void __launch_bounds__(kWgThreads, kWgBlocksPerSm)
xent_wg_dh(const __grid_constant__ CUtensorMap dl_map,
           const __grid_constant__ CUtensorMap w_map, int vp, int split_len,
           int n, int d, float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wg_base(smem_raw);
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int k0 = blockIdx.z * split_len;
  const int len = min(split_len, vp - k0);
  float acc[64];
  wg_mainloop<false, false>(acc, &dl_map, &w_map, m0, n0, k0,
                            (len + kWgBK - 1) / kWgBK, base);
  wg_store(acc, part + size_t(blockIdx.z) * n * d, d, m0, n, n0, d);
}

// The dW pass: blockIdx.x a d tile, blockIdx.y a vocabulary tile; dW = h^T
// dl over every token, summed in f32 in registers, written once in TO.
template <typename TO>
__global__ void __launch_bounds__(kWgThreads, kWgBlocksPerSm)
xent_wg_dw(const __grid_constant__ CUtensorMap h_map,
           const __grid_constant__ CUtensorMap dl_map, int n, int d, int v,
           TO* __restrict__ dw) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wg_base(smem_raw);
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  float acc[64];
  wg_mainloop<true, true>(acc, &h_map, &dl_map, m0, n0, 0,
                          (n + kWgBK - 1) / kWgBK, base);
  wg_store(acc, dw, v, m0, d, n0, v);
}

// -- host side -------------------------------------------------------------

int cdiv(int a, int b) { return (a + b - 1) / b; }
int round8(int x) { return cdiv(x, 8) * 8; }

#define XENT_CHECK()                            \
  do {                                          \
    const cudaError_t e = cudaGetLastError();   \
    if (e != cudaSuccess) return e;             \
  } while (0)

constexpr int kPackBlocks = 132 * 8;

template <typename T>
cudaError_t pack(const void* src, int rows, int cols, void* dst, int ld,
                 cudaStream_t s) {
  xent_pack<T><<<kPackBlocks, kThreads, 0, s>>>(
      static_cast<const T*>(src), rows, cols, static_cast<bf16*>(dst), ld);
  return cudaGetLastError();
}

// The operands as the products read them: on the tensor-core route bf16
// with rows a whole number of 16 bytes (packed copies where the caller gave
// them), on the scalar route as given.
struct Operands {
  const void* h;
  int ldh, h_lim;  // h_lim: the columns of h a product may read
  const void* w;
  int ldw, w_lim;  // w_lim: likewise for W

  static cudaError_t make(Operands* o, int tc, int w_bf16, const void* h,
                          void* hp, const void* w, void* wp, int n, int d,
                          int v, cudaStream_t s) {
    *o = {h, d, d, w, v, v};
    if (!tc) return cudaSuccess;
    if (hp) {
      const cudaError_t e = pack<bf16>(h, n, d, hp, round8(d), s);
      if (e != cudaSuccess) return e;
      o->h = hp;
    }
    if (wp) {
      const cudaError_t e = w_bf16 ? pack<bf16>(w, d, v, wp, round8(v), s)
                                   : pack<float>(w, d, v, wp, round8(v), s);
      if (e != cudaSuccess) return e;
      o->w = wp;
    }
    o->ldh = o->h_lim = round8(d);
    o->ldw = o->w_lim = round8(v);
    return cudaSuccess;
  }
};

template <class E, typename TH, typename TW>
cudaError_t run_fwd(const Operands& o, const float* bias,
                    const int64_t* labels, int n, int d, int v, float* part,
                    float* lse, float* loss_tok, float* loss,
                    cudaStream_t s) {
  const dim3 grid(cdiv(n, kTile), cdiv(v, kTile));
  xent_fwd_tiles<E, TH, TW><<<grid, kThreads, 0, s>>>(
      static_cast<const TH*>(o.h), o.ldh, static_cast<const TW*>(o.w), o.ldw,
      o.w_lim, bias, labels, n, d, v, part);
  XENT_CHECK();
  xent_fwd_finalize<<<cdiv(n, 32), kThreads, 0, s>>>(part, grid.y, n, lse,
                                                     loss_tok);
  XENT_CHECK();
  xent_mean<<<1, 1024, 0, s>>>(loss_tok, n, loss);
  return cudaGetLastError();
}

template <class E, typename TH, typename TW, typename TO>
cudaError_t run_bwd(const Operands& o, const float* bias,
                    const int64_t* labels, const float* lse, const float* g,
                    int n, int d, int v, int chunk, int splits, int split_len,
                    TH* dl, float* dbp, float* dh_part, float* dw_acc, TH* dh,
                    TO* dw, float* db, cudaStream_t s) {
  const TH* h = static_cast<const TH*>(o.h);
  const TW* w = static_cast<const TW*>(o.w);
  const int chunks = n / chunk, row_tiles = cdiv(chunk, kTile);
  const int ldl = o.w_lim;  // dl's row: V
  float* acc_buf = dw_acc ? dw_acc : reinterpret_cast<float*>(dw);
  const size_t dh_count = size_t(chunk) * d;
  const size_t want_blocks = (dh_count + kThreads - 1) / kThreads;
  const int reduce_blocks =
      want_blocks < size_t(kPackBlocks) ? int(want_blocks) : kPackBlocks;
  for (int c = 0; c < chunks; ++c) {
    const TH* hc = h + size_t(c) * chunk * o.ldh;
    const size_t t0 = size_t(c) * chunk;
    xent_bwd_dl<E, TH, TW, TH>
        <<<dim3(row_tiles, cdiv(v, kTile)), kThreads, 0, s>>>(
            hc, o.ldh, w, o.ldw, o.w_lim, bias, labels + t0, lse + t0, g, n,
            chunk, d, v, dl, ldl, dbp, c * row_tiles);
    XENT_CHECK();
    xent_bwd_dh<E, TH, TW>
        <<<dim3(row_tiles, cdiv(d, kTile), splits), kThreads, 0, s>>>(
            dl, ldl, w, o.ldw, chunk, d, o.w_lim, split_len, dh_part);
    XENT_CHECK();
    xent_dh_reduce<TH><<<reduce_blocks, kThreads, 0, s>>>(
        dh_part, splits, dh_count, dh + t0 * d);
    XENT_CHECK();
    xent_bwd_dw<E, TH, TH, TO>
        <<<dim3(cdiv(d, kTile), cdiv(v, kTile)), kThreads, 0, s>>>(
            hc, o.ldh, o.h_lim, dl, ldl, o.w_lim, chunk, d, v, acc_buf, dw,
            c == 0, c == chunks - 1);
    XENT_CHECK();
  }
  xent_db<<<cdiv(v, kThreads), kThreads, 0, s>>>(dbp, chunks * row_tiles, v,
                                                 db);
  return cudaGetLastError();
}

// The bf16 backward on wgmma: the dl, dh (with its reduce) and dW passes
// over every token, then db.  TMA reads the operands through 2-D maps
// (as [1][rows][cols]) of 64 x 64 boxes: h [n][dp], W [d][vp] and the dl
// workspace [n][vp], each row a whole number of 16 bytes.
template <typename TO>
cudaError_t run_bwd_wgmma(const Operands& o, const float* bias,
                          const int64_t* labels, const float* lse,
                          const float* g, int n, int d, int v, int splits,
                          int split_len, bf16* dl, float* dbp, float* dh_part,
                          bf16* dh, TO* dw, float* db, cudaStream_t s) {
  const int dp = o.ldh, vp = o.ldw;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(o.h) |
                         reinterpret_cast<uintptr_t>(o.w) |
                         reinterpret_cast<uintptr_t>(dl);
  if (addr % 16 || dp % 8 || vp % 8) return cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  using hopper::tile_map;
  CUtensorMap hm, wm, lm;
  if ((err = tile_map(&hm, o.h, 1, n, dp)) != cudaSuccess ||
      (err = tile_map(&wm, o.w, 1, d, vp)) != cudaSuccess ||
      (err = tile_map(&lm, dl, 1, n, vp)) != cudaSuccess)
    return err;
  static hopper::SmemLimit dl_limit, dh_limit, dw_limit;
  if ((err = dl_limit.raise(xent_wg_dl, dev, kWgSmemBytes)) != cudaSuccess ||
      (err = dh_limit.raise(xent_wg_dh, dev, kWgSmemBytes)) != cudaSuccess ||
      (err = dw_limit.raise(xent_wg_dw<TO>, dev, kWgSmemBytes)) !=
          cudaSuccess)
    return err;
  const int row_tiles = cdiv(n, kTile), d_tiles = cdiv(d, kTile);
  xent_wg_dl<<<dim3(row_tiles, cdiv(v, kTile)), kWgThreads, kWgSmemBytes,
               s>>>(hm, wm, dp, bias, labels, lse, g, n, v, dl, vp, dbp);
  XENT_CHECK();
  xent_wg_dh<<<dim3(d_tiles, row_tiles, splits), kWgThreads, kWgSmemBytes,
               s>>>(lm, wm, vp, split_len, n, d, dh_part);
  XENT_CHECK();
  const size_t dh_count = size_t(n) * d;
  const size_t want_blocks = (dh_count + kThreads - 1) / kThreads;
  xent_dh_reduce<bf16>
      <<<want_blocks < size_t(kPackBlocks) ? int(want_blocks) : kPackBlocks,
         kThreads, 0, s>>>(dh_part, splits, dh_count, dh);
  XENT_CHECK();
  xent_wg_dw<TO><<<dim3(d_tiles, cdiv(v, kTile)), kWgThreads, kWgSmemBytes,
                   s>>>(hm, lm, n, d, v, dw);
  XENT_CHECK();
  xent_db<<<cdiv(v, kThreads), kThreads, 0, s>>>(dbp, row_tiles, v, db);
  return cudaGetLastError();
}

bool bad_shape(int n, int d, int v) {
  return n < 1 || d < 1 || v < 1 || cdiv(v, kTile) > 65535;
}

// The backward's designs, as fused_xent.py's bwd_design names them.
enum BwdDesign { kBwdScalar = 0, kBwdWgmma = 1 };

BwdDesign bwd_design(int tc) { return tc ? kBwdWgmma : kBwdScalar; }

}  // namespace

// Plain C entry points, bound with ctypes.  `tc`: bf16 activations on the
// tensor cores (else f32 on scalar FMAs); `w_bf16`: W's dtype (else f32).
// hp / wp: where to pack h / W for the tensor cores (null: used as given,
// which needs bf16 rows of a whole number of 16 bytes).  They launch on
// `stream`, do not synchronise, allocate nothing, and return the first
// cudaError_t of their launches (0 on success).
extern "C" int fused_xent_fwd(int tc, int w_bf16, const void* h, void* hp,
                              const void* w, void* wp, const void* bias,
                              const void* labels, int n, int d, int v,
                              void* part, void* lse, void* loss_tok,
                              void* loss, void* stream) {
  if (bad_shape(n, d, v)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Operands o;
  cudaError_t e = Operands::make(&o, tc, w_bf16, h, hp, w, wp, n, d, v, s);
  if (e != cudaSuccess) return e;
  const float* b = static_cast<const float*>(bias);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  float* pt = static_cast<float*>(part);
  float* ls = static_cast<float*>(lse);
  float* lt = static_cast<float*>(loss_tok);
  float* lo = static_cast<float*>(loss);
  if (tc)
    return run_fwd<TensorCores, bf16, bf16>(o, b, lab, n, d, v, pt, ls, lt,
                                            lo, s);
  if (w_bf16)
    return run_fwd<ScalarF32, float, bf16>(o, b, lab, n, d, v, pt, ls, lt, lo,
                                           s);
  return run_fwd<ScalarF32, float, float>(o, b, lab, n, d, v, pt, ls, lt, lo,
                                          s);
}

// The wgmma design (tc): dl [N][round8(V)] bf16; dbp [cdiv(N, 128)][V]
// f32; dh_part [splits][N][D] f32, the vocabulary split into ranges of
// split_len (a multiple of 64) that cover round8(V) exactly; dw_acc unused.
// The scalar design (f32): dl [chunk][V]; dbp [N / chunk * cdiv(chunk,
// 128)][V] f32; dh_part [splits][chunk][D] f32; dw_acc a [D][V] f32 sum
// (null: dw itself, which must then be f32).
extern "C" int fused_xent_bwd(int tc, int w_bf16, const void* h, void* hp,
                              const void* w, void* wp, const void* bias,
                              const void* labels, const void* lse,
                              const void* g, int n, int d, int v, int chunk,
                              int splits, int split_len, void* dl, void* dbp,
                              void* dh_part, void* dw_acc, void* dh, void* dw,
                              void* db, void* stream) {
  if (bad_shape(n, d, v) || chunk < 1 || n % chunk || splits < 1 ||
      splits > 65535 || split_len < 1)
    return cudaErrorInvalidValue;
  const int64_t vp = round8(v);
  if (tc && (split_len % kWgBK || int64_t(splits - 1) * split_len >= vp ||
             int64_t(splits) * split_len < vp || cdiv(n, kTile) > 65535))
    return cudaErrorInvalidValue;
  if (!tc && w_bf16 && !dw_acc) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Operands o;
  cudaError_t e = Operands::make(&o, tc, w_bf16, h, hp, w, wp, n, d, v, s);
  if (e != cudaSuccess) return e;
  const float* b = static_cast<const float*>(bias);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  float* dbp_f = static_cast<float*>(dbp);
  float* part = static_cast<float*>(dh_part);
  float* acc = static_cast<float*>(dw_acc);
  float* dbf = static_cast<float*>(db);
  if (tc) {
    bf16* dlb = static_cast<bf16*>(dl);
    bf16* dhb = static_cast<bf16*>(dh);
    if (w_bf16)
      return run_bwd_wgmma<bf16>(o, b, lab, ls, gg, n, d, v, splits,
                                 split_len, dlb, dbp_f, part, dhb,
                                 static_cast<bf16*>(dw), dbf, s);
    return run_bwd_wgmma<float>(o, b, lab, ls, gg, n, d, v, splits,
                                split_len, dlb, dbp_f, part, dhb,
                                static_cast<float*>(dw), dbf, s);
  }
  float* dlf = static_cast<float*>(dl);
  float* dhf = static_cast<float*>(dh);
  if (w_bf16)
    return run_bwd<ScalarF32, float, bf16, bf16>(
        o, b, lab, ls, gg, n, d, v, chunk, splits, split_len, dlf, dbp_f,
        part, acc, dhf, static_cast<bf16*>(dw), dbf, s);
  return run_bwd<ScalarF32, float, float, float>(
      o, b, lab, ls, gg, n, d, v, chunk, splits, split_len, dlf, dbp_f, part,
      acc, dhf, static_cast<float*>(dw), dbf, s);
}

// The design (BwdDesign above) the bf16 (tc != 0) or f32 backward takes.
extern "C" int fused_xent_bwd_design(int tc) { return bwd_design(tc); }

extern "C" const char* fused_xent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
