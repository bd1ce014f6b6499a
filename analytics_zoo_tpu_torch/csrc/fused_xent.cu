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
// and 0.291 ms at 989 TFLOP/s), not the memory (0.03 and 0.06 ms).  In f32
// the backward's bound is its logits at the FMAs' 67 TFLOP/s (1.43 ms) and
// dh, dW in 3xTF32 at 495 (1.16 ms): 2.60 ms.
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
// wgmma_tf32, the f32 backward (h f32, W f32 or bf16): the dl pass over
// every token on the scalar main loop below, then dh = dl W^T and dW = h^T
// dl on wgmma in 3xTF32 (each f32 product three tf32 products of big and
// small parts, hopper.cuh), over every token as in the bf16 design.  The
// logits stay on f32 FMAs because dl = exp(S - lse) needs S to the last
// bits of the forward's sums: at logits of 1e2 (chip_smoke.py's scaled
// case) an S summed in any other order, 3xTF32's or f32's, moves dl by
// 1e-4-7e-4 of its max against 1e-5 allowed (dev/torch_tf32_probe.py, on
// the card), while dh and dW in 3xTF32 from the exact dl move by 2e-7.
// The two products read their A operand from registers (a raw f32 tile of
// dl through TMA, split in registers; read transposed for dW) and B as
// K-major parts that split passes write once: W's [2][D][round8(V)] and
// h's transposed [2][D][round8(N)] (wgmma takes tf32 only K-major).  Two
// warpgroups a 128 x 128 tile, 64-deep k slices through a 2-stage TMA
// ring (192 KB: one block an SM).  Workspace: dl [N][round8(V)] f32 (250
// MB at the recipe), W's parts (188 MB), h's (13 MB), dh's partials.
//
// scalar, the forward of both dtypes and the f32 backward's dl pass: 256
// threads over 128 x 128 output tiles for bf16 operands (the forward's),
// on mma.sync m16n8k16 (f32 accumulate; 8 warps as 2 x 4, 64 x 32 each),
// their 32-deep k slices double-buffered in shared memory by 16-byte
// cp.async copies that zero-fill the ragged edges; over 128 x 256 tiles
// for f32 operands, on scalar f32 FMAs (exact products summed in k order,
// as JAX's f32 dot and cuBLAS's), 8 x 16 outputs a thread, 8-deep k slices
// double-buffered through registers.  Its epilogues: the forward's row
// statistics (per token and vocabulary tile: the max, the sum of exp(S -
// max) and the label's logit, from the same f32 S); and the f32 dl into a
// [N][round8(V)] workspace with db's column sums.
//
// No atomics anywhere.  The forward writes per-tile partials that a
// finalize kernel combines per token in tile order (online max rescaling),
// then one block reduces the mean; dh's splits and db's tiles are summed in
// order; each dW tile is owned by one block.  Two runs give identical bits.
// What it leaves: a producer warp and persistent blocks that overlap a
// tile's epilogue with the next tile's products, the forward on wgmma,
// fusing the dh and dW products so that dl never leaves the chip, and a
// faster f32 FMA main loop (the f32 logits must keep its k order).

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
constexpr int kBKs = 8;        // scalar route: k per shared stage
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
  static constexpr int kN = 8;           // columns a thread
  static constexpr int kTileN = kTile;   // columns a block
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

// f32 (or bf16, read as f32) operands on scalar FMAs: a 128 x 256 tile,
// thread (ty, tx) holding rows 4 ty + r and 64 + 4 ty + r and columns
// 64 q + 4 tx + c (r, c < 4, q < 4), so each k step reads them as six
// 16-byte shared loads for 128 FMAs: shared memory (128 bytes a clock)
// then feeds the FMAs with a quarter to spare, where an 8 x 8 tile needs
// exactly its rate.  Every output is one chain of fmaf over k in order
// from 0, as JAX's f32 dot and cuBLAS's f32 GEMM sum it (the backward's
// dl needs the forward's logits to the last bit); the k slices are
// double-buffered, the next one's loads in flight during the FMAs.
struct ScalarF32 {
  static constexpr int kN = 16;             // columns a thread
  static constexpr int kTileN = 2 * kTile;  // columns a block
  __device__ static int row(int i) {
    return 64 * (i >> 2) + 4 * (threadIdx.x >> 4) + (i & 3);
  }
  __device__ static int col(int j) {
    return 64 * (j >> 2) + 4 * (threadIdx.x & 15) + (j & 3);
  }
  __device__ static int row_slot() { return threadIdx.x & 15; }
  __device__ static int col_slot() { return threadIdx.x >> 4; }

  // acc = A[m0.., k0..k1) B[k0..k1), n0..]: A stored [m][k], B [k][n];
  // rows of m >= m_lim, columns of n >= n_lim and k >= k1 read as zero.
  template <bool kAT, bool kBT, typename TA, typename TB>
  __device__ static void mainloop(float (&acc)[8][kN], const TA* A, int lda,
                                  int m0, int m_lim, const TB* B, int ldb,
                                  int n0, int n_lim, int k0, int k1,
                                  unsigned char* smem_raw) {
    static_assert(!kAT && !kBT, "the forward's operand forms only");
    constexpr int SA = kTile + 4, SB = kTileN + 4;  // 16-byte rows
    constexpr int kStageA = kBKs * SA, kStageB = kBKs * SB;
    static_assert(2 * (kStageA + kStageB) * sizeof(float) <= kSmemBytes,
                  "shared memory");
    float* As = reinterpret_cast<float*>(smem_raw);  // 2 x [k][m]
    float* Bs = As + 2 * kStageA;                    // 2 x [k][n]
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[i][j] = 0.f;
    constexpr int kLoadsA = kTile * kBKs / kThreads;
    constexpr int kLoadsB = kTileN * kBKs / kThreads;
    float ra[kLoadsA], rb[kLoadsB];
    auto load = [&](int k) {  // slice k into registers
#pragma unroll
      for (int i = 0; i < kLoadsA; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int am = e / kBKs, ak = e % kBKs;
        ra[i] = m0 + am < m_lim && k + ak < k1
                    ? to_f(A[size_t(m0 + am) * lda + k + ak])
                    : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kLoadsB; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int bn = e % kTileN, bk = e / kTileN;
        rb[i] = n0 + bn < n_lim && k + bk < k1
                    ? to_f(B[size_t(k + bk) * ldb + n0 + bn])
                    : 0.f;
      }
    };
    auto store = [&](int st) {  // ... and from registers into stage st
#pragma unroll
      for (int i = 0; i < kLoadsA; ++i) {
        const int e = threadIdx.x + i * kThreads;
        As[st * kStageA + (e % kBKs) * SA + e / kBKs] = ra[i];
      }
#pragma unroll
      for (int i = 0; i < kLoadsB; ++i) {
        const int e = threadIdx.x + i * kThreads;
        Bs[st * kStageB + (e / kTileN) * SB + e % kTileN] = rb[i];
      }
    };
    if (k0 >= k1) return;
    load(k0);
    store(0);
    __syncthreads();
    int st = 0;
    for (int k = k0; k < k1; k += kBKs, st ^= 1) {
      const bool more = k + kBKs < k1;
      if (more) load(k + kBKs);
      const float* as = As + st * kStageA;
      const float* bs = Bs + st * kStageB;
#pragma unroll
      for (int kk = 0; kk < kBKs; ++kk) {
        float a[8], b[kN];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(a + 4 * h) =
              *reinterpret_cast<const float4*>(as + kk * SA + 64 * h + 4 * ty);
#pragma unroll
        for (int q = 0; q < kN / 4; ++q)
          *reinterpret_cast<float4*>(b + 4 * q) =
              *reinterpret_cast<const float4*>(bs + kk * SB + 64 * q + 4 * tx);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < kN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) store(st ^ 1);
      __syncthreads();  // stage st read by all; stage st ^ 1 written
    }
  }
};

// -- forward ---------------------------------------------------------------

// One tile of S = h W + b, 128 tokens x E::kTileN columns (blockIdx.x:
// tokens, blockIdx.y: vocabulary tile): per token the tile's max, sum of
// exp(S - max) and, where the label falls in the tile, its logit (else 0),
// as part[q][tile][token] for q = 0, 1, 2.  The logits never leave the chip.
template <class E, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
xent_fwd_tiles(const TA* h, int ldh, const TB* w, int ldw, int w_lim,
               const float* __restrict__ bias,
               const int64_t* __restrict__ labels, int n, int d, int v,
               float* __restrict__ part) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * E::kTileN;
  float acc[8][E::kN];
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
    for (int j = 0; j < E::kN; ++j) {
      const int c = n0 + E::col(j);
      if (c < v) {
        acc[i][j] += bias[c];
        mx = fmaxf(mx, acc[i][j]);
        if (c == lab) lab_logit = acc[i][j];
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < E::kN; ++j)
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

// -- backward, f32: the dl pass on the scalar main loop ----------------------

// The dl pass of n tokens: S recomputed per tile, then dl = exp(S - lse)
// * scale less scale at the label (scale = g / n), stored in TD (h's
// dtype) to dl[n][ldl] (zeros in the columns v <= c < ldl), and the tile's
// column sums of the f32 dl as row blockIdx.x of dbp[][v].
template <class E, typename TA, typename TB, typename TD>
__global__ void __launch_bounds__(kThreads)
xent_bwd_dl(const TA* h, int ldh, const TB* w, int ldw, int w_lim,
            const float* __restrict__ bias, const int64_t* __restrict__ labels,
            const float* __restrict__ lse, const float* __restrict__ g,
            int n, int d, int v, TD* __restrict__ dl, int ldl,
            float* __restrict__ dbp) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * E::kTileN;
  float acc[8][E::kN];
  E::template mainloop<false, false>(acc, h, ldh, m0, n, w, ldw, n0, w_lim,
                                     0, d, smem);
  const float scale = g[0] / float(n);
  float colsum[E::kN];
#pragma unroll
  for (int j = 0; j < E::kN; ++j) colsum[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + E::row(i);
    if (r >= n) continue;
    const float ls = lse[r];
    const int64_t lab = labels[r];
#pragma unroll
    for (int j = 0; j < E::kN; ++j) {
      const int c = n0 + E::col(j);
      float x = 0.f;
      if (c < v) {
        // __expf: within 15 ulp where exp(x) > 1e-5 (x > -11.5), 1e-6 of
        // dl's max, and a tenth of the f32 tolerance
        x = __expf(acc[i][j] + bias[c] - ls) * scale;
        if (c == lab) x += -scale;
        colsum[j] += x;
      }
      acc[i][j] = x;
    }
    TD* out = dl + size_t(r) * ldl;
#pragma unroll
    for (int j = 0; j < E::kN; j += 4) {  // four adjacent columns
      const int c = n0 + E::col(j);
      if constexpr (sizeof(TD) == 4) {
        if (c + 3 < ldl) {  // ldl a multiple of 4: 16-byte aligned
          *reinterpret_cast<float4*>(out + c) = make_float4(
              acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
          continue;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < ldl) out[c + u] = from_f<TD>(acc[i][j + u]);
    }
  }
  // [E::kTileN columns][kSlots]
  float* red = reinterpret_cast<float*>(smem);
  const int slot = E::col_slot();
#pragma unroll
  for (int j = 0; j < E::kN; ++j) red[E::col(j) * kSlots + slot] = colsum[j];
  __syncthreads();
  const int c = threadIdx.x;
  static_assert(E::kTileN <= kThreads, "a thread a column");
  if (c < E::kTileN && n0 + c < v) {
    float s = 0.f;
    for (int q = 0; q < kSlots; ++q) s += red[c * kSlots + q];
    dbp[size_t(blockIdx.x) * v + n0 + c] = s;
  }
}

// dh = the sum of the splits' partials, in split order, in TH.
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

// -- backward, f32: dh and dW on wgmma in 3xTF32 ---------------------------
//
// The dl pass runs on the scalar main loop (its logits are the forward's
// f32 sums, in the forward's order: see the header); the two products
// after it run on the tensor cores, each f32 product three tf32 ones
// (hopper.cuh).  wgmma reads tf32 only K-major from shared memory, so the
// A operand comes from registers: each warpgroup loads its 64 rows of a
// raw f32 tile of dl (as it is, or read transposed) from shared memory and
// splits it there; the B operand is K-major parts written once by split
// passes: W's as it is ([2][D][round8(V)]: dh = dl W^T reads W as [n =
// d][k = v]) and h's transposed ([2][D][round8(N)]: dW^T = dl^T h reads h
// as [n = d][k = token]).  A block is two warpgroups owning a 128 x 128
// output tile; 64-deep k slices (A 32 KB, B's parts 64 KB, each 32 wide a
// TMA box) arrive through a ring of kTfStages TMA stages (64-deep ran 2%
// faster than 32-deep in four stages, PERF.md).

constexpr int kTfBK = 64;  // k per stage: two 128-byte swizzle atoms of f32
constexpr int kTfStages = 2;
constexpr int kTfSteps = kTfBK / 8;                       // k8 steps a stage
constexpr uint32_t kTfAtom = kTile * 32 * sizeof(float);  // 128 rows: 16 KB
constexpr uint32_t kTfA = kTfBK / 32 * kTfAtom;           // 32 KB
constexpr uint32_t kTfStageBytes = 3 * kTfA;              // A, B big, small
constexpr size_t kTfSmemBytes =
    kTfStages * kTfStageBytes + kTfStages * sizeof(uint64_t) + 1024;
static_assert(kTfSmemBytes <= 227 * 1024, "shared memory");

// sum = A B^T in 3xTF32 over k slices [k0, k0 + kTfBK nk) for the block's
// 128 x 128 tile at (m0, n0), sum laid out as wg_mainloop's acc.  Each
// slice's products go to an accumulator of their own, which is then added
// to sum in f32 (rounded to nearest): the tensor cores' own additions
// round less carefully, and over a K of thousands their error grew to
// 2.5e-5 of dh's max against 1e-5 allowed (PERF.md).  A is raw f32, from a
// map over [m][k] (kAT false: boxes of 128 rows x 32) or over [k][m] (kAT
// true: four boxes of kTfBK x 32, read transposed); B's big and small
// parts from a map over [2][n][k] (boxes of 128 rows x 32).  Rows and
// columns outside a map read as zeros.
template <bool kAT>
__device__ __forceinline__ void tf_mainloop(float (&sum)[64],
                                            const CUtensorMap* a_map,
                                            const CUtensorMap* b_map, int m0,
                                            int n0, int k0, int nk,
                                            unsigned char* base) {
  using namespace hopper;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + kTfStages * kTfStageBytes);
  const uint32_t sbase = smem_addr(base);
  auto load = [&](int j) {  // one thread: k slice j into stage j % stages
    const int st = j % kTfStages, k = k0 + j * kTfBK;
    unsigned char* s = base + st * kTfStageBytes;
    mbar_expect_tx(&full[st], kTfStageBytes);
    if (kAT) {  // four boxes of kTfBK rows (k) x 32 (m)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        tma_load_3d(s + b * (kTfA / 4), a_map, &full[st], m0 + 32 * b, k, 0);
    }
#pragma unroll
    for (int a = 0; a < kTfBK / 32; ++a) {  // 128 rows x 32 (k) each
      if (!kAT)
        tma_load_3d(s + a * kTfAtom, a_map, &full[st], k + 32 * a, m0, 0);
      tma_load_3d(s + kTfA + a * kTfAtom, b_map, &full[st], k + 32 * a, n0,
                  0);
      tma_load_3d(s + 2 * kTfA + a * kTfAtom, b_map, &full[st], k + 32 * a,
                  n0, 1);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kTfStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < kTfStages && j < nk; ++j) load(j);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kTfStages;
    mbar_wait(&full[st], (kt / kTfStages) & 1);
    const unsigned char* a_tile = base + st * kTfStageBytes;
    // this thread's A fragments: (row g or g + 8, depth t or t + 4) of its
    // warp's 16 rows, each k8 step, split into tf32 parts
    uint32_t ab[kTfSteps][4], as[kTfSteps][4];
#pragma unroll
    for (int kk = 0; kk < kTfSteps; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int m = 64 * wg + 16 * warp + g + 8 * (x & 1);
        const int k = 8 * kk + t + 4 * (x >> 1);
        const int kc = k & 31;
        const uint32_t off =
            kAT ? (m >> 5) * (kTfA / 4) + k * 128 +
                      ((((m & 31) >> 2) ^ (k & 7)) << 4) + (m & 3) * 4
                : (k >> 5) * kTfAtom + m * 128 +
                      (((kc >> 2) ^ (m & 7)) << 4) + (kc & 3) * 4;
        tf32_split(*reinterpret_cast<const float*>(a_tile + off), ab[kk][x],
                   as[kk][x]);
      }
    const uint32_t b_addr = sbase + st * kTfStageBytes + kTfA;
    fence_regs(ab);
    fence_regs(as);
    wgmma_fence();
    wgmma_tf32x3_rs<128, false>(acc, ab[0], as[0],
                                desc_tf32(b_addr, 0, kTfAtom),
                                desc_tf32(b_addr + kTfA, 0, kTfAtom));
#pragma unroll
    for (int kk = 1; kk < kTfSteps; ++kk)
      wgmma_tf32x3_rs<128>(acc, ab[kk], as[kk],
                           desc_tf32(b_addr, kk, kTfAtom),
                           desc_tf32(b_addr + kTfA, kk, kTfAtom));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ab);
    fence_regs(as);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    __syncthreads();  // both warpgroups done with stage st: refill it
    if (tid == 0 && kt + kTfStages < nk) load(kt + kTfStages);
  }
}

// The dh pass: blockIdx.x a d tile, blockIdx.y a token tile, blockIdx.z a
// split of the vocabulary [z split_len, (z + 1) split_len) within vp:
// part[z][n][d] = dl W^T over the split, in f32.
__global__ void __launch_bounds__(kWgThreads, 1)
xent_tf_dh(const __grid_constant__ CUtensorMap dl_map,
           const __grid_constant__ CUtensorMap w_map, int vp, int split_len,
           int n, int d, float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wg_base(smem_raw);
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int k0 = blockIdx.z * split_len;
  const int len = min(split_len, vp - k0);
  float acc[64];
  tf_mainloop<false>(acc, &dl_map, &w_map, m0, n0, k0,
                     (len + kTfBK - 1) / kTfBK, base);
  wg_store(acc, part + size_t(blockIdx.z) * n * d, d, m0, n, n0, d);
}

// The dW pass: blockIdx.x a d tile, blockIdx.y a vocabulary tile; dW^T =
// dl^T h over every token, summed in f32 in registers, written once to
// dw[d][v] in TO.
template <typename TO>
__global__ void __launch_bounds__(kWgThreads, 1)
xent_tf_dw(const __grid_constant__ CUtensorMap dl_map,
           const __grid_constant__ CUtensorMap ht_map, int n, int d, int v,
           TO* __restrict__ dw) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = wg_base(smem_raw);
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[64];
  tf_mainloop<true>(acc, &dl_map, &ht_map, m0, n0, 0,
                    (n + kTfBK - 1) / kTfBK, base);
  // acc holds (row v, column d): stored to dw[d][v]
  const WgPos p;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + p.row + 8 * h;
    if (r >= v) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = n0 + 8 * i + p.col + u;
        if (c < d) dw[size_t(c) * v + r] = from_f<TO>(acc[4 * i + 2 * h + u]);
      }
  }
}

// dst[2][rows][ld]: the big and small tf32 parts of src [rows][cols] (read
// as f32), zeros in the columns cols <= c < ld; ld a multiple of 4, dst
// 16-byte aligned: four columns a thread, 16-byte stores.
template <typename T>
__global__ void xent_split(const T* __restrict__ src, int rows, int cols,
                           float* __restrict__ dst, int ld) {
  const size_t total = size_t(rows) * ld;
  for (size_t i = 4 * (blockIdx.x * size_t(blockDim.x) + threadIdx.x);
       i < total; i += 4 * size_t(gridDim.x) * blockDim.x) {
    const size_t r = i / ld;
    const int c = int(i - r * ld);
    uint32_t big[4], small[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      hopper::tf32_split(c + u < cols ? to_f(src[r * cols + c + u]) : 0.f,
                         big[u], small[u]);
    *reinterpret_cast<uint4*>(dst + i) =
        make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(dst + total + i) =
        make_uint4(small[0], small[1], small[2], small[3]);
  }
}

// dst[2][cols][ld]: the big and small tf32 parts of src^T (src [rows][cols]
// f32), zeros in the columns rows <= r < ld; 32 x 32 tiles through shared
// memory, blockIdx.x over src's rows, blockIdx.y over its columns.
__global__ void __launch_bounds__(kThreads)
xent_split_t(const float* __restrict__ src, int rows, int cols,
             float* __restrict__ dst, int ld) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i, c = c0 + tx;
    tile[ty + 8 * i][tx] =
        r < rows && c < cols ? src[size_t(r) * cols + c] : 0.f;
  }
  __syncthreads();
  const size_t plane = size_t(cols) * ld;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 8 * i, r = r0 + tx;
    if (c < cols && r < ld) {
      uint32_t big, small;
      hopper::tf32_split(tile[tx][ty + 8 * i], big, small);
      dst[size_t(c) * ld + r] = __uint_as_float(big);
      dst[plane + size_t(c) * ld + r] = __uint_as_float(small);
    }
  }
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
  const dim3 grid(cdiv(n, kTile), cdiv(v, E::kTileN));
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

// The f32 backward: W's parts and h's transposed parts, the dl pass
// (scalar, every token at once), dh on wgmma in 3xTF32 with its reduce,
// dW likewise, then db.  TMA reads dl [n][vp] (raw f32), W's parts
// [2][d][vp] and h^T's [2][d][np] through 3-D maps.
template <typename TW>
cudaError_t run_bwd_tf32(const Operands& o, const float* bias,
                         const int64_t* labels, const float* lse,
                         const float* g, int n, int d, int v, int splits,
                         int split_len, float* dl, float* wsplit, float* ht,
                         float* dbp, float* dh_part, float* dh, TW* dw,
                         float* db, cudaStream_t s) {
  const int vp = round8(v), np = round8(n);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dl) |
                         reinterpret_cast<uintptr_t>(wsplit) |
                         reinterpret_cast<uintptr_t>(ht);
  if (addr % 16) return cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const float* h = static_cast<const float*>(o.h);
  const TW* w = static_cast<const TW*>(o.w);
  xent_split<TW><<<kPackBlocks, kThreads, 0, s>>>(w, d, v, wsplit, vp);
  XENT_CHECK();
  xent_split_t<<<dim3(cdiv(np, 32), cdiv(d, 32)), kThreads, 0, s>>>(
      h, n, d, ht, np);
  XENT_CHECK();
  const int row_tiles = cdiv(n, kTile), d_tiles = cdiv(d, kTile);
  const int v_tiles = cdiv(v, kTile);
  xent_bwd_dl<ScalarF32, float, TW, float>
      <<<dim3(row_tiles, cdiv(v, ScalarF32::kTileN)), kThreads, 0, s>>>(
          h, d, w, v, v, bias, labels, lse, g, n, d, v, dl, vp, dbp);
  XENT_CHECK();
  using hopper::tile_map_f32;
  CUtensorMap lm, ltm, wm, hm;
  if ((err = tile_map_f32(&lm, dl, 1, n, vp, kTile)) != cudaSuccess ||
      (err = tile_map_f32(&ltm, dl, 1, n, vp, kTfBK)) != cudaSuccess ||
      (err = tile_map_f32(&wm, wsplit, 2, d, vp, kTile)) != cudaSuccess ||
      (err = tile_map_f32(&hm, ht, 2, d, np, kTile)) != cudaSuccess)
    return err;
  static hopper::SmemLimit dh_limit, dw_limit;
  if ((err = dh_limit.raise(xent_tf_dh, dev, kTfSmemBytes)) != cudaSuccess ||
      (err = dw_limit.raise(xent_tf_dw<TW>, dev, kTfSmemBytes)) !=
          cudaSuccess)
    return err;
  xent_tf_dh<<<dim3(d_tiles, row_tiles, splits), kWgThreads, kTfSmemBytes,
               s>>>(lm, wm, vp, split_len, n, d, dh_part);
  XENT_CHECK();
  const size_t dh_count = size_t(n) * d;
  const size_t want_blocks = (dh_count + kThreads - 1) / kThreads;
  xent_dh_reduce<float>
      <<<want_blocks < size_t(kPackBlocks) ? int(want_blocks) : kPackBlocks,
         kThreads, 0, s>>>(dh_part, splits, dh_count, dh);
  XENT_CHECK();
  xent_tf_dw<TW><<<dim3(d_tiles, v_tiles), kWgThreads, kTfSmemBytes, s>>>(
      ltm, hm, n, d, v, dw);
  XENT_CHECK();
  xent_db<<<cdiv(v, kThreads), kThreads, 0, s>>>(dbp, row_tiles, v, db);
  return cudaGetLastError();
}

bool bad_shape(int n, int d, int v) {
  return n < 1 || d < 1 || v < 1 || cdiv(v, kTile) > 65535;
}

// The backward's designs, as fused_xent.py's bwd_design names them.
enum BwdDesign { kBwdWgmma = 0, kBwdWgmmaTf32 = 1 };

BwdDesign bwd_design(int tc) { return tc ? kBwdWgmma : kBwdWgmmaTf32; }

}  // namespace

// Plain C entry points, bound with ctypes.  `tc`: bf16 activations on the
// tensor cores (else f32: the forward and the backward's logits on scalar
// FMAs, its dh and dW on wgmma in 3xTF32); `w_bf16`: W's dtype (else f32).
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

// Both designs run over every token at once: dl [N][round8(V)] (bf16 for
// tc, else f32); dbp [cdiv(N, 128)][V] f32; dh_part [splits][N][D] f32,
// the vocabulary split into ranges of split_len (a multiple of 64) that
// cover round8(V) exactly.  f32 only: wp W's tf32 parts
// [2][D][round8(V)], ht h's transposed [2][D][round8(N)] (f32, 16-byte
// aligned, as dl).
extern "C" int fused_xent_bwd(int tc, int w_bf16, const void* h, void* hp,
                              const void* w, void* wp, const void* bias,
                              const void* labels, const void* lse,
                              const void* g, int n, int d, int v, int splits,
                              int split_len, void* dl, void* dbp,
                              void* dh_part, void* ht, void* dh, void* dw,
                              void* db, void* stream) {
  const int64_t vp = round8(v);
  const int step = tc ? kWgBK : kTfBK;
  if (bad_shape(n, d, v) || splits < 1 || splits > 65535 || split_len < 1 ||
      split_len % step || int64_t(splits - 1) * split_len >= vp ||
      int64_t(splits) * split_len < vp || cdiv(n, kTile) > 65535 ||
      (!tc && (wp == nullptr || ht == nullptr)))
    return cudaErrorInvalidValue;
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
  float* wsplit = static_cast<float*>(wp);
  float* htf = static_cast<float*>(ht);
  float* dhf = static_cast<float*>(dh);
  if (w_bf16)
    return run_bwd_tf32<bf16>(o, b, lab, ls, gg, n, d, v, splits, split_len,
                              dlf, wsplit, htf, dbp_f, part, dhf,
                              static_cast<bf16*>(dw), dbf, s);
  return run_bwd_tf32<float>(o, b, lab, ls, gg, n, d, v, splits, split_len,
                             dlf, wsplit, htf, dbp_f, part, dhf,
                             static_cast<float*>(dw), dbf, s);
}

// The design (BwdDesign above) the bf16 (tc != 0) or f32 backward takes.
extern "C" int fused_xent_bwd_design(int tc) { return bwd_design(tc); }

extern "C" const char* fused_xent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
