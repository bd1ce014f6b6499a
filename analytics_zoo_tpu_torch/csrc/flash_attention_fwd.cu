// Flash-attention forward for Hopper (sm_90a), bfloat16 on the tensor cores.
//
// Replaces analytics_zoo_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// TPU kernel launched by _flash_fwd_pallas) for bfloat16 inputs; float32
// inputs take the kernels of flash_attention_fwd_f32.cu.  For
// q, k, v laid out [BH, T, d] and contiguous:
//   out[bh, i] = softmax_j(scale * q_i . k_j, masked) @ v      (bf16)
//   lse[bh, i] = m_i + log(max(l_i, 1e-30))                    (f32)
// with key positions >= Tk masked and, under `causal`, q < k masked
// (absolute positions, so Tq != Tk works).  Masked logits are -1e30, as in
// the JAX kernel; the ragged Tq and Tk edges are masked here, nothing is
// padded in device memory.
//
// What bounds it.  The work is 4 * BH * Tq * Tk * d FLOP against q, k, v
// read once and out written once.  At BERT-base (T 512, d 64) that is about
// 256 FLOP per byte in bf16, just under the H100's ridge of about 295 (989
// TFLOP/s over 3.35 TB/s): at the tensor-core rate the two bounds nearly
// meet, so the kernel must keep the tensor cores fed and move each byte of
// q, k, v from device memory about once.  At head width 64 the softmax's
// 2^x (one a logit, 16 an SM a cycle) costs the SM as many cycles as the
// two products of a tile on the tensor cores, so the two must overlap.
//
// Three designs (`design` below picks one; ops/flash_attention.py's
// fwd_design names it):
//
// wgmma, head widths 33-64 (BERT's 64): a block is one warpgroup (128
// threads) owning 64 q rows, fed by TMA (hopper.cuh).
//   * q tiles x BH are linearised onto gridDim.x, and within a bh the last
//     q tile (the longest under `causal`) comes first.  At 91 registers
//     and 41 KB of shared memory a block, five share an SM, so one
//     block's softmax overlaps the others' products;
//   * Q is loaded once by TMA into a 1024-aligned tile in the 128-byte
//     swizzle; K and V stream as 64-row tiles through a 2-stage ring, each
//     stage completed on an mbarrier and refilled by one thread once every
//     warp is done with it.  The 3-D tensor maps over [BH, T, d] (box 1 x
//     64 x 64) zero-fill rows past T of a head and columns d..63;
//   * S = Q K^T is 4 wgmma m64n64k16 products with both operands K-major in
//     shared memory; the online softmax runs on the f32 accumulators
//     (mma.sync's C fragment per warp, so row max and sum reduce over the
//     4 lanes of a quad), 2^x by ex2.approx with scale * log2(e) folded into
//     one FMA, masks only on edge and diagonal tiles;
//   * P is rounded to bf16 straight into the register A fragments of O +=
//     P V, 4 products with V read MN-major (the transpose bit).  No branch
//     goes around a product: ptxas serialises products that a branch
//     merges (warning C7515);
//   * the epilogue scales by 1 / max(l, 1e-30), stages each warp's rows in
//     the Q tile (swizzled, so no bank conflicts) and stores 16-byte pieces
//     of rows < Tq, columns < d; lse in f32.
//
// wgmma_wide, head widths above 256 (any multiple of 8): a block is one
// warpgroup owning 64 q rows and a group of 256 output columns.  A 64-row
// Q or K tile of such a head does not fit in shared memory beside a ring
// (128 KB at d 1024), so S = Q K^T streams the depth's 64-wide swizzle
// atoms as (Q atom, K atom) pairs through a 4-stage TMA ring, one wgmma
// group an atom with the next in flight; the softmax is the design
// above's; O += P V is one m64n64k16 an atom of the group's V tile and
// k16 step, 128 accumulators a thread.  S is computed once for each column
// group (2.5 x the least FLOP at d 1024); 204 registers and 97 KB: two
// blocks an SM.  Section "head widths above 256" below.
//
// mma.sync, head widths up to 32 and 65-256 (the FA2 structure on
// mma.sync.m16n8k16):
//   * a block of 4 warps owns one q tile of one bh: 64 rows, 16 per warp,
//     or, at head widths up to 32 when the grid still fills the card, 128
//     rows, two m16 tiles per warp, so that every K and V fragment read
//     from shared memory serves twice the rows;
//   * the q tile is copied once into shared memory in bf16, and each warp
//     moves its rows with ldmatrix into A fragments that stay in registers
//     for the whole key loop (at D 256 they are re-read from shared memory
//     each tile, to stay under 255 registers);
//   * 64-key K and V tiles are double-buffered in bf16 with cp.async 16-byte
//     copies: tile j+1 is in flight while tile j is computed.  Rows >= Tk and
//     columns >= d are zero-filled by the copy, never read from device
//     memory.  Shared rows are padded by 16 bytes, which makes the eight row
//     addresses of every ldmatrix fall in distinct bank groups;
//   * S = Q K^T and O += P V as mma.sync (bf16 in, f32 accumulate), K's B
//     fragments by ldmatrix, V's by ldmatrix.trans; the softmax as above;
//     P never leaves registers (the f32 accumulators of two adjacent n8
//     tiles are the A fragment of one k16 step, see warp_mma.cuh);
//   * the epilogue stages the warp's rows in shared memory and stores them
//     with coalesced 16-byte stores.
// All take the true d <= their padded width at run time; d must be a
// multiple of 8 (each row a whole number of 16-byte copies), and the
// wrapper pads the rare other d.  What they leave: a producer warp and
// consumer warpgroups that overlap one block's softmax with its own
// products (FlashAttention-3's ping-pong), persistent blocks, the wgmma
// design for the other widths, and in wgmma_wide an S shared by the column
// groups (two warpgroups splitting the depth).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace warp_mma;

constexpr int kBlockN = 64;   // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

// max(x, lo) that keeps a NaN, as the plain version's clamp and the JAX
// kernel's jnp.maximum do: fmaxf drops it, so a row of NaN logits would
// leave a finite lse.
__device__ __forceinline__ float keep_nan_max(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// DP: padded head width; MT: m16 row tiles per warp, so a block owns
// 64 * MT q rows.
template <int DP, int MT>
struct Layout {
  static constexpr int kStride = DP + 8;  // bf16 per shared row (+16 bytes)
  static constexpr int kBlockM = 16 * kWarps * MT;
  static constexpr int kQTile = kBlockM * kStride;
  static constexpr int kKVTile = kBlockN * kStride;
  // q tile, then K stages 0 and 1, then V stages 0 and 1
  static constexpr size_t kSmemBytes =
      (size_t(kQTile) + 4 * size_t(kKVTile)) * sizeof(bf16);
};

// Rows [row0, row0 + ROWS) and columns [0, DP) of a [nrows, d] matrix into
// a shared tile; rows >= nrows and columns >= d are zero-filled.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* g,
                                          int row0, int nrows, int d,
                                          int tid) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  constexpr int kPerThread = ROWS * kChunks / kThreads;
  static_assert(ROWS * kChunks % kThreads == 0,
                "DP must be a multiple of 16");
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < nrows && col < d;
    const bf16* src = ok ? g + size_t(row0 + r) * d + col : g;
    cp_async_16(tile + r * Layout<DP, 1>::kStride + col, src, ok);
  }
}

template <int DP, int MT, bool kQInRegs>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int tq, int tk, int d,
                      int n_qtiles, float scale_log2, int causal) {
  using L = Layout<DP, MT>;
  constexpr int S = L::kStride;
  constexpr int kBlockM = L::kBlockM;
  constexpr int KD = DP / 16;       // k16 steps over the head dim (Q K^T)
  constexpr int ND = DP / 8;        // n8 tiles over the head dim (P V)
  constexpr int NK = kBlockN / 8;   // n8 tiles over a key tile (Q K^T)

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + L::kQTile;        // two stages
  bf16* Vs = Ks + 2 * L::kKVTile;   // two stages

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (n_qtiles - 1 - blockIdx.x % n_qtiles) * kBlockM;
  const int row_w = warp * 16 * MT;  // this warp's first row in the q tile
  const bf16* qb = q + size_t(bh) * tq * d;
  const bf16* kb = k + size_t(bh) * tk * d;
  const bf16* vb = v + size_t(bh) * tk * d;

  // keys past the last q row of this tile are all masked under `causal`
  const int kend = causal ? min(tk, q0 + kBlockM) : tk;
  const int n_tiles = (kend + kBlockN - 1) / kBlockN;

  load_tile<DP, kBlockM>(Qs, qb, q0, tq, d, tid);
  load_tile<DP, kBlockN>(Ks, kb, 0, tk, d, tid);
  load_tile<DP, kBlockN>(Vs, vb, 0, tk, d, tid);
  cp_async_commit();

  uint32_t qf[kQInRegs ? MT : 1][kQInRegs ? KD : 1][4];
  float acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < ND; ++i)
      acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.f;
  // per row g and g + 8 of each m tile: running max (in scale * log2(e)
  // units) and this lane's part of the running sum
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }
  // lane's ldmatrix row addresses (see warp_mma.cuh)
  const bf16* q_lane = Qs + (row_w + (lane & 15)) * S + (lane >> 4) * 8;
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * S +
                     ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * S +
                     (lane >> 4) * 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<DP, kBlockN>(Ks + (st ^ 1) * L::kKVTile, kb,
                             (j + 1) * kBlockN, tk, d, tid);
      load_tile<DP, kBlockN>(Vs + (st ^ 1) * L::kKVTile, vb,
                             (j + 1) * kBlockN, tk, d, tid);
      cp_async_commit();
      cp_async_wait<1>();  // everything but tile j + 1 has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... for every thread's copies
    const bf16* Kt = Ks + st * L::kKVTile;
    const bf16* Vt = Vs + st * L::kKVTile;

    if (kQInRegs && j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          ldmatrix_x4(qf[kQInRegs ? mt : 0][kQInRegs ? kd : 0],
                      q_lane + mt * 16 * S + kd * 16);
    }

    // S = Q K^T for this warp's 16 * MT rows x 64 keys; each K fragment
    // serves all MT row tiles
    float s[MT][NK][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NK; ++i)
        s[mt][i][0] = s[mt][i][1] = s[mt][i][2] = s[mt][i][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (kQInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[mt][i] = qf[kQInRegs ? mt : 0][kQInRegs ? kd : 0][i];
        } else {
          ldmatrix_x4(a[mt], q_lane + mt * 16 * S + kd * 16);
        }
      }
#pragma unroll
      for (int nb = 0; nb < NK / 2; ++nb) {
        uint32_t b[4];
        ldmatrix_x4(b, Kt + nb * 16 * S + k_lane + kd * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(s[mt][2 * nb], a[mt], b[0], b[1]);
          mma_bf16_16816(s[mt][2 * nb + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // mask the ragged key edge and, under `causal`, keys after the row
    const int k0 = j * kBlockN;
    if (k0 + kBlockN > tk || (causal && k0 + kBlockN - 1 > q0 + row_w)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jn = 0; jn < NK; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + jn * 8 + 2 * t + (e & 1);
            const int qpos = q0 + row_w + mt * 16 + g + (e >> 1) * 8;
            if (kpos >= tk || (causal && kpos > qpos)) s[mt][jn][e] = kNegInf;
          }
    }

    // online softmax on the accumulator fragments
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int jn = 0; jn < NK; ++jn)
          mx = fmaxf(mx, fmaxf(s[mt][jn][2 * r], s[mt][jn][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][r], mx * scale_log2);
        const float alpha = exp2_approx(m[mt][r] - m_new);
        m[mt][r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int jn = 0; jn < NK; ++jn)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[mt][jn][e] = exp2_approx(fmaf(s[mt][jn][e], scale_log2, -m_new));
            sum += s[mt][jn][e];
          }
        l[mt][r] = alpha * l[mt][r] + sum;
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          acc[mt][i][2 * r] *= alpha;
          acc[mt][i][2 * r + 1] *= alpha;
        }
      }

    // O += P V, P straight from the registers; each V fragment serves all
    // MT row tiles
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int db = 0; db < ND / 2; ++db) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vt + kk * 16 * S + v_lane + db * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(acc[mt][2 * db], a[mt], b[0], b[1]);
          mma_bf16_16816(acc[mt][2 * db + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage st fully read before tile j + 2 is copied in
  }

  // epilogue: the warp's rows through its own rows of the q tile (no other
  // warp reads them), then 16-byte stores of columns < d
  bf16* Os = Qs + row_w * S;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      lr = keep_nan_max(lr, 1e-30f);
      const float inv = 1.f / lr;
      const int row = mt * 16 + g + 8 * r;  // in the warp's rows
#pragma unroll
      for (int i = 0; i < ND; ++i)
        *reinterpret_cast<uint32_t*>(Os + row * S + i * 8 + 2 * t) =
            pack_bf16(acc[mt][i][2 * r] * inv, acc[mt][i][2 * r + 1] * inv);
      const int qpos = q0 + row_w + row;
      if (t == 0 && qpos < tq)
        lse[size_t(bh) * tq + qpos] = m[mt][r] * kLn2 + logf(lr);
    }
  __syncwarp();
  constexpr int kChunks = DP / 8;
#pragma unroll
  for (int c = lane; c < 16 * MT * kChunks; c += 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int row = q0 + row_w + r;
    if (row < tq && col < d)
      *reinterpret_cast<uint4*>(out + (size_t(bh) * tq + row) * d + col) =
          *reinterpret_cast<const uint4*>(Os + r * S + col);
  }
}

// ---------------------------------------------------------------------------
// wgmma fed by a TMA ring, head widths 33-64
// ---------------------------------------------------------------------------

constexpr int kWgRows = hopper::kTileRows;  // q rows a block, keys a tile
constexpr int kWgThreads = 128;             // one warpgroup
constexpr uint32_t kWgTileBytes = kWgRows * 64 * sizeof(bf16);  // 8 KB

// Stages of the K/V ring.  A third stage ran 18% slower at BH 768 (fewer
// blocks an SM); so did two warpgroups a block sharing the ring, and the
// next tile's S in flight with this tile's P V (PERF.md).
constexpr int kStages = 2;

// Shared memory in bytes from a 1024-aligned base: the Q tile, kStages K
// and kStages V tiles, then the mbarriers (one a stage, Q's).
struct WgSmem {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kWgTileBytes;
  static constexpr uint32_t kV = kK + kStages * kWgTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kWgTileBytes;
  static constexpr size_t kBytes =
      kBar + (kStages + 1) * sizeof(uint64_t) + 1024;
};

// The online softmax of one 64 x 64 tile on its S accumulators (f32, the
// wgmma layout: this thread's element 4 i + e is at row row0 + 8 (e >> 1),
// key col0 + 8 i + (e & 1)).  With kMask, keys >= tk and, under `causal`,
// keys after the row get -1e30 first.  Leaves 2^(scale log2(e) s - m) in
// s, folds the tile into the running max m (in scale * log2(e) units) and
// this lane's part of the running sum l, and returns in alpha the factor
// that rescales O for each of the two rows.
template <bool kMask>
__device__ __forceinline__ void wg_softmax(float (&s)[32], float (&m)[2],
                                           float (&l)[2], float (&alpha)[2],
                                           float scale_log2, int row0,
                                           int col0, int tk, int causal) {
  if (kMask) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = col0 + 8 * i + (e & 1), row = row0 + 8 * (e >> 1);
        if (key >= tk || (causal && key > row)) s[4 * i + e] = kNegInf;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale_log2);
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float& x = s[4 * i + 2 * r + u];
        x = exp2_approx(fmaf(x, scale_log2, -m_new));
        sum += x;
      }
    l[r] = alpha[r] * l[r] + sum;
  }
}

// O *= alpha by row, then P (in s) rounded to bf16 into the A fragments of
// O += P V: k16 step kk takes accumulator chunks 2 kk and 2 kk + 1.
__device__ __forceinline__ void wg_rescale_pack(float (&acc)[32],
                                                const float (&s)[32],
                                                const float (&alpha)[2],
                                                uint32_t (&p)[4][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      p[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// s = Q K^T over a depth of 64, Q and K 64-row K-major tiles; one group.
__device__ __forceinline__ void wg_issue_s(float (&s)[32], uint32_t q_addr,
                                           uint32_t k_addr) {
  using namespace hopper;
  wgmma_ss<false>(s, desc_k_major(q_addr, 0), desc_k_major(k_addr, 0));
#pragma unroll
  for (int kd = 1; kd < 4; ++kd)
    wgmma_ss<true>(s, desc_k_major(q_addr, kd), desc_k_major(k_addr, kd));
  wgmma_commit();
}

// acc += P V over the tile's 64 keys, V MN-major; one group.
__device__ __forceinline__ void wg_issue_pv(float (&acc)[32],
                                            const uint32_t (&p)[4][4],
                                            uint32_t v_addr) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, p[kk], desc_mn_major(v_addr, kk));
  wgmma_commit();
}

// A block is one warpgroup owning 64 q rows of one bh.  Tile j of K and V
// sits in stage j % kStages; once every warp is done with it, thread 0
// refills the stage with tile j + kStages.  "Done" is a block barrier: it
// ran faster than per-warp arrivals on an mbarrier that thread 0 waits
// for (0.132 against 0.146 ms at BH 768 on an H100, PERF.md).  Every
// thread waits for every tile, so no copy outlives the block.
__global__ void __launch_bounds__(kWgThreads, 4)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       bf16* __restrict__ out, float* __restrict__ lse,
                       int tq, int tk, int d, int n_qtiles, float scale_log2,
                       int causal) {
  using namespace hopper;
  using L = WgSmem;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_addr(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* q_bar = full + kStages;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_qtiles;
  // the block's q rows; the last tile (the longest under `causal`) first
  const int q0 = (n_qtiles - 1 - blockIdx.x % n_qtiles) * kWgRows;
  const int row_w = q0 + 16 * warp;  // the warp's first row
  // keys past the block's last q row are all masked under `causal`
  const int kend = causal ? min(tk, q0 + kWgRows) : tk;
  const int n_kt = (kend + kWgRows - 1) / kWgRows;

  auto load_kv = [&](int j) {  // one thread: K and V of key tile j
    const int st = j % kStages;
    mbar_expect_tx(&full[st], 2 * kWgTileBytes);
    tma_load_3d(base + L::kK + st * kWgTileBytes, &k_map, &full[st], 0,
                j * kWgRows, bh);
    tma_load_3d(base + L::kV + st * kWgTileBytes, &v_map, &full[st], 0,
                j * kWgRows, bh);
  };
  auto needs_mask = [&](int j) {
    const int k0 = j * kWgRows;
    return k0 + kWgRows > tk || (causal && k0 + kWgRows - 1 > row_w);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, kWgTileBytes);
    tma_load_3d(base + L::kQ, &q_map, q_bar, 0, q0, bh);
    for (int j = 0; j < kStages && j < n_kt; ++j) load_kv(j);
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t p[4][4];
  const uint32_t q_addr = sbase + L::kQ;
  auto k_addr = [&](int j) {
    return sbase + L::kK + (j % kStages) * kWgTileBytes;
  };
  auto v_addr = [&](int j) {
    return sbase + L::kV + (j % kStages) * kWgTileBytes;
  };
  const int row0 = row_w + g, col0 = 2 * t;
  mbar_wait(q_bar, 0);

  for (int j = 0; j < n_kt; ++j) {
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    // S = Q K^T: 64 q rows x 64 keys
    float s[32];
    wgmma_fence();
    wg_issue_s(s, q_addr, k_addr(j));
    wgmma_wait<0>();
    fence_regs(s);
    if (needs_mask(j))
      wg_softmax<true>(s, m, l, alpha, scale_log2, row0, col0 + j * kWgRows,
                       tk, causal);
    else
      wg_softmax<false>(s, m, l, alpha, scale_log2, row0,
                        col0 + j * kWgRows, tk, causal);
    // O = alpha O + P V over the tile's 64 keys
    wg_rescale_pack(acc, s, alpha, p);
    fence_regs(p);
    wgmma_fence();
    wg_issue_pv(acc, p, v_addr(j));
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    __syncthreads();  // stage j % kStages read by every warp
    if (tid == 0 && j + kStages < n_kt) load_kv(j + kStages);
  }

  // epilogue: each warp's 16 rows through its own rows of the Q tile (read
  // by no product any more), in the 128-byte swizzle (no bank conflicts),
  // then 16-byte stores of rows < tq, columns < d
  unsigned char* os = base + L::kQ;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr = keep_nan_max(lr, 1e-30f);
    const float inv = 1.f / lr;
    const int row = 16 * warp + g + 8 * r;  // in the tile
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint32_t*>(os + swizzled(row, 8 * i + 2 * t)) =
          pack_bf16(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
    const int qpos = row0 + 8 * r;
    if (t == 0 && qpos < tq)
      lse[int64_t(bh) * tq + qpos] = m[r] * kLn2 + logf(lr);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * 8; c += 32) {
    const int row = 16 * warp + c / 8, col = (c % 8) * 8;
    const int qpos = row_w + c / 8;
    if (qpos < tq && col < d)
      *reinterpret_cast<uint4*>(out + (int64_t(bh) * tq + qpos) * d + col) =
          *reinterpret_cast<const uint4*>(os + swizzled(row, col));
  }
}

// ---------------------------------------------------------------------------
// wgmma fed by a TMA ring, head widths above 256 (wgmma_wide)
// ---------------------------------------------------------------------------

constexpr int kWideAtoms = 4;   // output atoms (256 columns) a block
constexpr int kWideStages = 4;  // (Q atom, K atom) pairs of the ring
constexpr uint32_t kWidePair = 2 * kWgTileBytes;

// Shared memory in bytes from a 1024-aligned base: the ring's stages (a Q
// atom, then the K atom of the same columns), the V tile of the block's
// columns, then the mbarriers (one a stage, V's).
struct WideSmem {
  static constexpr uint32_t kRing = 0;
  static constexpr uint32_t kV = kRing + kWideStages * kWidePair;
  static constexpr uint32_t kBar = kV + kWideAtoms * kWgTileBytes;
  static constexpr size_t kBytes =
      kBar + (kWideStages + 1) * sizeof(uint64_t) + 1024;
};

// s (+)= Q_a K_a^T over one atom's 64 columns of depth, Q's and K's atoms
// at `stage`; without kAccumulate the first product overwrites s.
template <bool kAccumulate>
__device__ __forceinline__ void wide_issue_s(float (&s)[32],
                                             uint32_t stage) {
  using namespace hopper;
  wgmma_ss<kAccumulate>(s, desc_k_major(stage, 0),
                        desc_k_major(stage + kWgTileBytes, 0));
#pragma unroll
  for (int kd = 1; kd < 4; ++kd)
    wgmma_ss<true>(s, desc_k_major(stage, kd),
                   desc_k_major(stage + kWgTileBytes, kd));
  wgmma_commit();
}

// A block is one warpgroup owning 64 q rows of one bh and a group of 256
// output columns (blocks: bh x q tiles x groups, the last q tile first).
// Neither a Q nor a K tile of a wide head fits in shared memory beside a
// ring (64 x 1024 bf16 is 128 KB), so S = Q K^T of each key tile streams
// the depth's atoms: pair c (key tile c / na, atom c % na) sits in stage
// c % kWideStages, and once every warp's products of pair c - 1 are done
// (wgmma_wait<1> with pair c in flight, then a block barrier) thread 0
// refills its stage with pair c - 1 + kWideStages.  The softmax is the d
// 33-64 design's; P, rounded to bf16 in registers, is the A operand of O
// += P V over the block's 4 atoms of V, one m64n64k16 an atom and k16
// step, V loaded (only its atoms that hold columns < d) once the previous
// tile's products are done, while the next S runs.  S is computed once per
// column group: 2 x (the least FLOP) at d 512, 2.5 x at d 1024.  Group 0
// writes lse.
__global__ void __launch_bounds__(kWgThreads, 2)
flash_fwd_wgmma_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            bf16* __restrict__ out, float* __restrict__ lse,
                            int tq, int tk, int d, int n_qtiles, int n_groups,
                            float scale_log2, int causal) {
  using namespace hopper;
  using L = WideSmem;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_addr(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* v_bar = full + kWideStages;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int per_bh = n_qtiles * n_groups;
  const int bh = blockIdx.x / per_bh;
  const int rest = blockIdx.x % per_bh;
  const int q0 = (n_qtiles - 1 - rest / n_groups) * kWgRows;
  const int grp = rest % n_groups;
  const int c0 = grp * kWideAtoms * 64;  // the block's first output column
  const int row_w = q0 + 16 * warp;      // the warp's first row
  // keys past the block's last q row are all masked under `causal`
  const int kend = causal ? min(tk, q0 + kWgRows) : tk;
  const int n_kt = (kend + kWgRows - 1) / kWgRows;
  const int na = (d + 63) / 64;  // atoms of the depth
  const int n_pairs = n_kt * na;
  // V's atoms in this group that hold columns < d
  const int nv = min(kWideAtoms, (d - c0 + 63) / 64);

  auto load_pair = [&](int c) {  // one thread: Q's and K's atom of pair c
    const int st = c % kWideStages, at = c % na;
    unsigned char* dst = base + L::kRing + st * kWidePair;
    mbar_expect_tx(&full[st], kWidePair);
    tma_load_3d(dst, &q_map, &full[st], 64 * at, q0, bh);
    tma_load_3d(dst + kWgTileBytes, &k_map, &full[st], 64 * at,
                (c / na) * kWgRows, bh);
  };
  auto load_v = [&](int j) {  // one thread: V's atoms of key tile j
    mbar_expect_tx(v_bar, nv * kWgTileBytes);
    for (int at = 0; at < nv; ++at)
      tma_load_3d(base + L::kV + at * kWgTileBytes, &v_map, v_bar,
                  c0 + 64 * at, j * kWgRows, bh);
  };
  auto stage = [&](int c) {
    return sbase + L::kRing + (c % kWideStages) * kWidePair;
  };
  auto needs_mask = [&](int j) {
    const int k0 = j * kWgRows;
    return k0 + kWgRows > tk || (causal && k0 + kWgRows - 1 > row_w);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kWideStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < kWideStages && c < n_pairs; ++c) load_pair(c);
    load_v(0);
  }

  float acc[kWideAtoms][32];
#pragma unroll
  for (int at = 0; at < kWideAtoms; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[at][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t p[4][4];
  const int row0 = row_w + g, col0 = 2 * t;
  int c = 0;  // the next pair to compute

  for (int j = 0; j < n_kt; ++j) {
    // S = Q K^T: 64 q rows x 64 keys over the depth's atoms
    float s[32];
    mbar_wait(&full[c % kWideStages], (c / kWideStages) & 1);
    wgmma_fence();
    wide_issue_s<false>(s, stage(c));
    ++c;
    for (int at = 1; at < na; ++at, ++c) {
      mbar_wait(&full[c % kWideStages], (c / kWideStages) & 1);
      wgmma_fence();
      wide_issue_s<true>(s, stage(c));
      wgmma_wait<1>();  // pair c - 1's products are done
      __syncthreads();  // ... in every warp
      if (tid == 0 && c - 1 + kWideStages < n_pairs)
        load_pair(c - 1 + kWideStages);
    }
    wgmma_wait<0>();
    fence_regs(s);
    __syncthreads();
    if (tid == 0 && c - 1 + kWideStages < n_pairs)
      load_pair(c - 1 + kWideStages);
    if (needs_mask(j))
      wg_softmax<true>(s, m, l, alpha, scale_log2, row0, col0 + j * kWgRows,
                       tk, causal);
    else
      wg_softmax<false>(s, m, l, alpha, scale_log2, row0,
                        col0 + j * kWgRows, tk, causal);
    // O = alpha O + P V over the tile's 64 keys and the group's columns
#pragma unroll
    for (int at = 0; at < kWideAtoms; ++at)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[at][i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        p[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    mbar_wait(v_bar, j & 1);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int at = 0; at < kWideAtoms; ++at)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[at], p[kk],
                 desc_mn_major(sbase + L::kV + at * kWgTileBytes, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    __syncthreads();  // V read by every warp
    if (tid == 0 && j + 1 < n_kt) load_v(j + 1);
  }

  // epilogue: 4-byte stores of rows < tq, columns < d; lse by group 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr = keep_nan_max(lr, 1e-30f);
    const float inv = 1.f / lr;
    const int qpos = row0 + 8 * r;
    if (qpos >= tq) continue;
    if (grp == 0 && t == 0) lse[int64_t(bh) * tq + qpos] = m[r] * kLn2 + logf(lr);
#pragma unroll
    for (int at = 0; at < kWideAtoms; ++at)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = c0 + 64 * at + 8 * i + 2 * t;
        if (col < d)
          *reinterpret_cast<uint32_t*>(out + (int64_t(bh) * tq + qpos) * d +
                                       col) =
              pack_bf16(acc[at][4 * i + 2 * r] * inv,
                        acc[at][4 * i + 2 * r + 1] * inv);
      }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The SM count of device `dev`, read from the runtime once per device.
int sm_count(int dev) {
  static std::mutex mu;
  static std::map<int, int> cache;
  const std::lock_guard<std::mutex> lock(mu);
  int& n = cache[dev];
  if (n == 0) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

struct Args {
  const bf16 *q, *k, *v;
  bf16* out;
  float* lse;
  int bh, tq, tk, d, causal, dev;
  float scale;
  cudaStream_t stream;
};

template <int DP, int MT>
cudaError_t launch_mt(const Args& a) {
  constexpr bool kQInRegs = DP * MT <= 128;
  constexpr size_t smem = Layout<DP, MT>::kSmemBytes;
  const auto kernel = flash_fwd_bf16_kernel<DP, MT, kQInRegs>;
  static hopper::SmemLimit limit;
  const cudaError_t err = limit.raise(kernel, a.dev, smem);
  if (err != cudaSuccess) return err;
  const int block_m = Layout<DP, MT>::kBlockM;
  const int n_qtiles = (a.tq + block_m - 1) / block_m;
  if (int64_t(a.bh) * n_qtiles > INT32_MAX) return cudaErrorInvalidValue;
  kernel<<<a.bh * n_qtiles, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.out, a.lse, a.tq, a.tk, a.d, n_qtiles,
      a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

// mma.sync: 128-row q tiles (two m tiles a warp) read each K and V
// fragment from shared memory once for twice the rows, and each K/V tile
// from L2 once for twice the rows, but make half as many blocks; they are
// taken at widths up to 32 (registers: 250 a thread at 64) once the grid
// has 2 such blocks for every SM.
template <int DP>
cudaError_t launch_mma(const Args& a) {
  if constexpr (DP <= 32) {
    if (int64_t(a.bh) * ((a.tq + 127) / 128) >= 2 * int64_t(sm_count(a.dev)))
      return launch_mt<DP, 2>(a);
  }
  return launch_mt<DP, 1>(a);
}

// wgmma: one warpgroup a block, 64 q rows (and, above d 256, a group of
// 256 output columns).
cudaError_t launch_wgmma(const Args& a, bool wide) {
  // TMA reads and the 16-byte stores need 16-byte aligned rows
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.q) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) |
                         reinterpret_cast<uintptr_t>(a.out);
  if (addr % 16) return cudaErrorInvalidValue;
  using hopper::tile_map;
  CUtensorMap qm, km, vm;
  cudaError_t err;
  if ((err = tile_map(&qm, a.q, a.bh, a.tq, a.d)) != cudaSuccess ||
      (err = tile_map(&km, a.k, a.bh, a.tk, a.d)) != cudaSuccess ||
      (err = tile_map(&vm, a.v, a.bh, a.tk, a.d)) != cudaSuccess)
    return err;
  const int n_qtiles = (a.tq + kWgRows - 1) / kWgRows;
  const int n_groups = wide ? (a.d + 64 * kWideAtoms - 1) / (64 * kWideAtoms)
                            : 1;
  if (int64_t(a.bh) * n_qtiles * n_groups > INT32_MAX)
    return cudaErrorInvalidValue;
  const int grid = a.bh * n_qtiles * n_groups;
  static hopper::SmemLimit limit, wide_limit;
  if (wide) {
    constexpr size_t smem = WideSmem::kBytes;
    if ((err = wide_limit.raise(flash_fwd_wgmma_wide_kernel, a.dev, smem)) !=
        cudaSuccess)
      return err;
    flash_fwd_wgmma_wide_kernel<<<grid, kWgThreads, smem, a.stream>>>(
        qm, km, vm, a.out, a.lse, a.tq, a.tk, a.d, n_qtiles, n_groups,
        a.scale * kLog2e, a.causal);
  } else {
    constexpr size_t smem = WgSmem::kBytes;
    if ((err = limit.raise(flash_fwd_wgmma_kernel, a.dev, smem)) !=
        cudaSuccess)
      return err;
    flash_fwd_wgmma_kernel<<<grid, kWgThreads, smem, a.stream>>>(
        qm, km, vm, a.out, a.lse, a.tq, a.tk, a.d, n_qtiles,
        a.scale * kLog2e, a.causal);
  }
  return cudaGetLastError();
}

// The forward's designs, as flash_attention.py's fwd_design names them
// (flash_attention_fwd_f32.cu runs the scalar, wide and wgmma_tf32 ones;
// kWgmmaPair is the backward's alone).
enum Design {
  kScalar = 0, kMmaSync = 1, kWgmma = 2, kWide = 3, kWgmmaTf32 = 4,
  kWgmmaWide = 5, kWgmmaPair = 6
};

// The design that takes a head of (padded) width d.
Design design(bool is_bf16, int d) {
  if (d > 256) return is_bf16 ? kWgmmaWide : kWide;
  if (!is_bf16) return d <= 64 ? kWgmmaTf32 : kScalar;
  if (d > 32 && d <= 64) return kWgmma;
  return kMmaSync;
}

}  // namespace

// Plain C entry point, bound with ctypes.  Takes any d that is a multiple
// of 8; launches on `stream`, does not synchronise, allocates nothing;
// returns the launch's cudaError_t (0 on success).  The wgmma designs (d
// 33-64 and above 256) need 16-byte aligned tensors.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int bh, int tq, int tk, int d,
                                        int causal, float scale,
                                        void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 8 || d % 8)
    return cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<bf16*>(out),
         static_cast<float*>(lse), bh, tq, tk, d, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaGetDevice(&a.dev);
  if (err != cudaSuccess) return err;
  const Design des = design(true, d);
  if (des == kWgmma || des == kWgmmaWide)
    return launch_wgmma(a, des == kWgmmaWide);
  if (d <= 16) return launch_mma<16>(a);
  if (d <= 32) return launch_mma<32>(a);
  if (d <= 96) return launch_mma<96>(a);
  if (d <= 128) return launch_mma<128>(a);
  return launch_mma<256>(a);
}

// The design (Design above) the bf16 (is_bf16 != 0) or f32 forward takes
// for a head of width d.
extern "C" int flash_attention_fwd_design(int is_bf16, int d) {
  return design(is_bf16 != 0, d);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
