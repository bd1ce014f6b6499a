// Flash-attention forward for Hopper (sm_90a), bfloat16 on the tensor cores.
//
// Replaces analytics_zoo_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// TPU kernel launched by _flash_fwd_pallas) for bfloat16 inputs; float32
// inputs take the exact scalar kernel of flash_attention_fwd_f32.cu.  For
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
// q, k, v from device memory about once.
//
// Design (the FA2 structure on mma.sync; the TPU kernel's blocking is not
// carried over):
//   * a block of 4 warps owns one q tile of one bh: 64 rows, 16 per warp,
//     or, at head widths up to 64 when the grid still fills the card, 128
//     rows, two m16 tiles per warp, so that every K and V fragment read
//     from shared memory (and every K/V tile read from L2) serves twice the
//     rows.  q tiles x BH are linearised onto gridDim.x, so any BH fits,
//     and within a bh the last q tile (the longest under `causal`) is
//     scheduled first;
//   * the q tile is copied once into shared memory in bf16, and each warp
//     moves its rows with ldmatrix into A fragments that stay in registers
//     for the whole key loop (at D 256 they are re-read from shared memory
//     each tile, to stay under 255 registers);
//   * 64-key K and V tiles are double-buffered in bf16 with cp.async 16-byte
//     copies: tile j+1 is in flight while tile j is computed.  Rows >= Tk and
//     columns >= d are zero-filled by the copy, never read from device
//     memory.  Shared rows are padded by 16 bytes, which makes the eight row
//     addresses of every ldmatrix fall in distinct bank groups;
//   * S = Q K^T runs as mma.sync m16n8k16 (bf16 in, f32 accumulate), K's B
//     fragments by ldmatrix; the online softmax works on the f32 accumulator
//     fragments in registers: row max and row sum reduce over the 4 lanes
//     of a quad, and 2^x (ex2.approx) takes scale * log2(e) folded into one
//     FMA;
//   * P never leaves registers: the f32 accumulators of two adjacent n8
//     tiles are exactly the A fragment of one k16 step (see warp_mma.cuh),
//     so P is rounded to bf16 in place and fed to the P V mma.sync, with V's
//     B fragments by ldmatrix.trans.  l is summed from the f32 P;
//   * the epilogue scales by 1 / max(l, 1e-30), stages the warp's rows in
//     shared memory and stores them with coalesced 16-byte stores; lse in
//     f32.
// The kernel is instantiated for padded head widths DP = 16, 32, 64, 96,
// 128, 256 and takes the true d <= DP at run time; d must be a multiple of 8
// (each row a whole number of 16-byte copies), and the wrapper pads the rare
// other d.  What it leaves: wgmma with a TMA-fed ring and warp
// specialisation, which only Hopper has, and persistent scheduling.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace warp_mma;

constexpr int kBlockN = 64;   // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
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
      lr = fmaxf(lr, 1e-30f);
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

template <int DP, int MT>
cudaError_t launch_mt(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                      float* lse, int bh, int tq, int tk, int d, float scale,
                      int causal, cudaStream_t stream) {
  constexpr bool kQInRegs = DP * MT <= 128;
  constexpr size_t smem = Layout<DP, MT>::kSmemBytes;
  const auto kernel = flash_fwd_bf16_kernel<DP, MT, kQInRegs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int block_m = Layout<DP, MT>::kBlockM;
  const int n_qtiles = (tq + block_m - 1) / block_m;
  if (int64_t(bh) * n_qtiles > INT32_MAX) return cudaErrorInvalidValue;
  kernel<<<bh * n_qtiles, kThreads, smem, stream>>>(
      q, k, v, out, lse, tq, tk, d, n_qtiles, scale * kLog2e, causal);
  return cudaGetLastError();
}

// 128-row q tiles (two m tiles a warp) read each K and V fragment from
// shared memory once for twice the rows, and each K/V tile from L2 once for
// twice the rows, but make half as many blocks (and, at 250 registers a
// thread, fit 2 blocks an SM against 3); they are taken at head widths up
// to 64 (registers) once the grid has 2 such blocks for every SM.
bool two_m_tiles(int bh, int tq) {
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  return int64_t(bh) * ((tq + 127) / 128) >= 2 * int64_t(n_sm);
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   float* lse, int bh, int tq, int tk, int d, float scale,
                   int causal, cudaStream_t stream) {
  if constexpr (DP <= 64) {
    if (two_m_tiles(bh, tq))
      return launch_mt<DP, 2>(q, k, v, out, lse, bh, tq, tk, d, scale,
                              causal, stream);
  }
  return launch_mt<DP, 1>(q, k, v, out, lse, bh, tq, tk, d, scale, causal,
                          stream);
}

}  // namespace

// Plain C entry point, bound with ctypes.  Takes d in 8, 16, ..., 256;
// launches on `stream`, does not synchronise, allocates nothing; returns the
// launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int bh, int tq, int tk, int d,
                                        int causal, float scale,
                                        void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 8 || d > 256 || d % 8)
    return cudaErrorInvalidValue;
  const bf16* qh = static_cast<const bf16*>(q);
  const bf16* kh = static_cast<const bf16*>(k);
  const bf16* vh = static_cast<const bf16*>(v);
  bf16* oh = static_cast<bf16*>(out);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch<16>(qh, kh, vh, oh, lf, bh, tq, tk, d, scale, causal, s);
  if (d <= 32) return launch<32>(qh, kh, vh, oh, lf, bh, tq, tk, d, scale, causal, s);
  if (d <= 64) return launch<64>(qh, kh, vh, oh, lf, bh, tq, tk, d, scale, causal, s);
  if (d <= 96) return launch<96>(qh, kh, vh, oh, lf, bh, tq, tk, d, scale, causal, s);
  if (d <= 128) return launch<128>(qh, kh, vh, oh, lf, bh, tq, tk, d, scale, causal, s);
  return launch<256>(qh, kh, vh, oh, lf, bh, tq, tk, d, scale, causal, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
