// Flash-attention forward for Hopper (sm_90a), float32 at f32's accuracy.
//
// Replaces analytics_zoo_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// TPU kernel launched by _flash_fwd_pallas) for float32 inputs; the bfloat16
// path is the tensor-core kernel of flash_attention_fwd.cu.  For q, k, v
// laid out [BH, T, d] and contiguous:
//   out[bh, i] = softmax_j(scale * q_i . k_j, masked) @ v      (f32)
//   lse[bh, i] = m_i + log(max(l_i, 1e-30))                    (f32)
// with key positions >= Tk masked and, under `causal`, q < k masked
// (absolute positions, so Tq != Tk works).  Masked logits are -1e30.
//
// What bounds it.  4 * BH * Tq * Tk * d FLOP against q, k, v read once and
// out written once: at BERT-base (T 512, d 64) about 128 FLOP per byte in
// f32.  At f32's accuracy on the tensor cores (3xTF32: three tf32
// products per f32 product at 495 TFLOP/s) that is 0.078 ms at BH 192,
// bound by operations; on the f32 FMAs (67 TFLOP/s) 0.19 ms.
//
// Three designs, by head width (flash_attention.py's fwd_design names
// them):
//
// wgmma_tf32, heads up to 64 (BERT's f32 path): wgmma in 3xTF32, the
// forward counterpart of flash_attention_bwd.cu's dQ pass.
//   * a split pass (flash_tf32.cuh) first writes k's big and small tf32
//     parts as they are and v's transposed, T in the group-of-8 order that
//     lets P pass from its accumulator to register A fragments;
//   * a block is one warpgroup owning 64 q rows of one bh (q tiles x BH on
//     gridDim.x, the last q tile first).  Each thread reads its elements
//     of Q once from device memory and splits them into the register A
//     fragments of S = Q K^T (64 registers); 32-key tiles of K's and V^T's
//     parts (32 KB a stage) stream through a 2-stage TMA ring, each stage
//     completed on an mbarrier and refilled by one thread once every warp
//     is done with it.  At 65 KB three blocks share an SM, so one block's
//     softmax overlaps the others' products;
//   * S is 24 wgmma m64n32k8 (3 a k8 step), A from registers, B (K's
//     parts) K-major in shared memory; the online softmax runs on its f32
//     accumulators (rows reduced over the 4 lanes of a quad): scale,
//     masks only on edge and diagonal tiles, expf, the running max and
//     sum, the accumulator rescaled by exp(m_old - m_new);
//   * P is split into big and small straight into the register A
//     fragments of O += P V, 12 wgmma m64n64k8 whose B is V^T's parts;
//   * the epilogue divides by max(l, 1e-30) and stores rows < Tq, columns
//     < d; lse in f32.  The key loop stops at the diagonal under `causal`.
//
// scalar, heads 65-256: the port's first design, one CUDA block per (bh,
// 64-row q tile) looping over 64-key tiles (the TPU's sequential k grid
// axis), 256 threads in a 16 x 16 grid on scalar FMAs.  The kernel is
// instantiated for head widths D = 128 and 256 and takes the true d <= D
// at run time: columns >= d are zero in shared memory (they add 0 to
// every dot product) and are never stored.
//   * the q tile is staged once in shared memory, transposed [D][64], so a
//     thread reads its 4 rows with one 16-byte load;
//   * each k/v tile is staged in shared memory as f32 (K transposed
//     [D][64+1] so that the 16 threads of a row group read 16 consecutive
//     keys);
//   * thread (ty, tx) owns q rows 4*ty..4*ty+3, logits columns tx + 16*j
//     of each key tile and output columns tx + 16*j of D.  Row max and row
//     sum reduce over the 16 tx lanes of a half-warp with shuffles; m, l
//     and the accumulator stay in registers for the whole key loop;
//   * P goes through shared memory ([64 keys][64+4 rows]) for P @ V;
//   * under `causal` the key loop stops at the tile holding the diagonal.
//   Its loads are synchronous and every product goes through shared
//   memory, so it runs at a fraction of the FMAs' rate.
//
// wide, heads above 256 (f32, and bf16 inputs computed in f32 as the TPU
// kernel upcasts its blocks): 16-row q tiles and 16-key tiles, the head
// dim staged in chunks of 64 columns for S, and each block owning a chunk
// of 256 output columns (S is recomputed once per chunk); thread (a, b) of
// the 16 x 16 grid holds logit (row a, key b), the online softmax reduces
// over the 16 lanes of a half-warp, and thread t accumulates output column
// t of the chunk for all 16 rows, reading V from device memory.
//
// What it leaves: splitting K and V in shared memory after the TMA load
// instead of the split pass's traffic, a producer warp, and tensor cores
// for f32 heads wider than 64.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_tf32.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;            // q rows per CUDA block
constexpr int kBlockK = 64;            // keys per tile
constexpr int kThreads = 256;          // 16 x 16 thread grid
constexpr int kQStride = kBlockQ + 4;  // Qt / Pt row stride (16-byte aligned)
constexpr int kKStride = kBlockK + 1;  // Kt row stride (transposing writes)
constexpr float kNegInf = -1e30f;

// max(x, lo) that keeps a NaN, as the plain version's clamp and the JAX
// kernel's jnp.maximum do: fmaxf drops it, so a row of NaN logits would
// leave a finite lse.
__device__ __forceinline__ float keep_nan_max(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(D) * kQStride      // Qt
                          + size_t(D) * kKStride    // Kt
                          + size_t(kBlockK) * D     // Vs
                          + size_t(kBlockK) * kQStride);  // Pt
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int tq, int tk, int d,
                     int n_qtiles, float scale, int causal) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DJ = D / 16;  // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                    // [D][kQStride]
  float* Kt = Qt + D * kQStride;       // [D][kKStride]
  float* Vs = Kt + D * kKStride;       // [kBlockK][D]
  float* Pt = Vs + kBlockK * D;        // [kBlockK][kQStride]

  const size_t bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* qb = q + bh * size_t(tq) * d;
  const float* kb = k + bh * size_t(tk) * d;
  const float* vb = v + bh * size_t(tk) * d;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    Qt[c * kQStride + r] =
        (q0 + r < tq && c < d) ? qb[size_t(q0 + r) * d + c] : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // keys past the last q row of this tile are all masked under `causal`
  const int kend = causal ? min(tk, q0 + kBlockQ) : tk;
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // previous tile fully consumed (and Qt written)
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < tk && c < d;
      const size_t off = size_t(k0 + r) * d + c;
      Kt[c * kKStride + r] = in ? kb[off] : 0.f;
      Vs[r * D + c] = in ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(
          &Qt[c * kQStride + ty * 4]);
      const float* kr = &Kt[c * kKStride + tx];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = kr[16 * j];
        s[0][j] = fmaf(qv.x, kv, s[0][j]);
        s[1][j] = fmaf(qv.y, kv, s[1][j]);
        s[2][j] = fmaf(qv.z, kv, s[2][j]);
        s[3][j] = fmaf(qv.w, kv, s[3][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = kpos < tk && (!causal || qpos >= kpos);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx + 16 * j) * kQStride + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int kn = min(kBlockK, tk - k0);  // masked keys have p == 0
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(
          &Pt[kk * kQStride + ty * 4]);
      const float* vr = &Vs[kk * D + tx];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = vr[16 * j];
        acc[0][j] = fmaf(p.x, vv, acc[0][j]);
        acc[1][j] = fmaf(p.y, vv, acc[1][j]);
        acc[2][j] = fmaf(p.z, vv, acc[2][j]);
        acc[3][j] = fmaf(p.w, vv, acc[3][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= tq) continue;
    const float denom = keep_nan_max(l[i], 1e-30f);
    float* orow = out + (bh * size_t(tq) + r) * d;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (tx + 16 * j < d) orow[tx + 16 * j] = acc[i][j] / denom;
    if (tx == 0) lse[bh * size_t(tq) + r] = m[i] + logf(denom);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* lse, int bh, int tq, int tk, int d, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static hopper::SmemLimit limit;
  if ((err = limit.raise(flash_fwd_f32_kernel<D>, dev, smem)) != cudaSuccess)
    return err;
  const int n_qtiles = (tq + kBlockQ - 1) / kBlockQ;
  if (int64_t(bh) * n_qtiles > INT32_MAX) return cudaErrorInvalidValue;
  flash_fwd_f32_kernel<D><<<bh * n_qtiles, kThreads, smem, stream>>>(
      q, k, v, out, lse, tq, tk, d, n_qtiles, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma in 3xTF32, heads up to 64
// ---------------------------------------------------------------------------

constexpr int kTfMaxHeadDim = 64;
constexpr int kWgThreads = 128;  // one warpgroup
// Stages of the ring and blocks an SM: 3 stages at two blocks ran 12%
// slower at BERT's shapes (PERF.md).
constexpr int kTfStages = 2;
constexpr int kTfBlocksPerSm = 3;

// Shared memory, bytes from a 1024-aligned base: kTfStages stages of K's
// parts (32 keys x d 0-63, big and small) and V^T's (d 0-63 x 32 keys),
// then their mbarriers.
struct TfSmem {
  static constexpr uint32_t kStage = 2 * kTfRowPart + 2 * kTfColPart;
  static constexpr uint32_t kBar = kTfStages * kStage;
  static constexpr size_t kBytes =
      kBar + kTfStages * sizeof(uint64_t) + 1024;
};
static_assert(kTfBlocksPerSm * (TfSmem::kBytes + 1024) <= 233472,
              "shared memory of the blocks an SM");

// The online softmax of one m64n32 tile of S (this thread's element 4 i +
// e at row row0 + 8 (e >> 1), key col0 + 8 i + (e & 1)): the logits
// scaled, with kMask keys >= tk and, under `causal`, keys after the row set
// to -1e30; the running max m and this lane's part of the running sum l
// updated; alpha the factor that rescales each of the two rows'
// accumulators; P split into big and small straight into the A fragments
// of O += P V (k8 step i = n8 chunk i, hopper.cuh's order: a0 = e 0, a1 =
// e 2, a2 = e 1, a3 = e 3).
template <bool kMask>
__device__ __forceinline__ void tf32_softmax(
    const float (&s)[16], float (&m)[2], float (&l)[2], float (&alpha)[2],
    uint32_t (&pb)[4][4], uint32_t (&ps)[4][4], float scale, int row0,
    int col0, int tk, int causal) {
  float x[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[4 * i + e] = s[4 * i + e] * scale;
      if (kMask) {
        const int key = col0 + 8 * i + (e & 1), row = row0 + 8 * (e >> 1);
        if (key >= tk || (causal && key > row)) x[4 * i + e] = kNegInf;
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mx = fmaxf(mx, fmaxf(x[4 * i + 2 * h], x[4 * i + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    alpha[h] = expf(m[h] - m_new);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p = expf(x[4 * i + 2 * h + u] - m_new);
        sum += p;
        hopper::tf32_split(p, pb[i][2 * u + h], ps[i][2 * u + h]);
      }
    l[h] = alpha[h] * l[h] + sum;
  }
}

// Q is held in registers as the A fragments of S = Q K^T (its big and
// small parts, 64 registers a thread), so the products read only K's
// parts from shared memory: with both operands there, m64n32k8 reads 3 KB
// for 32 KFLOP, which shared memory's 128 bytes a clock cannot feed at
// the tensor cores' rate (PERF.md).  Per key tile of 32, a block waits for
// the tile's parts, issues S (24 products), waits, runs the online
// softmax, issues O += P V (12) and waits again; a stage is refilled once
// every warp has finished the tile in it.  Every thread waits for every
// tile, so no copy outlives the block.
__global__ void __launch_bounds__(kWgThreads, kTfBlocksPerSm)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap vt_map,
                      float* __restrict__ out, float* __restrict__ lse,
                      int tq, int tk, int d, int n_qtiles, float scale,
                      int causal) {
  using namespace hopper;
  using L = TfSmem;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw +
      ((1024 - (warp_mma::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = warp_mma::smem_addr(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);  // stages

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_qtiles;
  // the block's q rows; the last tile (the longest under `causal`) first
  const int q0 = (n_qtiles - 1 - blockIdx.x % n_qtiles) * kTfHeld;
  const int row_w = q0 + 16 * warp;  // the warp's first row
  // keys past the block's last q row are all masked under `causal`
  const int kend = causal ? min(tk, q0 + kTfHeld) : tk;
  const int n_kt = (kend + kTfRows - 1) / kTfRows;

  auto load_kv = [&](int j) {  // one thread: key tile j's parts
    const int st = j % kTfStages, k0 = j * kTfRows;
    unsigned char* sp = base + st * L::kStage;
    mbar_expect_tx(&full[st], L::kStage);
    for (int part = 0; part < 2; ++part) {
      for (int a = 0; a < 2; ++a)
        tma_load_3d(sp + part * kTfRowPart + a * kTfRowAtom, &k_map,
                    &full[st], 32 * a, k0, 2 * bh + part);
      tma_load_3d(sp + 2 * kTfRowPart + part * kTfColPart, &vt_map,
                  &full[st], k0, 0, 2 * bh + part);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kTfStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < kTfStages && j < n_kt; ++j) load_kv(j);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  const int row0 = row_w + g;
  // this thread's A fragments of Q, split into big and small parts, k8
  // step kk: rows row0 (+ 8), depth 8 kk + t (+ 4); zeros past tq and d
  uint32_t qb[8][4], qs[8][4];
  const float* qh = q + int64_t(bh) * tq * d;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = row0 + 8 * (x & 1), col = 8 * kk + t + 4 * (x >> 1);
      const float e =
          row < tq && col < d ? qh[int64_t(row) * d + col] : 0.f;
      tf32_split(e, qb[kk][x], qs[kk][x]);
    }

  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kTfStages;
    const int k0 = j * kTfRows;
    const uint32_t k_addr = sbase + st * L::kStage;
    const uint32_t vt_addr = k_addr + 2 * kTfRowPart;
    mbar_wait(&full[st], (j / kTfStages) & 1);
    // S = Q K^T: 64 q rows x 32 keys
    float s[16];
    fence_regs(qb);
    fence_regs(qs);
    wgmma_fence();
    wgmma_tf32x3_rs<32, false>(s, qb[0], qs[0],
                               desc_tf32(k_addr, 0, kTfRowAtom),
                               desc_tf32(k_addr + kTfRowPart, 0, kTfRowAtom));
#pragma unroll
    for (int kk = 1; kk < 8; ++kk)
      wgmma_tf32x3_rs<32>(s, qb[kk], qs[kk],
                          desc_tf32(k_addr, kk, kTfRowAtom),
                          desc_tf32(k_addr + kTfRowPart, kk, kTfRowAtom));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(qb);
    fence_regs(qs);
    uint32_t pb[4][4], ps[4][4];
    if (k0 + kTfRows > tk || (causal && k0 + kTfRows - 1 > row_w))
      tf32_softmax<true>(s, m, l, alpha, pb, ps, scale, row0, k0 + 2 * t,
                         tk, causal);
    else
      tf32_softmax<false>(s, m, l, alpha, pb, ps, scale, row0, k0 + 2 * t,
                          tk, causal);
    // O = alpha O + P V over the tile's 32 keys
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
    fence_regs(pb);
    fence_regs(ps);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32x3_rs<64>(acc, pb[kk], ps[kk], desc_tf32(vt_addr, kk, 0),
                          desc_tf32(vt_addr + kTfColPart, kk, 0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pb);
    fence_regs(ps);
    __syncthreads();  // stage st read by every warp
    if (tid == 0 && j + kTfStages < n_kt) load_kv(j + kTfStages);
  }

  // this thread's rows row0 and row0 + 8, columns 8 i + 2 t and + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr = keep_nan_max(lr, 1e-30f);
    const int row = row0 + 8 * h;
    if (row >= tq) continue;
    float* o = out + (int64_t(bh) * tq + row) * d;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + 2 * t;
      const float x0 = acc[4 * i + 2 * h] / lr;
      const float x1 = acc[4 * i + 2 * h + 1] / lr;
      if ((d & 1) == 0 && col + 1 < d) {
        *reinterpret_cast<float2*>(o + col) = make_float2(x0, x1);
      } else {
        if (col < d) o[col] = x0;
        if (col + 1 < d) o[col + 1] = x1;
      }
    }
    if (t == 0) lse[int64_t(bh) * tq + row] = m[h] + logf(lr);
  }
}

// The workspace of the wgmma_tf32 design, in floats: k's parts ([2
// bh][tk][dp]) and v's transposed ([2 bh][dp][round8(tk)]).
int64_t tf32_work_floats(int64_t bh, int64_t tk, int d) {
  const int64_t dp = (d + 7) / 8 * 8, tkp = (tk + 7) / 8 * 8;
  return 2 * bh * dp * (tk + tkp);
}

// The split pass into `work`, then the forward.
cudaError_t launch_tf32(const float* q, const float* k, const float* v,
                        float* out, float* lse, float* work, int bh, int tq,
                        int tk, int d, float scale, int causal,
                        cudaStream_t stream) {
  const int dp = (d + 7) / 8 * 8, tkp = (tk + 7) / 8 * 8;
  const int64_t b = bh;
  float* nat_k = work;
  float* tr_v = nat_k + 2 * b * tk * dp;
  const int tiles = (tkp + kTfRows - 1) / kTfRows;
  const int n_qtiles = (tq + kTfHeld - 1) / kTfHeld;
  if (b * tiles > INT32_MAX || b * n_qtiles > INT32_MAX ||
      2 * b > INT32_MAX || work == nullptr ||
      reinterpret_cast<uintptr_t>(work) % 16)
    return cudaErrorInvalidValue;
  const SplitJobs jobs{{{k, nat_k, nullptr, tk, tk},
                        {v, nullptr, tr_v, tk, tkp}}};
  split_tf32_kernel<<<dim3(unsigned(b * tiles), 2), kTfSplitThreads, 0,
                      stream>>>(jobs, tiles, d, dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using hopper::tile_map_f32;
  const int planes = int(2 * b);
  CUtensorMap km, vtm;
  if ((err = tile_map_f32(&km, nat_k, planes, tk, dp, kTfRows)) ||
      (err = tile_map_f32(&vtm, tr_v, planes, dp, tkp, kTfHeld)))
    return err;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  static hopper::SmemLimit limit;
  if ((err = limit.raise(flash_fwd_tf32_kernel, dev, TfSmem::kBytes)) !=
      cudaSuccess)
    return err;
  flash_fwd_tf32_kernel<<<int(b * n_qtiles), kWgThreads, TfSmem::kBytes,
                          stream>>>(q, km, vtm, out, lse, tq, tk, d,
                                    n_qtiles, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Wide head dims (above 256)
// ---------------------------------------------------------------------------

constexpr int kWT = 16;          // q rows and keys per wide tile
constexpr int kWChunk = 64;      // head-dim columns staged at a time
constexpr int kWCols = kThreads; // output columns per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse, int tq, int tk, int d,
                      int n_qtiles, int n_chunks, float scale, int causal) {
  __shared__ float qs[kWT][kWChunk + 1], ks[kWT][kWChunk + 1];
  __shared__ float ps[kWT][kWT + 1], alpha_s[kWT], l_s[kWT];

  const int64_t bh = blockIdx.x / (int64_t(n_qtiles) * n_chunks);
  const int rest = blockIdx.x % (n_qtiles * n_chunks);
  const int q0 = (rest / n_chunks) * kWT;
  const int chunk = rest % n_chunks;
  const int col = chunk * kWCols + threadIdx.x;
  const int tid = threadIdx.x;
  const int a = tid >> 4, b = tid & 15;  // logit (row a, key b)
  const T* qb = q + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;

  float m = kNegInf, l = 0.f;  // row a's, the same in its 16 lanes
  float acc[kWT];
#pragma unroll
  for (int i = 0; i < kWT; ++i) acc[i] = 0.f;

  const int kend = causal ? min(tk, q0 + kWT) : tk;
  for (int k0 = 0; k0 < kend; k0 += kWT) {
    float s = 0.f;
    for (int c0 = 0; c0 < d; c0 += kWChunk) {
      __syncthreads();  // previous chunk (and the previous tile's P) consumed
      for (int idx = tid; idx < kWT * kWChunk; idx += kThreads) {
        const int r = idx / kWChunk, c = idx % kWChunk;
        const bool cin = c0 + c < d;
        qs[r][c] = cin && q0 + r < tq
                       ? to_f(qb[int64_t(q0 + r) * d + c0 + c]) : 0.f;
        ks[r][c] = cin && k0 + r < tk
                       ? to_f(kb[int64_t(k0 + r) * d + c0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kWChunk; ++c) s = fmaf(qs[a][c], ks[b][c], s);
    }
    const int key = k0 + b;
    const bool keep = key < tk && (!causal || q0 + a >= key);
    s = keep ? s * scale : kNegInf;
    const float m_new = fmaxf(m, half_warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = alpha * l + half_warp_sum(p);
    m = m_new;
    ps[a][b] = p;
    if (b == 0) alpha_s[a] = alpha;
    __syncthreads();
    if (col < d) {
#pragma unroll
      for (int i = 0; i < kWT; ++i) acc[i] *= alpha_s[i];
      const int kn = min(kWT, tk - k0);  // keys >= tk are never read
      for (int j = 0; j < kn; ++j) {
        const float vv = to_f(vb[int64_t(k0 + j) * d + col]);
#pragma unroll
        for (int i = 0; i < kWT; ++i) acc[i] = fmaf(ps[i][j], vv, acc[i]);
      }
    }
  }

  const float denom = keep_nan_max(l, 1e-30f);
  if (b == 0) l_s[a] = denom;
  if (chunk == 0 && b == 0 && q0 + a < tq)
    lse[bh * tq + q0 + a] = m + logf(denom);
  __syncthreads();
  if (col < d) {
#pragma unroll
    for (int i = 0; i < kWT; ++i)
      if (q0 + i < tq) store(out + (bh * tq + q0 + i) * d + col, acc[i] / l_s[i]);
  }
}

template <typename T>
cudaError_t launch_wide(const T* q, const T* k, const T* v, T* out,
                        float* lse, int bh, int tq, int tk, int d,
                        float scale, int causal, cudaStream_t stream) {
  const int n_qtiles = (tq + kWT - 1) / kWT;
  const int n_chunks = (d + kWCols - 1) / kWCols;
  if (int64_t(bh) * n_qtiles * n_chunks > INT32_MAX)
    return cudaErrorInvalidValue;
  flash_fwd_wide_kernel<T><<<bh * n_qtiles * n_chunks, kThreads, 0,
                             stream>>>(q, k, v, out, lse, tq, tk, d,
                                       n_qtiles, n_chunks, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes: float32 with any d >= 1,
// and bfloat16 with d > 256 (narrower bf16 heads take the tensor-core
// kernels of flash_attention_fwd.cu).  They launch on `stream`, do not
// synchronise, allocate nothing, and return the launch's cudaError_t (0 on
// success).
extern "C" int flash_attention_fwd_wide_bf16(const void* q, const void* k,
                                             const void* v, void* out,
                                             void* lse, int bh, int tq,
                                             int tk, int d, int causal,
                                             float scale, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d <= 256)
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  return launch_wide<bf16>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), bh, tq, tk, d, scale, causal,
      static_cast<cudaStream_t>(stream));
}

// f32: heads up to 64 on the wgmma_tf32 design, whose split parts go to
// `work` (flash_attention_fwd_f32_work_floats floats, 16-byte aligned;
// unused by the other designs).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       void* work, int bh, int tq, int tk,
                                       int d, int causal, float scale,
                                       void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 1)
    return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= kTfMaxHeadDim)
    return launch_tf32(qf, kf, vf, of, lf, static_cast<float*>(work), bh, tq,
                       tk, d, scale, causal, s);
  if (d <= 128) return launch<128>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, causal, s);
  if (d <= 256) return launch<256>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, causal, s);
  return launch_wide<float>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, causal, s);
}

// The f32 workspace the forward needs at these sizes (0 but for the
// wgmma_tf32 design).
extern "C" long long flash_attention_fwd_f32_work_floats(int bh, int tk,
                                                        int d) {
  return d <= kTfMaxHeadDim ? tf32_work_floats(bh, tk, d) : 0;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
