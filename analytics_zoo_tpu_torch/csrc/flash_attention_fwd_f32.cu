// Flash-attention forward for Hopper (sm_90a), float32, exact: scalar f32
// FMAs, no tensor cores (TF32 would keep about three decimal digits and
// break the float32 path's 2e-5 agreement with the plain version).
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
// Design.  One CUDA block owns one (bh, 64-row q tile) and loops over
// 64-key tiles (the TPU's sequential k grid axis); blocks are laid out on
// gridDim.x as bh * n_qtiles + q tile, so any BH fits.  The kernel is
// instantiated for head widths D = 16, 32, 64, 128, 256 and takes the true
// d <= D at run time: columns >= d are zero in shared memory (they add 0 to
// every dot product) and are never stored.
//   * the q tile is staged once in shared memory, transposed [D][64], so a
//     thread reads its 4 rows with one 16-byte load;
//   * each k/v tile is staged in shared memory as f32 (K transposed
//     [D][64+1] so that the 16 threads of a row group read 16 consecutive
//     keys);
//   * 256 threads form a 16 x 16 grid: thread (ty, tx) owns q rows
//     4*ty..4*ty+3, logits columns tx + 16*j of each key tile and output
//     columns tx + 16*j of D.  Row max and row sum reduce over the 16 tx
//     lanes of a half-warp with shuffles; m, l and the accumulator stay in
//     registers for the whole key loop;
//   * P goes through shared memory ([64 keys][64+4 rows]) for the P @ V
//     product;
//   * under `causal` the key loop stops at the tile holding the diagonal.
//
// What bounds it.  4 * BH * Tq * Tk * d FLOP against q, k, v read once and
// out written once: at BERT-base (T 512, d 64) about 128 FLOP per byte in
// f32, above the ridge of the f32 rate outside the tensor cores (67 TFLOP/s
// over 3.35 TB/s = 20), so it is bound by operations.  It runs at a fraction
// of that rate: loads are synchronous and every product goes through shared
// memory.  It serves only float32 models and the float32 reference runs.
//
// Head dims 257..1024 (f32, and bf16 inputs computed in f32 as the TPU kernel
// upcasts its blocks) take the wide kernel: 16-row q tiles and 16-key tiles,
// the head dim staged in chunks of 64 columns for S, and each block owning a
// chunk of 256 output columns (S is recomputed once per chunk); thread
// (a, b) of the 16 x 16 grid holds logit (row a, key b), the online softmax
// reduces over the 16 lanes of a half-warp, and thread t accumulates output
// column t of the chunk for all 16 rows, reading V from device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;            // q rows per CUDA block
constexpr int kBlockK = 64;            // keys per tile
constexpr int kThreads = 256;          // 16 x 16 thread grid
constexpr int kQStride = kBlockQ + 4;  // Qt / Pt row stride (16-byte aligned)
constexpr int kKStride = kBlockK + 1;  // Kt row stride (transposing writes)
constexpr float kNegInf = -1e30f;

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
    const float denom = fmaxf(l[i], 1e-30f);
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
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const int n_qtiles = (tq + kBlockQ - 1) / kBlockQ;
  if (int64_t(bh) * n_qtiles > INT32_MAX) return cudaErrorInvalidValue;
  flash_fwd_f32_kernel<D><<<bh * n_qtiles, kThreads, smem, stream>>>(
      q, k, v, out, lse, tq, tk, d, n_qtiles, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Wide head dims (257..1024)
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

  const float denom = fmaxf(l, 1e-30f);
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

// Plain C entry points, bound with ctypes: float32 with any 1 <= d <= 1024,
// and bfloat16 with 256 < d <= 1024 (narrower bf16 heads take the tensor-core
// kernel of flash_attention_fwd.cu).  They launch on `stream`, do not
// synchronise, allocate nothing, and return the launch's cudaError_t (0 on
// success).
extern "C" int flash_attention_fwd_wide_bf16(const void* q, const void* k,
                                             const void* v, void* out,
                                             void* lse, int bh, int tq,
                                             int tk, int d, int causal,
                                             float scale, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d <= 256 || d > 1024)
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  return launch_wide<bf16>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), bh, tq, tk, d, scale, causal,
      static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int bh, int tq, int tk, int d,
                                       int causal, float scale, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 1 || d > 1024)
    return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch<16>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, causal, s);
  if (d <= 32) return launch<32>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, causal, s);
  if (d <= 64) return launch<64>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, causal, s);
  if (d <= 128) return launch<128>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, causal, s);
  if (d <= 256) return launch<256>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, causal, s);
  return launch_wide<float>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, causal, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
