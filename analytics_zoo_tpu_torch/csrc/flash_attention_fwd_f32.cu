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

#include <cuda_runtime.h>
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

}  // namespace

// Plain C entry point, bound with ctypes.  Takes any 1 <= d <= 256; launches
// on `stream`, does not synchronise, allocates nothing; returns the launch's
// cudaError_t (0 on success).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int bh, int tq, int tk, int d,
                                       int causal, float scale, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 1 || d > 256)
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
  return launch<256>(qf, kf, vf, of, lf, bh, tq, tk, d, scale, causal, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
