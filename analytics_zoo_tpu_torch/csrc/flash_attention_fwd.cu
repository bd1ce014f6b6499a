// Flash-attention forward for Hopper (sm_90a), f32 or bf16 in, f32 accumulate.
//
// Replaces analytics_zoo_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// TPU kernel launched by _flash_fwd_pallas).  Computes, for q, k, v laid out
// [BH, T, D] and contiguous:
//   out[bh, i] = softmax_j(scale * q_i . k_j, masked) @ v      (input dtype)
//   lse[bh, i] = m_i + log(max(l_i, 1e-30))                    (f32)
// with scale = 1/sqrt(D), key positions >= Tk masked, and under `causal`
// also q < k masked (absolute positions, so Tq != Tk works).  Masked logits
// are -1e30, not -inf, exactly as the JAX kernel does.
//
// Design.  On the TPU the k-blocks are the sequential third grid axis and the
// online-softmax state lives in VMEM scratch across grid steps.  Blocks on
// Hopper run in parallel and carry nothing between each other, so here one
// CUDA block owns one (bh, 64-row q tile) and loops over 64-key tiles itself:
//   * the q tile is staged once in shared memory, transposed [D][64], so a
//     thread reads its 4 rows with one 16-byte load;
//   * each k/v tile is staged in shared memory as f32 (K transposed [D][64+1]
//     so that the 16 threads of a row group read 16 consecutive keys);
//   * 256 threads form a 16 x 16 grid: thread (ty, tx) owns q rows
//     4*ty..4*ty+3, logits columns tx + 16*j of each key tile and output
//     columns tx + 16*j of D.  Row max and row sum reduce over the 16 tx
//     lanes of a half-warp with shuffles; m, l and the accumulator stay in
//     registers for the whole key loop;
//   * P goes through shared memory ([64 keys][64+4 rows]) for the P @ V
//     product;
//   * under `causal` the key loop stops at the tile holding the diagonal;
//     the ragged Tq/Tk edges are masked here, nothing is padded (the TPU's
//     D -> 128 and T -> multiple-of-8 padding were tile rules of that chip).
//
// What bounds it.  At BERT-base (BH = 12 * batch, T = 512, D = 64) the work
// is 4 * BH * T^2 * D FLOP against 4 * BH * T * D * bytes moved (q, k, v
// read once, out written once): about 256 FLOP per byte in bf16, just under
// the H100's ridge of about 295 (989 TFLOP/s bf16 over 3.35 TB/s), so a
// kernel at the tensor-core rate would be nearly balanced between the two.
// This first version leaves that rate on the table: both products are
// scalar f32 FMAs fed from shared memory (no mma.sync / wgmma), and loads
// are synchronous (no cp.async / TMA double buffering, no warp
// specialisation).  It is right first; the fast version is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;          // q rows per CUDA block
constexpr int kBlockK = 64;          // keys per tile
constexpr int kThreads = 256;        // 16 x 16 thread grid
constexpr int kQStride = kBlockQ + 4;  // Qt / Pt row stride (16-byte aligned)
constexpr int kKStride = kBlockK + 1;  // Kt row stride (transposing writes)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int tq, int tk, float scale,
                 int causal) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DJ = D / 16;  // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                    // [D][kQStride]
  float* Kt = Qt + D * kQStride;       // [D][kKStride]
  float* Vs = Kt + D * kKStride;       // [kBlockK][D]
  float* Pt = Vs + kBlockK * D;        // [kBlockK][kQStride]

  const int q0 = blockIdx.x * kBlockQ;
  const size_t bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const T* qb = q + bh * size_t(tq) * D;
  const T* kb = k + bh * size_t(tk) * D;
  const T* vb = v + bh * size_t(tk) * D;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    Qt[d * kQStride + r] =
        (q0 + r < tq) ? to_f32(qb[size_t(q0 + r) * D + d]) : 0.f;
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
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < tk;
      const size_t off = size_t(k0 + r) * D + d;
      Kt[d * kKStride + r] = in ? to_f32(kb[off]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(
          &Qt[d * kQStride + ty * 4]);
      const float* kr = &Kt[d * kKStride + tx];
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
    T* orow = out + (bh * size_t(tq) + r) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
    if (tx == 0) lse[bh * size_t(tq) + r] = m[i] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int tq, int tk, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), tq, tk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       void* lse, int bh, int tq, int tk, int d, float scale,
                       int causal, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, bh, tq, tk, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, bh, tq, tk, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, bh, tq, tk, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, bh, tq, tk, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int bh, int tq,
                                   int tk, int d, int dtype, int causal,
                                   float scale, void* stream) {
  if (bh < 1 || bh > 65535 || tq < 1 || tk < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, out, lse, bh, tq, tk, d, scale, causal, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, out, lse, bh, tq, tk, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
