// What the flash-attention forward and backward share on the tensor cores
// in 3xTF32 (f32 heads up to 64): the split pass that writes each f32
// operand's big and small tf32 parts (hopper.cuh) in the layouts wgmma
// reads, and the geometry of the staged tiles of those parts.
//
// wgmma reads tf32 from shared memory only K-major, so an operand whose
// product runs over the head dim (Q, K, V, dO as the A or B of S = Q K^T,
// dP = dO V^T and their transposes) is split as it is, [2 bh][t][dp]
// (plane 2 b big, 2 b + 1 small, dp = round8(d), columns past d zero), and
// one whose product runs over T (the B of O += P V, dQ += dS K, dK += dS^T
// Q, dV += P^T dO) is split transposed, [2 bh][dp][round8(t)], T in the
// order hopper.cuh gives within each group of 8 (position j holds row 2 j
// for j < 4, row 2 (j - 4) + 1 otherwise) so that P and dS pass from their
// accumulators to register A fragments without a shuffle; zeros past t.
// Staged tiles are 32 f32 wide (one 128-byte swizzle atom, TMA boxes
// 32 wide): a tile of the head dim is two atoms.
// Included by one source each (an anonymous namespace).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTfHeld = 64;   // rows of a tile held for a whole block
constexpr int kTfRows = 32;   // rows of a streamed tile
constexpr int kTfSplitThreads = 256;
constexpr uint32_t kTfHeldAtom = kTfHeld * 128;   // 64 rows x 32 f32: 8 KB
constexpr uint32_t kTfHeldPart = 2 * kTfHeldAtom; // 64 rows x d 0-63
constexpr uint32_t kTfRowAtom = kTfRows * 128;    // 32 rows x 32 f32: 4 KB
constexpr uint32_t kTfRowPart = 2 * kTfRowAtom;   // 32 rows x d 0-63
constexpr uint32_t kTfColPart = kTfHeld * 128;    // d 0-63 x 32 columns

// One tensor of the split pass: src [bh][t][d] f32; nat, unless null,
// [2 bh][t][dp] its parts as they are; tr, unless null, [2 bh][dp][tp]
// the parts transposed (module comment).
struct SplitJob {
  const float* src;
  float *nat, *tr;
  int t, tp;
};
struct SplitJobs {
  SplitJob job[4];
};

// blockIdx.x: 32 rows of one head (bh = blockIdx.x / tiles), blockIdx.y
// the job.
__global__ void __launch_bounds__(kTfSplitThreads)
split_tf32_kernel(const __grid_constant__ SplitJobs jobs, int tiles, int d,
                  int dp) {
  __shared__ float tile[kTfRows][kTfHeld + 1];
  const SplitJob& J = jobs.job[blockIdx.y];
  const int64_t bh = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * kTfRows;
  if (t0 >= J.tp) return;
  for (int i = threadIdx.x; i < kTfRows * dp; i += kTfSplitThreads) {
    const int r = i / dp, c = i % dp;
    const bool in = t0 + r < J.t;
    const float x =
        in && c < d ? J.src[(bh * J.t + t0 + r) * d + c] : 0.f;
    tile[r][c] = x;
    if (in && J.nat != nullptr) {
      uint32_t big, small;
      hopper::tf32_split(x, big, small);
      J.nat[((2 * bh) * J.t + t0 + r) * dp + c] = __uint_as_float(big);
      J.nat[((2 * bh + 1) * J.t + t0 + r) * dp + c] = __uint_as_float(small);
    }
  }
  if (J.tr == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.x; i < dp * kTfRows; i += kTfSplitThreads) {
    const int c = i / kTfRows, j = i % kTfRows;
    if (t0 + j >= J.tp) continue;
    // position j holds row p of its group of 8
    const int p = (j & 7) < 4 ? 2 * (j & 7) : 2 * ((j & 7) - 4) + 1;
    uint32_t big, small;
    hopper::tf32_split(tile[(j & ~7) + p][c], big, small);
    J.tr[((2 * bh) * dp + c) * J.tp + t0 + j] = __uint_as_float(big);
    J.tr[((2 * bh + 1) * dp + c) * J.tp + t0 + j] = __uint_as_float(small);
  }
}

}  // namespace
