// Warp-level tensor-core and async-copy helpers (PTX), shared by the
// package's kernels.  All of them exist on sm_80 and later; the package
// builds them for sm_90a.
//
// Fragment layouts of mma.sync.m16n8k16 with bf16 inputs (PTX ISA,
// "Matrix Fragments for mma.m16n8k16"), for lane = 4 * g + t:
//   A (16 x 16, row):  a0 = (row g,   cols 2t, 2t+1)   a1 = (row g+8, cols 2t, 2t+1)
//                      a2 = (row g,   cols 2t+8, +9)   a3 = (row g+8, cols 2t+8, +9)
//   B (16 x 8, col):   b0 = (rows 2t, 2t+1, col g)     b1 = (rows 2t+8, 2t+9, col g)
//   C (16 x 8, f32):   c0, c1 = (row g, cols 2t, 2t+1) c2, c3 = (row g+8, cols 2t, 2t+1)
// Each 32-bit register holds two bf16, the lower column (or row, for B) in
// the low half.  So the C fragments of two adjacent n8 tiles, packed pairwise
// to bf16, are exactly the A fragment of one k16 step: a0 = tile 0's (c0, c1),
// a1 = tile 0's (c2, c3), a2 = tile 1's (c0, c1), a3 = tile 1's (c2, c3).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace warp_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; when `valid` is false no
// byte is read and the 16 bytes in shared memory are zero-filled.  `src`
// must be 16-byte aligned and a valid address either way.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of every lane receives (row lane/4, cols 2(lane%4), +1) of
// matrix i (of its transpose with .trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores: bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (about 2 ulp; subnormal results flush to
// 0, so a -1e30 logit gives exactly 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 -> one register of two bf16 (round to nearest even), lo in the
// low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace warp_mma
