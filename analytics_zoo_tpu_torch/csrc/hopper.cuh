// Hopper (sm_90a) primitives shared by the package's kernels: warpgroup
// matrix products (wgmma) on bf16, and on tf32 in three passes for f32
// operands, with f32 accumulators, their shared-memory
// descriptors for the 128-byte swizzle, and TMA tile loads completed on
// mbarriers, and the host's encoding of the tensor maps those loads read
// and raising of a kernel's shared memory limit.
// wgmma exists only for sm_90a; the package builds for it.
//
// Layouts (PTX ISA, "Asynchronous Warpgroup Level Matrix Multiply"):
//   * the f32 accumulator of m64nNk16, for thread 128-lane-id = 32 w + 4 g + t
//     (warp w of the warpgroup): d[4 i + e] is (row 16 w + g + 8 (e >> 1),
//     column 8 i + 2 t + (e & 1)), i.e. mma.sync's m16n8 C fragment per warp
//     and n8 chunk i;
//   * A from registers (m64k16 bf16, four 32-bit registers): a0 = (row g,
//     k 2t, 2t+1), a1 = (row g+8, k 2t, 2t+1), a2 = (row g, k 2t+8, +9),
//     a3 = (row g+8, k 2t+8, +9), rows offset by 16 w.  So the accumulators
//     of n8 chunks 2 kk and 2 kk + 1, packed pairwise to bf16, are the A
//     fragment of k16 step kk of the next product (rows stay, columns become
//     the depth), as FlashAttention-3 chains its products;
//   * shared-memory tiles are 64 bf16 wide (one 128-byte row, one swizzle
//     atom) and stored as TMA's CU_TENSOR_MAP_SWIZZLE_128B leaves them: the
//     16-byte chunk c of row r at chunk c ^ (r % 8), 8-row groups 1024 bytes
//     apart; a tile's base is 1024-byte aligned.
//   * K-major operand (A [M][K] or B [N][K] with K contiguous): the
//     descriptor's stride byte offset is 1024 (one 8-row group), its leading
//     byte offset unused (1); k16 step kk starts 32 kk bytes into the row.
//   * MN-major operand (A [K][M] or B [K][N] with M or N contiguous, the
//     transpose bit set): a swizzle atom spans 64 of M or N; the stride
//     byte offset is the stride between 8-row groups of K (1024 in a tile
//     of 128-byte rows), the leading byte offset the stride between atoms
//     along M or N (unused at 64); k16 step kk starts 16 kk rows (2048 kk
//     bytes) down.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>

#include "warp_mma.cuh"

namespace hopper {

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled shared tile starting at byte address
// `addr` (offsets in bytes: `lbo` leading, `sbo` stride).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// K-major operand: k16 step kk of a tile at `addr`.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr, int kk) {
  return desc_sw128(addr + 32 * kk, 16, 1024);
}

// MN-major B, 64 wide: k16 step kk (rows 16 kk .. 16 kk + 15) of a tile at
// `addr`.  The leading offset is unused at N = 64; it is given the group
// stride too.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, int kk) {
  return desc_sw128(addr + 2048 * kk, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of the warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for several accumulators of one shape (one a swizzle atom of a
// product's N).
template <int A, int N>
__device__ __forceinline__ void fence_regs(float (&d)[A][N]) {
#pragma unroll
  for (int a = 0; a < A; ++a) fence_regs(d[a]);
}

// The same for the register A fragments of wgmma_rs (k16 steps x four
// registers), which the products read asynchronously: fenced before
// wgmma_fence and after wgmma_wait, they stay live and unchanged until the
// products are done, so the compiler neither moves a write to them across
// the products nor hands their registers to other values meanwhile.
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(a[kk][x])::"memory");
}

#define HOPPER_D16(c)                                                        \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),    \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),    \
      c(d[15])
#define HOPPER_D16_REGS                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HOPPER_D32(c)                                                        \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),    \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),    \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),  \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),  \
      c(d[29]), c(d[30]), c(d[31])
#define HOPPER_D32_REGS                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define HOPPER_D64(c)                                                        \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),    \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),    \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),  \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),  \
      c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]), c(d[34]), c(d[35]),  \
      c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]),  \
      c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),  \
      c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]),  \
      c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define HOPPER_D64_REGS                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d = A B (kAccumulate false) or d += A B, m64n64k16, bf16 in, f32
// accumulate; A and B in shared memory, K-major, or MN-major where kTransA
// (kTransB) sets the transpose bit.  Without kAccumulate d is only written
// (scale-d 0), so the compiler never materialises its old values: an
// ordinary write to an accumulator while products are in flight makes
// ptxas serialise them.
template <bool kAccumulate, bool kTransA = false, bool kTransB = false>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        HOPPER_D32_REGS ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : HOPPER_D32("+f")
        : "l"(a), "l"(b), "r"(1), "n"(int(kTransA)), "n"(int(kTransB)));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        HOPPER_D32_REGS ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : HOPPER_D32("=f")
        : "l"(a), "l"(b), "r"(0), "n"(int(kTransA)), "n"(int(kTransB)));
  }
}

// d += A B, m64n128k16, bf16 in, f32 accumulate (d[4 i + e] as above, i
// up to 15); A and B in shared memory, K-major or MN-major as in wgmma_ss.
// An MN-major B spans two swizzle atoms of N: its descriptor's leading
// byte offset is the stride between them.
template <bool kTransA, bool kTransB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      HOPPER_D64_REGS ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : HOPPER_D64("+f")
      : "l"(a), "l"(b), "r"(1), "n"(int(kTransA)), "n"(int(kTransB)));
}

// d += A B, m64n64k16: A (bf16, the fragment above) from registers, B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      HOPPER_D32_REGS ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D32("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// wgmma on tf32 (f32 operands at three products per f32 product)
// ---------------------------------------------------------------------------
//
// tf32 operands are 32-bit f32 words of which the tensor cores use 19 bits
// (sign, exponent, 10 mantissa bits).  3xTF32 keeps about f32's accuracy:
// x = big + small with big = tf32(x) (cvt.rna: to nearest, ties away) and
// small = tf32(x - big), and a b ~ big_a small_b + small_a big_b + big_a
// big_b, accumulated in f32.  wgmma reads tf32 from shared memory only
// K-major (the transpose bits exist for 16-bit types alone), so every
// staged operand has K contiguous:
//   * a tile's rows are K-major f32 rows cut into 128-byte swizzle atoms of
//     32 values (the TMA box is 32 wide); a tile of K 64 is two atoms,
//     `atom` bytes apart (rows x 128), and k8 step kk starts 32 (kk % 4)
//     bytes into atom kk / 4; the stride byte offset is 1024 (8 rows);
//   * A from registers (m64k8, four 32-bit registers, rows offset by 16
//     w): a0 = (row g, k t), a1 = (row g + 8, k t), a2 = (row g, k t + 4),
//     a3 = (row g + 8, k t + 4).  An m64nN f32 accumulator holds, in n8
//     chunk i, (row g, columns 2t, 2t + 1) and (row g + 8, the same), so
//     chunk i becomes k8 step i of the next product as a0 = d[4i], a1 =
//     d[4i + 2], a2 = d[4i + 1], a3 = d[4i + 3]: depth slot t is column 2t
//     and slot t + 4 column 2t + 1.  The B operand of such a product keeps
//     its K in that order within each group of 8: depth j at position j / 2
//     when j is even, 4 + j / 2 when odd.

// The tf32 parts of x: big (rounded to nearest, ties away) and small.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

// K-major f32 operand: k8 step kk of a tile at `addr` whose 32-wide atoms
// lie `atom` bytes apart.
__device__ __forceinline__ uint64_t desc_tf32(uint32_t addr, int kk,
                                              uint32_t atom) {
  return desc_sw128(addr + (kk >> 2) * atom + (kk & 3) * 32, 16, 1024);
}

// d (+)= A B, m64nNk8 (N 32 or 64: 16 or 32 accumulators), tf32 in, f32
// accumulate, A and B K-major in shared memory.  Without kAccumulate d is
// only written (scale-d 0), as in wgmma_ss.
template <bool kAccumulate, int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a,
                                              uint64_t b) {
  constexpr int kScale = kAccumulate ? 1 : 0;
  if constexpr (N == 32) {
    if constexpr (kAccumulate) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
          HOPPER_D16_REGS ", %16, %17, p, 1, 1;\n}\n"
          : HOPPER_D16("+f") : "l"(a), "l"(b), "r"(kScale));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
          HOPPER_D16_REGS ", %16, %17, p, 1, 1;\n}\n"
          : HOPPER_D16("=f") : "l"(a), "l"(b), "r"(kScale));
    }
  } else {
    static_assert(N == 64, "m64n32 or m64n64");
    if constexpr (kAccumulate) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
          HOPPER_D32_REGS ", %32, %33, p, 1, 1;\n}\n"
          : HOPPER_D32("+f") : "l"(a), "l"(b), "r"(kScale));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
          HOPPER_D32_REGS ", %32, %33, p, 1, 1;\n}\n"
          : HOPPER_D32("=f") : "l"(a), "l"(b), "r"(kScale));
    }
  }
}

// d (+)= A B, m64nNk8 (N 32, 64 or 128), tf32: A (four registers, the
// fragment above) from registers, B K-major in shared memory; without
// kAccumulate (N 32 or 128) d is only written, as in wgmma_ss.
template <int N, bool kAccumulate = true>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  if constexpr (N == 32) {
    if constexpr (kAccumulate) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
          HOPPER_D16_REGS ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
          : HOPPER_D16("+f")
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
          HOPPER_D16_REGS ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
          : HOPPER_D16("=f")
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
    }
  } else if constexpr (N == 64) {
    static_assert(kAccumulate, "m64n64: accumulate only");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        HOPPER_D32_REGS ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : HOPPER_D32("+f")
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (kAccumulate) {
    static_assert(N == 128, "m64n64 or m64n128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        HOPPER_D64_REGS ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : HOPPER_D64("+f")
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    static_assert(N == 128, "m64n64 or m64n128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        HOPPER_D64_REGS ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : HOPPER_D64("=f")
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
}

// The 3xTF32 product of one k8 step from register A parts (big, small)
// and B parts in shared memory: the two small terms, then the big one;
// without kAccumulate the first one overwrites d.
template <int N, bool kAccumulate = true>
__device__ __forceinline__ void wgmma_tf32x3_rs(float (&d)[N / 2],
                                                const uint32_t (&a_big)[4],
                                                const uint32_t (&a_small)[4],
                                                uint64_t b_big,
                                                uint64_t b_small) {
  wgmma_tf32_rs<N, kAccumulate>(d, a_small, b_big);
  wgmma_tf32_rs<N>(d, a_big, b_small);
  wgmma_tf32_rs<N>(d, a_big, b_big);
}

// Register A fragments (k8 steps x four registers) read asynchronously by
// wgmma_tf32_rs: fenced as fence_regs does for the bf16 ones.
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(a[kk][x])::"memory");
}

// Byte offset of bf16 element (row, col) of a 64-wide tile in the 128-byte
// swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

#undef HOPPER_D64_REGS
#undef HOPPER_D64
#undef HOPPER_D32_REGS
#undef HOPPER_D32
#undef HOPPER_D16_REGS
#undef HOPPER_D16

// ---------------------------------------------------------------------------
// mbarrier and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   warp_mma::smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The calling thread's arrival, announcing `bytes` of TMA traffic.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          warp_mma::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that lasts
// seconds means a fault (bytes that never arrive); it traps, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = warp_mma::smem_addr(bar);
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 33)) {
      __trap();
    }
  }
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory at `dst`, completing on `bar`.  Elements out of the tensor's
// bounds arrive as zeros and count toward the barrier's bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :
      : "r"(warp_mma::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(warp_mma::smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// tensor maps (host)
// ---------------------------------------------------------------------------

// Rows and columns of a TMA box: one 128-byte swizzle atom of bf16 wide.
constexpr int kTileRows = 64;

// cuTensorMapEncodeTiled, taken from the driver through the runtime (no
// link against libcuda); null if the driver has none.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Makes the current device's primary context current in the calling
// thread, once a thread.  cuTensorMapEncodeTiled checks the tensor's
// address against the thread's current context, and a thread whose first
// CUDA call is an encoding has none (autograd's backward thread, when the
// allocations before it all came from PyTorch's cache): the encoding then
// failed with an invalid value (H100, CUDA 12.8).
inline cudaError_t bind_context() {
  thread_local bool bound = false;
  if (bound) return cudaSuccess;
  const cudaError_t err = cudaFree(nullptr);
  bound = err == cudaSuccess;
  return err;
}

// A 3-D map over a contiguous bf16 [bh, t, d] tensor, boxes of 1 x 64 x
// 64 with the 128-byte swizzle: rows >= t and columns >= d of a box read
// zeros, never the next head.  d must be a multiple of 8 (16-byte rows).
inline cudaError_t tile_map(CUtensorMap* map, const void* ptr, int bh, int t,
                            int d) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cudaError_t err = bind_context();
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(t), cuuint64_t(bh)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * sizeof(__nv_bfloat16),
                                 cuuint64_t(t) * d * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {64, kTileRows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 3-D map over a contiguous f32 [planes, rows, cols] tensor, boxes of 1
// x box_rows x 32 (one 128-byte swizzle atom) with the 128-byte swizzle:
// rows >= rows and columns >= cols of a box read zeros.  cols must be a
// multiple of 4 (16-byte rows).
inline cudaError_t tile_map_f32(CUtensorMap* map, const void* ptr,
                                int planes, int rows, int cols,
                                int box_rows) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cudaError_t err = bind_context();
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(planes)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * sizeof(float),
                                 cuuint64_t(rows) * cols * sizeof(float)};
  const cuuint32_t box[3] = {32, cuuint32_t(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A kernel's dynamic shared memory limit, raised once a device (the
// attribute belongs to the kernel in one device's context); a launcher
// keeps one for each kernel it launches.
class SmemLimit {
 public:
  template <typename Kernel>
  cudaError_t raise(Kernel kernel, int dev, size_t bytes) {
    const std::lock_guard<std::mutex> lock(mu_);
    if (done_.count(dev)) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err == cudaSuccess) done_.insert(dev);
    return err;
  }

 private:
  std::mutex mu_;
  std::set<int> done_;
};

}  // namespace hopper
