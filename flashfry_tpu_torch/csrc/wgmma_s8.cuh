// Inline-PTX helpers of the int8 warpgroup tensor-core kernels (K1 in
// stage1.cu; X1-X6 in stage1_variants.cu): the shared-memory matrix
// descriptor, the fences, and wgmma.mma_async m64n128k32 s8 x s8 -> s32
// with A in shared memory (mma_s8) or in registers (mma_s8_rs), B in shared
// memory; and the n-tile step of the kernels with the targets as A from
// registers (K1 and X4): issue_rs, fold_max, target_max. sm_90a only.
//
// Layout the descriptor describes (no swizzle, K-major, which 8-bit
// operands must be): a core matrix is 8 rows x 16 bytes, its rows 16 bytes
// apart (128 contiguous bytes). A k-step of 32 bytes is two core matrices
// along K, `lbo` bytes apart; the 8-row groups along M (or N) are `sbo`
// bytes apart. The kernels keep an operand "chunk-major": byte k of row r
// at ((k / 16) * rows + r) * 16 + k % 16, so sbo = 128 and lbo = 16 * rows,
// and k-step s of the 64-row m-tile m starts at (2 * s * rows + 64 * m) * 16.
#pragma once

#include <cstdint>

namespace ff_wgmma {

constexpr int kN = 128;  // targets per wgmma (the n of m64nNk32)
constexpr int kAcc = kN / 2;  // s32 accumulators a thread holds

// 64-bit descriptor: start address, lbo and sbo in 16-byte units (bits
// 0-13, 16-29, 32-45), base offset 0, layout type 0 (no swizzle, bits 62-63)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFFu) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
}

// before the first wgmma, and after the accumulators were written by other
// instructions
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most kPending committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

// keeps the compiler from moving other instructions' reads and writes of the
// accumulators across the wgmma window (before fence(), after wait_group())
__device__ __forceinline__ void fence_operands(int (&d)[kAcc]) {
#pragma unroll
  for (int k = 0; k < kAcc; ++k) asm volatile("" : "+r"(d[k]) :: "memory");
}

// shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to the async proxy that wgmma reads through; then a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d = a * b (scale_d 0) or d += a * b (scale_d 1) over one k-step: a =
// 64 x 32 s8 (desc_a), b = 128 x 32 s8 (desc_b), both K-major in shared
// memory. Thread l of warp w of the
// warpgroup holds, with g = l / 4 and t = l % 4, for j = 0..15:
//   d[4j]   (row 16w + g,     column 8j + 2t)
//   d[4j+1] (row 16w + g,     column 8j + 2t + 1)
//   d[4j+2] (row 16w + g + 8, column 8j + 2t)
//   d[4j+3] (row 16w + g + 8, column 8j + 2t + 1)
__device__ __forceinline__ void mma_s8(int (&d)[kAcc], uint64_t desc_a, uint64_t desc_b,
                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// The same product with A in registers: a[0..3] are the thread's words of
// the 64 x 32 s8 A tile, four s8 each (byte b = column k + b); thread l of
// warp w of the warpgroup, g = l / 4, t = l % 4, holds
//   a[0] (row 16w + g,     k 4t..4t+3)
//   a[1] (row 16w + g + 8, k 4t..4t+3)
//   a[2] (row 16w + g,     k 16+4t..16+4t+3)
//   a[3] (row 16w + g + 8, k 16+4t..16+4t+3)
// (warp w's 16 rows of the tile); d as in mma_s8.
// a must not change until the wgmma's group has been waited for.
__device__ __forceinline__ void mma_s8_rs(int (&d)[kAcc], const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// The register-A kernels (K1, X4): kSteps k-steps of n-tile `tile` into d,
// committed as one group. desc[s] is k-step s's descriptor of n-tile 0; the
// start address counts 16-byte units, so n-tile j starts kN rows of 16
// bytes on. The empty asm on a keeps the A words' definitions before
// wgmma.fence: a register operand defined after it makes ptxas insert a
// warpgroup.arrive of its own and serialize the wgmma (its C7519/C7520
// reports).
template <int kSteps>
__device__ __forceinline__ void issue_rs(int (&d)[kAcc], uint32_t (&a)[kSteps][4],
                                         const uint64_t (&desc)[kSteps], int tile) {
  fence_operands(d);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[s][k]) :: "memory");
  }
  fence();
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    mma_s8_rs(d, a[s], desc[s] + static_cast<uint64_t>(tile * kN), s);
  }
  commit_group();
}

// run[v][h] = max(run[v][h], the counts of target row g + 8v in d), after
// the group was waited for: d[4j], d[4j+1] are row g, d[4j+2], d[4j+3]
// row g + 8 (mma_s8); two runners per row halve the dependent chain
__device__ __forceinline__ void fold_max(int (&run)[2][2], int (&d)[kAcc]) {
  fence_operands(d);
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    run[0][j & 1] = __vimax3_s32(run[0][j & 1], d[4 * j], d[4 * j + 1]);
    run[1][j & 1] = __vimax3_s32(run[1][j & 1], d[4 * j + 2], d[4 * j + 3]);
  }
}

// The max over the four lanes t of a target row (every lane calls it):
// lane t = 0 gets target row g's, t = 1 row g + 8's (the two it writes)
__device__ __forceinline__ int target_max(const int (&run)[2][2], int t) {
  int r0 = max(run[0][0], run[0][1]);
  int r1 = max(run[1][0], run[1][1]);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    r0 = max(r0, __shfl_xor_sync(0xFFFFFFFFu, r0, off));
    r1 = max(r1, __shfl_xor_sync(0xFFFFFFFFu, r1, off));
  }
  return t ? r1 : r0;
}

}  // namespace ff_wgmma
