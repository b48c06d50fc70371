// Stage 1 of the off-target scan on the int8 tensor cores: one "does any
// guide hit" byte per target.
//
// Replaces flashfry_tpu/ops/scan_kernel.py::stage1_pallas (body
// _stage1_kernel). Same function, bit for bit:
//   codes  (32, n)  int8, plane-major: row i holds base i (0..3) of every
//                   target; padding columns hold PAD_CODE = 4 in every row
//   guides (g_rows, 96) int8: the (G, 128) block-layout 0/1 one-hot (column
//                   b*32+i = base b at active position i) compacted by
//                   ops/scan_kernel.py::compact_guides: column 4i+b = block
//                   column b*32+i for i < 24 (every enzyme has L <= 24, so
//                   block columns i >= 24 are zero and add nothing), rows
//                   zero-padded to g_rows, a multiple of 16, <= 2048
//   out    (n,)     int8: 1 iff max_g <onehot(g), onehot(t)> >= thr, thr >= 1
// The (G, n) counts never reach device memory, as on the TPU.
//
// What bounds it on Hopper: int8 operations. The product is 2 x 96 x G x n
// operations as done here (2 x 128 x G x n as the TPU kernel counts them):
// 1.88e13 at the main path's (32, 47.8M) x 2048 rows, 9.5 ms at the H100's
// published 1,979 TOP/s, against ~0.5 ms for the 1.6 GB of codes and
// output bytes at 3.35 TB/s.
//
// Design. mma.sync.m16n8k32 (s8 x s8 -> s32) with the guides as A (16 rows
// per m-tile) and the targets as B (8 per n-tile), K = 96 in three k-steps.
//  - A: each block stages its whole guide block once into shared memory
//    with cp.async (2048 x 96 B = 196,608 B; the 128-column layout, 262,144
//    B, would not fit a block's 232,448 B). Row r's 16-byte chunk c is
//    stored at chunk c * g_rows + r (chunk-major), so the eight rows one
//    ldmatrix phase reads are 128 contiguous bytes: no bank conflicts, and
//    no swizzle is needed. A fragments are loaded with ldmatrix.x4.
//  - B is never in memory as a one-hot. In the m16n8k32 B fragment lane l
//    holds k-rows 4(l%4)+{0..3} and 16+4(l%4)+{0..3} of target column l/4;
//    with K interleaved (column 4i+b), each such 4-byte group is the one-hot
//    of one position, `c < 4 ? 1 << 8c : 0`. So per k-step s a lane reads
//    the code bytes of positions 8s+l%4 and 8s+4+l%4 of its target and
//    shifts; PAD_CODE columns and the ragged tail past n give zero
//    fragments and can never hit. The code bytes come straight from device
//    memory (read once through L1, 24 of 32 rows) into registers, not
//    through a double-buffered shared-memory tile: each warp owns 64
//    targets (8 n-tiles) at a time, and while one warp waits for its bytes
//    the other three of its SM sub-partition multiply, so warps never wait
//    on each other after the staging barrier and the ragged width needs no
//    alignment.
//  - The max stays in registers and is never formed as a max. C starts at
//    -thr, so a count reaches thr iff its sum is >= 0; each lane ANDs the
//    sums of its two targets across rows g, g+8 of every m-tile (one
//    3-input LOP3 per target per m-tile). The AND's sign bit is set iff no
//    guide reached thr: zero padding rows (sum -thr < 0) change nothing.
//    After the last m-tile three __shfl_xor_sync fold the 8 lane groups,
//    and each target's byte is written once, 64 contiguous bytes per warp.
//    There is no early exit.
//  - One persistent block of 16 warps per SM (126 registers, no spills);
//    warps stride over 64-target tiles. Super rows (two 1s per position)
//    multiply exactly, since a target holds one base per position.
//
// On an H100 80GB HBM3 at 700 W, chip_smoke.py times it at 20.6 ms at the
// main path's 2048 rows (PERF.md): 9.1e14 of the 96-column operations per
// second, about half the published int8 peak, which is what one m16n8k32
// per 8 clocks per SM sub-partition would give. The rest of the peak needs
// wgmma. Each warp holds exactly 8 n-tiles: lane group g writes n-tile g.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace {

using ff_mma::ldmatrix_x4;
using ff_mma::mma_s8;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNTiles = 8;                   // n-tiles of 8 targets per warp
static_assert(kNTiles == 8, "lane group g writes n-tile g");
constexpr int kWarpTargets = 8 * kNTiles;
constexpr int kPositions = 24;               // K = 4 x 24 = 96
constexpr int kK = 4 * kPositions;
constexpr int kKSteps = kK / 32;
constexpr int kChunks = kK / 16;             // 16-byte chunks per guide row
constexpr int kCodesPerLane = 2 * kKSteps;   // positions per lane per target
constexpr int kMaxRows = 2048;
constexpr int kPadCode = 4;

// one position's one-hot as a B-fragment word: byte b = (code == b)
__device__ __forceinline__ uint32_t onehot4(int c) {
  return static_cast<unsigned>(c) < 4u ? 1u << (8 * c) : 0u;
}

// lane (g, t)'s B fragments for the warp tile at t0: b[j][2s + h] is the
// one-hot of position 8s + 4h + t of target t0 + 8j + g (k-step s,
// fragment register h); targets past n are padding
__device__ __forceinline__ void load_fragments(uint32_t (&b)[kNTiles][kCodesPerLane],
                                               const int8_t* __restrict__ codes,
                                               long long n, long long t0, int g,
                                               int t) {
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const long long col = t0 + 8 * j + g;
#pragma unroll
    for (int q = 0; q < kCodesPerLane; ++q) {
      b[j][q] = onehot4(col < n ? __ldg(codes + static_cast<long long>(t + 4 * q) * n + col)
                                : kPadCode);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
stage1_kernel(const int8_t* __restrict__ codes, long long n,
              const int8_t* __restrict__ guides, int g_rows, int thr,
              int8_t* __restrict__ out) {
  extern __shared__ __align__(16) int8_t s_guides[];  // [kChunks][g_rows][16]
  const uint32_t s_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(s_guides));
  for (int q = threadIdx.x; q < g_rows * kChunks; q += kThreads) {
    const int r = q / kChunks;
    const uint32_t dst = s_base + ((q - r * kChunks) * g_rows + r) * 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(guides + 16 * static_cast<long long>(q)));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // ldmatrix.x4: lanes 8i..8i+7 address matrix i = rows 8(i&1)+{0..7},
  // k-bytes 16(i>>1)..+15 of the k-step; the four registers are the A
  // fragment {row g, row g+8} x {k 4t.., k 16+4t..}
  uint32_t a_addr[kKSteps];
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    a_addr[s] = s_base + ((2 * s + (lane >> 4)) * g_rows + (lane & 15)) * 16;
  }
  const int m_tiles = g_rows / 16;

  const long long n_tiles = (n + kWarpTargets - 1) / kWarpTargets;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long wt = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  for (; wt < n_tiles; wt += stride) {
    uint32_t b[kNTiles][kCodesPerLane];
    load_fragments(b, codes, n, wt * kWarpTargets, g, t);

    uint32_t run[kNTiles][2];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) run[j][0] = run[j][1] = 0xFFFFFFFFu;
#pragma unroll 2
    for (int m = 0; m < m_tiles; ++m) {
      uint32_t a[kKSteps][4];
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) ldmatrix_x4(a[s], a_addr[s] + m * 256);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        int d[4];
        mma_s8(d, a[0], b[j][0], b[j][1], -thr);
#pragma unroll
        for (int s = 1; s < kKSteps; ++s) mma_s8(d, a[s], b[j][2 * s], b[j][2 * s + 1]);
        // d0, d2: target 2t (rows g, g+8); d1, d3: target 2t+1
        run[j][0] &= static_cast<uint32_t>(d[0]) & static_cast<uint32_t>(d[2]);
        run[j][1] &= static_cast<uint32_t>(d[1]) & static_cast<uint32_t>(d[3]);
      }
    }

    // fold the 8 lane groups (guide rows g = lane / 4); lane (g, t) then
    // writes targets 2t, 2t+1 of n-tile g
    uint32_t r0 = 0, r1 = 0;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        run[j][0] &= __shfl_xor_sync(0xFFFFFFFFu, run[j][0], off);
        run[j][1] &= __shfl_xor_sync(0xFFFFFFFFu, run[j][1], off);
      }
      if (j == g) {
        r0 = run[j][0];
        r1 = run[j][1];
      }
    }
    const long long col = wt * kWarpTargets + 8 * g + 2 * t;
    if (col < n) out[col] = static_cast<int>(r0) >= 0;
    if (col + 1 < n) out[col + 1] = static_cast<int>(r1) >= 0;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// codes: (32, n) int8; guides: (g_rows, 96) int8 compacted, 16-byte
// aligned, g_rows a multiple of 16 in [16, 2048]; thr >= 1; out: (n,) int8.
// The caller checks shapes, types and alignment; a g_rows or thr outside
// those ranges returns cudaErrorInvalidValue and launches nothing.
extern "C" int ff_stage1_launch(const void* codes, long long n,
                                const void* guides, int g_rows, int thr,
                                void* out, void* stream) {
  if (g_rows < 16 || g_rows > kMaxRows || g_rows % 16 != 0 || thr < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = g_rows * kK;
  err = cudaFuncSetAttribute(stage1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stage1_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long need =
      ((n + kWarpTargets - 1) / kWarpTargets + kWarps - 1) / kWarps;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(need < resident ? need : resident);
  stage1_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), n, static_cast<const int8_t*>(guides),
      g_rows, thr, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
