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
// published 1,979 TOP/s, against ~0.35 ms for the 1.2 GB of code rows it
// reads and its output bytes at 3.35 TB/s. Only wgmma reaches that rate.
//
// Design: wgmma.mma_async m64n128k32 s8 x s8 -> s32 with the TARGETS as M
// (A, from registers) and the GUIDES as N (B, from shared memory), K = 96
// in three k-steps. The TPU kernel's guides-by-targets order is not kept.
//  - B: each block stages its whole guide block once into shared memory
//    with cp.async (2048 x 96 B = 196,608 B of a block's 232,448 B), zero
//    rows up to the 128-row n-tile. Row r's 16-byte chunk c lies at chunk
//    c * rows + r (chunk-major): the no-swizzle K-major layout of
//    wgmma_s8.cuh, lbo = 16 * rows, sbo = 128. A zero row counts 0 < thr
//    and never hits. Every target meets every guide row in one pass.
//  - A is never in memory as a one-hot. In the k32 A fragment lane (g, t)
//    of warp w holds k-bytes 4t.. and 16+4t.. of targets 16w+g and
//    16w+g+8; with K interleaved (column 4i+b) each such 4-byte group is
//    the one-hot of one position, `c < 4 ? 1 << 8c : 0`. So per k-step s a
//    lane reads the code bytes of positions 8s+t and 8s+4+t of its two
//    targets (24 of the 32 code rows, straight from device memory through
//    L1, one m-tile ahead into registers) and shifts. PAD_CODE columns and
//    the ragged tail past n give zero words and can never hit. No TMA or
//    cp.async tile of codes: its 16-byte rows would need n % 16 == 0, and
//    the code bytes take 4% of the bound's time at the main path, where
//    these loads already leave the kernel at 94% of the bound.
//  - The max stays in registers. Each thread holds two targets x 32 guides
//    of an n-tile's accumulators and folds them with __vimax3_s32 (one
//    Hopper VIMNMX3 per two counts) into running maxima from 0; after the
//    last n-tile two __shfl_xor_sync take the max over the four lanes of a
//    target, and one byte per target is written (>= thr). There is no early
//    exit.
//  - The fold overlaps the tensor cores across warpgroups: each warpgroup
//    issues an n-tile's three wgmma, waits for them (wait_group 0) and
//    folds, and the block's four warpgroups take turns on the SM's tensor
//    cores. A second accumulator set per warpgroup, to issue n-tile j+1
//    before folding n-tile j, made ptxas serialize the wgmma (its C7514
//    report) and ran slower.
//  - A persistent grid of one block (four warpgroups, 512 threads) per SM;
//    warpgroups stride over 64-target m-tiles. Super rows (two 1s per
//    position) multiply exactly, since a target holds one base per
//    position.
//  - The n-tile step (issue_rs with its asm pin on the A words, fold_max,
//    target_max) lives in wgmma_s8.cuh, shared with X4 (stage1_variants.cu),
//    which has K1's form with K = 128.
// tests/test_torch_scan_kernel.py models the A words, the descriptor reads,
// the accumulator map and the fold in numpy.
//
// On an H100 80GB HBM3 at 700 W, chip_smoke.py times it at 10.5-10.7 ms at
// the main path's 2048 rows through stage1 (89-91% of the bound; 10.2-10.3
// ms, 93-94%, for the launcher alone), against 20.48 ms for the warp-level
// m16n8k32 design it replaced, in turns on the same card (PERF.md). 103
// registers a thread, no spills.

#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma_s8.cuh"

namespace {

using ff_wgmma::kAcc;

constexpr int kWgThreads = 128;              // one warpgroup
constexpr int kWarpGroups = 4;
constexpr int kThreads = kWarpGroups * kWgThreads;
constexpr int kMTile = 64;                   // targets per warpgroup m-tile
constexpr int kNTile = ff_wgmma::kN;         // guide rows per wgmma: 128
constexpr int kPositions = 24;               // K = 4 x 24 = 96
constexpr int kK = 4 * kPositions;
constexpr int kKSteps = kK / 32;
constexpr int kChunks = kK / 16;             // 16-byte chunks per guide row
constexpr int kCodesPerLane = 2 * kKSteps;   // positions per lane per target
constexpr int kMaxRows = 2048;
constexpr int kPadCode = 4;

// one position's one-hot as an A-fragment word: byte b = (code == b)
__device__ __forceinline__ uint32_t onehot4(int c) {
  return static_cast<unsigned>(c) < 4u ? 1u << (8 * c) : 0u;
}

// the code bytes lane (g, t) of warp w needs for the m-tile whose target
// 16w + g is col: c[v][q] = position t + 4q of target col + 8v; targets
// past n are padding. `lane_codes` is codes + t * n.
__device__ __forceinline__ void load_codes(int (&c)[2][kCodesPerLane],
                                           const int8_t* __restrict__ lane_codes,
                                           long long n, long long col) {
#pragma unroll
  for (int v = 0; v < 2; ++v) {
#pragma unroll
    for (int q = 0; q < kCodesPerLane; ++q) {
      c[v][q] = col + 8 * v < n
                    ? __ldg(lane_codes + static_cast<long long>(4 * q) * n + col + 8 * v)
                    : kPadCode;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
stage1_kernel(const int8_t* __restrict__ codes, long long n,
              const int8_t* __restrict__ guides, int g_rows, int thr,
              int8_t* __restrict__ out) {
  extern __shared__ __align__(16) int8_t s_guides[];  // [kChunks][rows][16]
  const uint32_t s_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(s_guides));
  const int rows = (g_rows + kNTile - 1) / kNTile * kNTile;
  for (int q = threadIdx.x; q < rows * kChunks; q += kThreads) {
    const int r = q / kChunks;
    const uint32_t off = ((q - r * kChunks) * rows + r) * 16;
    if (r < g_rows) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(s_base + off), "l"(guides + 16 * static_cast<long long>(q)));
    } else {
      *reinterpret_cast<uint4*>(s_guides + off) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  ff_wgmma::fence_proxy_async();
  __syncthreads();

  const int wl = threadIdx.x % kWgThreads;
  const int warp = wl >> 5;
  const int lane = wl & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  uint64_t desc[kKSteps];
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    desc[s] = ff_wgmma::smem_desc(s_base + 2 * s * rows * 16, 16 * rows, 128);
  }
  const int n_tiles = rows / kNTile;
  const int8_t* lane_codes = codes + static_cast<long long>(t) * n;

  const long long m_tiles = (n + kMTile - 1) / kMTile;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpGroups;
  long long mt = static_cast<long long>(blockIdx.x) * kWarpGroups + threadIdx.x / kWgThreads;
  const int row = 16 * warp + g;  // the thread's first target in an m-tile
  int c[2][kCodesPerLane];
  if (mt < m_tiles) load_codes(c, lane_codes, n, mt * kMTile + row);
  for (; mt < m_tiles; mt += stride) {
    // a[s][v + 2h] = the one-hot of position 8s + 4h + t of target row + 8v
    uint32_t a[kKSteps][4];
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[s][2 * h] = onehot4(c[0][2 * s + h]);
        a[s][2 * h + 1] = onehot4(c[1][2 * s + h]);
      }
    }
    if (mt + stride < m_tiles) load_codes(c, lane_codes, n, (mt + stride) * kMTile + row);

    int run[2][2] = {{0, 0}, {0, 0}};
    for (int j = 0; j < n_tiles; ++j) {
      int d[kAcc];  // k-step 0 overwrites, the others add
      ff_wgmma::issue_rs(d, a, desc, j);
      ff_wgmma::wait_group<0>();
      ff_wgmma::fold_max(run, d);
    }

    // lane t = 0 writes target row, t = 1 target row + 8
    const int top = ff_wgmma::target_max(run, t);
    const long long col = mt * kMTile + row + 8 * t;
    if (t < 2 && col < n) out[col] = top >= thr;
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
  const int smem = (g_rows + kNTile - 1) / kNTile * kNTile * kK;
  err = cudaFuncSetAttribute(stage1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stage1_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long need =
      ((n + kMTile - 1) / kMTile + kWarpGroups - 1) / kWarpGroups;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(need < resident ? need : resident);
  stage1_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), n, static_cast<const int8_t*>(guides),
      g_rows, thr, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
