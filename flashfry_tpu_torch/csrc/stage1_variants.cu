// The stage-1 variants of the experiment tool, one hit byte per target.
//
// Replaces six Pallas kernels of tools/experiment_stage1.py. Each launcher
// takes the inputs of its TPU kernel and writes the same (1, n) int8 output,
// bit for bit:
//   X1 make_v1_gloop         ff_v1_gloop_launch          interleaved guides
//                            staged through shared memory one 128-row tile
//                            at a time, running max from -1, then >= thr;
//                            rows past the last whole tile are never read
//                            (the TPU kernel's range(g_rows // g_tile)), so
//                            with fewer than 128 rows every byte is -1 >= thr
//   X2 make_v3_int16         ff_v3_int16_launch          interleaved guides,
//                            16-bit max of the match counts, then >= int16(thr)
//   X3 make_v4_concat_onehot ff_v4_concat_onehot_launch  block-layout guides,
//                            32-bit max, then >= thr
//   X4 make_v6_bf16out       ff_v6_bf16out_launch        block-layout guides,
//                            the bf16 max of the counts >= bf16(thr), on the
//                            int8 tensor cores
//   X5 make_v5_tile          ff_v5_tile_launch           X3's epilogue on
//                            interleaved guides, one block per t_tile targets
//   X6 make_expanded         ff_expanded_launch          a pre-expanded
//                            (128, n) one-hot in place of the codes; mode
//                            full = hit byte, dot = guide 0's match count,
//                            copy = one-hot row 0
// with
//   codes  (32, n)  int8 plane-major base codes; padding columns hold
//                   PAD_CODE = 4 in every row, rows >= L hold 0
//   onehot (128, n) int8, row 4i+b = (code_i == b); only 0/1 bytes with at
//                   most one 1 in each group of four rows (what the wrapper's
//                   expand_onehot builds); not checked here
//   guides (G, 128) int8 0/1 one-hot: interleaved (column 4i+b = base b at
//                   position i) or block layout (column 32b+i)
//
// What bounds them on Hopper: the 2 x 128 x G x n int8 operations of the
// one-hot product (1.11 ms at the tool's 2^23 targets x 1024 guides at the
// published 1,979 TOP/s); the bytes (33 per target from codes, 129 from the
// one-hot) are a small share. X1-X3, X5 and X6 run the product on the CUDA
// cores, as an integer-issue loop of one popcount per target-guide pair; X4
// runs it on the int8 tensor cores.
//
// Design of X1-X3, X5, X6 (CUDA cores): each thread owns a target column
// and keeps its one-hot as four 32-bit masks (bit i of m_b: base i == b);
// each guide is packed into four words in shared memory. A target has at
// most one base per position, so the four AND-ed masks are disjoint and one
// popcount of their OR is the int8 product of the TPU kernel. The variants differ only where their TPU kernels differed: the
// guide layout the packing reads, the epilogue (a max over all G, then the
// threshold; no early exit), the grid, and X6's input. X1 re-packs each
// 128-row guide tile into shared memory for every pass over the block's
// targets, as the TPU kernel sliced its guide block per tile; each thread
// holds four targets, so a packed tile serves 1024 of them.
//
// Design of X4 (bf16out_kernel): stage1.cu's tensor-core design, with
// mma.sync m16n8k32 s8 (guides as A, 16 rows per m-tile; targets as B, 8
// per n-tile; 8 n-tiles per warp), a persistent grid of one 12-warp block
// per SM, and the guides staged with cp.async into shared memory,
// chunk-major for ldmatrix.x4. Where X4's function differs from K1's:
//  - K = 128, not compacted: k-step b is the block-layout columns 32b..32b+31,
//    base b at positions 0..31. X4 takes any 0/1 block-layout guide, and
//    code rows >= L hold 0 (base A), so a 1 in columns 24..31 counts.
//  - B from 8 code bytes per lane per target: in the m16n8k32 B fragment
//    lane l holds k-rows 4(l%4)+{0..3} and 16+4(l%4)+{0..3} of target l/4,
//    the same 8 positions in every k-step. Each lane reads them once per
//    warp tile, packs them into two words w, and builds step b's fragment
//    as __vcmpeq4(w, b * 0x01010101) & 0x01010101: PAD_CODE, any code
//    outside 0..3 and the ragged tail past n give zero bytes.
//  - Up to 2048 guide rows (262,144 B) do not fit a block's 232,448 B of
//    shared memory, so the block stages at most 1024 rows (131,072 B) at a
//    time, zero-padded to a multiple of 16, and runs the warp tiles once per
//    stage. A warp tile maps to the same lanes in every stage, so the lane
//    that wrote a byte ORs the next stage's hit into it; "max >= thr" is
//    "any >= thr", so the OR is exact.
//  - The epilogue: the counts are at most 32, exact in bf16, and bf16
//    rounding keeps order, so the TPU's byte, max_g bf16(count_g) >=
//    bf16(thr), is any_g(count_g >= thr) for every int32 thr. X4 takes
//    stage1.cu's integer form of it: C starts at -max(thr, 0) (counts are
//    >= 0, so any thr <= 0 acts as 0, and the negation cannot overflow), and
//    each lane ANDs the sums' sign bits, one 3-input LOP3 per target per
//    m-tile; zero padding rows then hit only when every row hits. The
//    TPU's form, a bf16 max two values per lane (__hmax2), would need four
//    int-to-float conversions per 4-step mma chain, where conversions issue
//    at a quarter of the integer rate on compute capability 9.0: as many
//    cycles as the four m16n8k32 themselves (one per 8 clocks per SM
//    sub-partition), against two LOP3 for the integer form.
// On an H100 80GB HBM3 at 700 W, chip_smoke.py times X4 at 2.6 ms at the
// tool's 1024 rows and 1.5 ms on its 512 super rows (PERF.md): 42% and 37%
// of the bound, with 166 registers a thread and no spills.
//
// X6's dot and copy modes exist to be timed, so the work whose result they
// do not write (the counts of guides 1.., the loads of rows 1..) is folded
// into one value per target, and the byte written is XOR-ed with that fold
// AND-ed with `zero`, an argument the launcher passes as 0. The device code
// cannot know it is 0, so nothing is deleted; the fold costs one integer op
// per count or load. Two lighter ways did not hold on the card: an empty
// asm volatile taking each value vanishes from the PTX, and ptxas then
// drops the loads and popcounts; a store of the fold behind a null pointer
// test let the compiler move copy's loads behind the test.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace {

using ff_mma::ldmatrix_x4;
using ff_mma::mma_s8;

constexpr int kThreads = 256;
constexpr int kCodeRows = 32;
constexpr int kOneHotRows = 128;
constexpr int kGuideTile = 128;   // X1: the TPU kernel's g_tile
constexpr int kGloopTargets = 4;  // X1: targets per thread
// X4 on the tensor cores
constexpr int kMmaThreads = 384;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kNTiles = 8;        // n-tiles of 8 targets per warp
static_assert(kNTiles == 8, "lane group g writes n-tile g");
constexpr int kWarpTargets = 8 * kNTiles;
constexpr int kKSteps = kOneHotRows / 32;    // k-step b: base b at positions 0..31
constexpr int kRowChunks = kOneHotRows / 16;  // 16-byte chunks per guide row
constexpr int kMTile = 16;        // guide rows per m-tile
constexpr int kStageRows = 1024;  // guide rows staged at a time: 131,072 B
constexpr int kPadCode = 4;

enum Layout { kInterleaved = 0, kBlock = 1 };
enum Mode { kFull = 0, kDot = 1, kCopy = 2 };

// Pack the (g_rows, 128) 0/1 guide bytes into s_guide as g_rows x {word b =
// 0..3}, bit i of word b being the guide's byte for base b at position i.
template <int kLayout>
__device__ void pack_guides(const int8_t* __restrict__ guides, int g_rows,
                            uint4* s_guide) {
  if (kLayout == kBlock) {
    // word k covers columns [32k, 32k+32): guide k/4, base k%4 (stage1.cu)
    uint32_t* s_words = reinterpret_cast<uint32_t*>(s_guide);
    for (int k = threadIdx.x; k < g_rows * 4; k += blockDim.x) {
      const uint4* src = reinterpret_cast<const uint4*>(guides) + 2 * k;
      const uint4 a = src[0];
      const uint4 b = src[1];
      const uint32_t lanes[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      uint32_t w = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w |= ((lanes[j] >> (8 * q)) & 0xFFu) ? (1u << (4 * j + q)) : 0u;
        }
      }
      s_words[k] = w;
    }
  } else {
    // 32-bit lane i of a row holds columns 4i..4i+3: its byte b is base b
    // at position i
    for (int g = threadIdx.x; g < g_rows; g += blockDim.x) {
      const uint4* src = reinterpret_cast<const uint4*>(guides) + 8 * g;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const uint4 a = src[v];
        const uint32_t lanes[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t bit = 1u << (4 * v + j);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            w[b] |= ((lanes[j] >> (8 * b)) & 0xFFu) ? bit : 0u;
          }
        }
      }
      s_guide[g] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  __syncthreads();
}

struct Masks {
  uint32_t m[4];
};

// Target t's masks from the (32, n) codes; PAD_CODE sets no bit.
__device__ __forceinline__ Masks code_masks(const int8_t* __restrict__ codes,
                                            long long n, long long t) {
  Masks k = {{0u, 0u, 0u, 0u}};
#pragma unroll
  for (int i = 0; i < kCodeRows; ++i) {
    const int c = codes[static_cast<long long>(i) * n + t];
    const uint32_t bit = 1u << i;
#pragma unroll
    for (int b = 0; b < 4; ++b) k.m[b] |= (c == b) ? bit : 0u;
  }
  return k;
}

// Target t's masks from the (128, n) one-hot: row 4i+b gives mask b, bit i.
// Neighbouring threads read neighbouring bytes of each row.
__device__ __forceinline__ Masks onehot_masks(const int8_t* __restrict__ oh,
                                              long long n, long long t) {
  Masks k = {{0u, 0u, 0u, 0u}};
#pragma unroll
  for (int i = 0; i < kCodeRows; ++i) {
    const uint32_t bit = 1u << i;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      k.m[b] |= oh[static_cast<long long>(4 * i + b) * n + t] ? bit : 0u;
    }
  }
  return k;
}

__device__ __forceinline__ int matches(const Masks& k, const uint4 w) {
  return __popc((k.m[0] & w.x) | (k.m[1] & w.y) | (k.m[2] & w.z) |
                (k.m[3] & w.w));
}

// max over all g_rows guides of the match count, held in Acc (int16_t for
// X2, int for the others), then the threshold in Acc: no early exit
template <typename Acc>
__device__ __forceinline__ int8_t max_hit(const Masks& k, const uint4* s_guide,
                                          int g_rows, int thr) {
  const Acc t = static_cast<Acc>(thr);
  Acc best = -1;
  for (int g = 0; g < g_rows; ++g) {
    const Acc c = static_cast<Acc>(matches(k, s_guide[g]));
    best = c > best ? c : best;
  }
  return best >= t ? 1 : 0;
}

// X2 (Acc = int16_t, interleaved) and X3 (Acc = int, block layout):
// persistent grid, the guide words packed once per resident block
template <int kLayout, typename Acc>
__global__ void __launch_bounds__(kThreads)
max_kernel(const int8_t* __restrict__ codes, long long n,
           const int8_t* __restrict__ guides, int g_rows, int thr,
           int8_t* __restrict__ out) {
  extern __shared__ uint4 s_guide[];
  pack_guides<kLayout>(guides, g_rows, s_guide);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += stride) {
    out[t] = max_hit<Acc>(code_masks(codes, n, t), s_guide, g_rows, thr);
  }
}

// X1: persistent grid over passes of kGloopTargets x kThreads targets; in
// each pass every whole 128-row guide tile is packed into shared memory and
// folded into each target's running max. The pass loop's bound depends only
// on blockIdx, so every thread of a block reaches each __syncthreads.
__global__ void __launch_bounds__(kThreads)
gloop_kernel(const int8_t* __restrict__ codes, long long n,
             const int8_t* __restrict__ guides, int g_rows, int thr,
             int8_t* __restrict__ out) {
  __shared__ uint4 s_guide[kGuideTile];
  const int n_tiles = g_rows / kGuideTile;
  const long long per_pass = static_cast<long long>(kGloopTargets) * blockDim.x;
  for (long long base = blockIdx.x * per_pass; base < n;
       base += static_cast<long long>(gridDim.x) * per_pass) {
    Masks k[kGloopTargets];
    int best[kGloopTargets];
#pragma unroll
    for (int j = 0; j < kGloopTargets; ++j) {
      const long long t = base + j * blockDim.x + threadIdx.x;
      k[j] = t < n ? code_masks(codes, n, t) : Masks{{0u, 0u, 0u, 0u}};
      best[j] = -1;
    }
    for (int tile = 0; tile < n_tiles; ++tile) {
      __syncthreads();  // the previous tile is no longer read
      pack_guides<kInterleaved>(
          guides + static_cast<long long>(tile) * kGuideTile * kOneHotRows,
          kGuideTile, s_guide);
      for (int g = 0; g < kGuideTile; ++g) {
        const uint4 w = s_guide[g];
#pragma unroll
        for (int j = 0; j < kGloopTargets; ++j) {
          const int c = matches(k[j], w);
          best[j] = c > best[j] ? c : best[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGloopTargets; ++j) {
      const long long t = base + j * blockDim.x + threadIdx.x;
      if (t < n) out[t] = best[j] >= thr ? 1 : 0;
    }
  }
}

// X5: one block per t_tile targets, as the TPU grid had one step per tile;
// every block packs the guide words again
__global__ void __launch_bounds__(kThreads)
tile_kernel(const int8_t* __restrict__ codes, long long n,
            const int8_t* __restrict__ guides, int g_rows, int thr, int t_tile,
            int8_t* __restrict__ out) {
  extern __shared__ uint4 s_guide[];
  pack_guides<kInterleaved>(guides, g_rows, s_guide);
  const long long lo = static_cast<long long>(blockIdx.x) * t_tile;
  const long long hi = lo + t_tile < n ? lo + t_tile : n;
  for (long long t = lo + threadIdx.x; t < hi; t += blockDim.x) {
    out[t] = max_hit<int>(code_masks(codes, n, t), s_guide, g_rows, thr);
  }
}

// X6 over the pre-expanded one-hot, persistent grid. zero is 0 (see the
// header): dot and copy fold what they do not write into their output with it.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
expanded_kernel(const int8_t* __restrict__ oh, long long n,
                const int8_t* __restrict__ guides, int g_rows, int thr,
                int8_t* __restrict__ out, int zero) {
  extern __shared__ uint4 s_guide[];
  if (kMode != kCopy) pack_guides<kInterleaved>(guides, g_rows, s_guide);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += stride) {
    if (kMode == kCopy) {
      // read all 128 rows, write row 0
      const int8_t row0 = oh[t];
      int fold = 0;
#pragma unroll
      for (int r = 1; r < kOneHotRows; ++r) {
        fold ^= oh[static_cast<long long>(r) * n + t];
      }
      out[t] = static_cast<int8_t>(row0 ^ (fold & zero));
    } else if (kMode == kDot) {
      // every guide's count, none of them reduced; guide 0's is written
      const Masks k = onehot_masks(oh, n, t);
      const int first = matches(k, s_guide[0]);
      int fold = 0;
      for (int g = 1; g < g_rows; ++g) fold += matches(k, s_guide[g]);
      out[t] = static_cast<int8_t>(first ^ (fold & zero));
    } else {
      out[t] = max_hit<int>(onehot_masks(oh, n, t), s_guide, g_rows, thr);
    }
  }
}

// X4 on the int8 tensor cores (see the header). Lane (g, t) of a warp tile
// at t0 holds b[j][s][h]: the one-hot of base s at positions 16h + 4t +
// {0..3} of target t0 + 8j + g; targets past n are padding.
__device__ __forceinline__ void bf16out_fragments(uint32_t (&b)[kNTiles][kKSteps][2],
                                                  const int8_t* __restrict__ codes,
                                                  long long n, long long t0, int g,
                                                  int t) {
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const long long col = t0 + 8 * j + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = col < n ? __ldg(codes + static_cast<long long>(16 * h + 4 * t + q) * n + col)
                              : kPadCode;
        w |= static_cast<uint32_t>(static_cast<uint8_t>(c)) << (8 * q);
      }
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
        b[j][s][h] = __vcmpeq4(w, 0x01010101u * s) & 0x01010101u;
      }
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1)
bf16out_kernel(const int8_t* __restrict__ codes, long long n,
               const int8_t* __restrict__ guides, int g_rows, int thr,
               int8_t* __restrict__ out) {
  extern __shared__ __align__(16) int8_t s_rows[];  // [kRowChunks][rows16][16]
  const uint32_t s_base = static_cast<uint32_t>(__cvta_generic_to_shared(s_rows));
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c0 = -max(thr, 0);
  const long long n_tiles = (n + kWarpTargets - 1) / kWarpTargets;
  const long long stride = static_cast<long long>(gridDim.x) * kMmaWarps;
  const long long first = static_cast<long long>(blockIdx.x) * kMmaWarps + (threadIdx.x >> 5);
  for (int r0 = 0; r0 < g_rows; r0 += kStageRows) {
    const int rows = min(kStageRows, g_rows - r0);
    const int rows16 = (rows + kMTile - 1) / kMTile * kMTile;
    __syncthreads();  // no warp still reads the previous stage
    // row r's 16-byte chunk c at chunk c * rows16 + r; padding rows zero
    for (int q = threadIdx.x; q < rows16 * kRowChunks; q += kMmaThreads) {
      const int r = q / kRowChunks;
      const uint32_t off = ((q - r * kRowChunks) * rows16 + r) * 16;
      if (r < rows) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(s_base + off),
                        "l"(guides + 16 * (static_cast<long long>(r0) * kRowChunks + q)));
      } else {
        *reinterpret_cast<uint4*>(s_rows + off) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // ldmatrix.x4: lanes 8i..8i+7 address matrix i = rows 8(i&1)+{0..7},
    // k-bytes 16(i>>1)..+15 of the k-step
    uint32_t a_addr[kKSteps];
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      a_addr[s] = s_base + ((2 * s + (lane >> 4)) * rows16 + (lane & 15)) * 16;
    }
    const int m_tiles = rows16 / kMTile;
    for (long long wt = first; wt < n_tiles; wt += stride) {
      uint32_t b[kNTiles][kKSteps][2];
      bf16out_fragments(b, codes, n, wt * kWarpTargets, g, t);
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
          mma_s8(d, a[0], b[j][0][0], b[j][0][1], c0);
#pragma unroll
          for (int s = 1; s < kKSteps; ++s) mma_s8(d, a[s], b[j][s][0], b[j][s][1]);
          // d0, d2: target 2t (rows g, g+8); d1, d3: target 2t+1
          run[j][0] &= static_cast<uint32_t>(d[0]) & static_cast<uint32_t>(d[2]);
          run[j][1] &= static_cast<uint32_t>(d[1]) & static_cast<uint32_t>(d[3]);
        }
      }
      // fold the 8 lane groups; lane (g, t) then writes targets 2t, 2t+1 of
      // n-tile g, OR-ed into what it wrote for the earlier stages
      uint32_t h0 = 0, h1 = 0;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          run[j][0] &= __shfl_xor_sync(0xFFFFFFFFu, run[j][0], off);
          run[j][1] &= __shfl_xor_sync(0xFFFFFFFFu, run[j][1], off);
        }
        if (j == g) {
          h0 = run[j][0];
          h1 = run[j][1];
        }
      }
      const long long col = wt * kWarpTargets + 8 * g + 2 * t;
      if (col < n) {
        out[col] = static_cast<int8_t>((r0 ? out[col] : 0) | (static_cast<int>(h0) >= 0));
      }
      if (col + 1 < n) {
        out[col + 1] = static_cast<int8_t>((r0 ? out[col + 1] : 0) | (static_cast<int>(h1) >= 0));
      }
    }
  }
}

// Grid of a persistent kernel: as many blocks as are resident on the card,
// and no more than the targets need at per_block targets a block.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, long long n,
                            long long per_block, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  const long long need = (n + per_block - 1) / per_block;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(need < resident ? need : resident);
  return cudaSuccess;
}

// ...rest: the kernel's arguments after (src, n, guides, g_rows, thr, out)
template <typename Kernel, typename... Rest>
int launch_persistent(Kernel kernel, const void* src, long long n,
                      const void* guides, int g_rows, int thr, void* out,
                      void* stream, size_t smem, long long per_block,
                      Rest... rest) {
  if (n <= 0) return 0;
  int grid = 0;
  const cudaError_t err = persistent_grid(kernel, kThreads, smem, n, per_block, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(src), n, static_cast<const int8_t*>(guides),
      g_rows, thr, static_cast<int8_t*>(out), rest...);
  return static_cast<int>(cudaGetLastError());
}

size_t guide_smem(int g_rows) { return static_cast<size_t>(g_rows) * sizeof(uint4); }

}  // namespace

// Each launcher runs on `stream` and returns the cudaError_t of the launch
// (0 on success). codes: (32, n) int8; onehot: (128, n) int8; guides:
// (g_rows, 128) int8, 16-byte aligned, g_rows >= 1; out: (n,) int8. X2,
// X3, X5 and X6 keep 16 bytes of packed words per guide row in the default
// 48 KB of shared memory, so they take g_rows <= 3072; X1 packs one 128-row
// tile at a time and X4 stages 1024 rows at a time (131,072 B of dynamic
// shared memory), so both take any g_rows. The
// wrappers cap g_rows at 2048 (ops/scan_kernel.py MAX_GUIDE_ROWS). The
// caller checks shapes, types, alignment, 0/1 guide bytes and the
// thresholds' range.
static_assert(kOneHotRows == 4 * kCodeRows, "one-hot is 4 x 32 rows");

// any g_rows >= 1: rows past the last whole 128-row tile are not read
extern "C" int ff_v1_gloop_launch(const void* codes, long long n,
                                  const void* guides, int g_rows, int thr,
                                  void* out, void* stream) {
  return launch_persistent(gloop_kernel, codes, n, guides, g_rows, thr, out,
                           stream, 0, static_cast<long long>(kGloopTargets) * kThreads);
}

extern "C" int ff_v3_int16_launch(const void* codes, long long n,
                                  const void* guides, int g_rows, int thr,
                                  void* out, void* stream) {
  return launch_persistent(max_kernel<kInterleaved, int16_t>, codes, n, guides,
                           g_rows, thr, out, stream, guide_smem(g_rows), kThreads);
}

extern "C" int ff_v4_concat_onehot_launch(const void* codes, long long n,
                                          const void* guides, int g_rows,
                                          int thr, void* out, void* stream) {
  return launch_persistent(max_kernel<kBlock, int>, codes, n, guides, g_rows,
                           thr, out, stream, guide_smem(g_rows), kThreads);
}

extern "C" int ff_v6_bf16out_launch(const void* codes, long long n,
                                    const void* guides, int g_rows, int thr,
                                    void* out, void* stream) {
  if (g_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int staged = g_rows < kStageRows ? g_rows : kStageRows;
  const size_t smem = static_cast<size_t>((staged + kMTile - 1) / kMTile * kMTile) *
                      kOneHotRows;
  cudaError_t err = cudaFuncSetAttribute(
      bf16out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  err = persistent_grid(bf16out_kernel, kMmaThreads, smem, n,
                        static_cast<long long>(kMmaWarps) * kWarpTargets, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  bf16out_kernel<<<grid, kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), n, static_cast<const int8_t*>(guides),
      g_rows, thr, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// t_tile >= 1 targets per block; grid ceil(n / t_tile) <= INT_MAX
extern "C" int ff_v5_tile_launch(const void* codes, long long n,
                                 const void* guides, int g_rows, int thr,
                                 int t_tile, void* out, void* stream) {
  if (n <= 0) return 0;
  if (t_tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (n + t_tile - 1) / t_tile;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  tile_kernel<<<static_cast<int>(grid), kThreads, guide_smem(g_rows),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), n, static_cast<const int8_t*>(guides),
      g_rows, thr, t_tile, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// mode 0 = full, 1 = dot, 2 = copy (guides unused)
extern "C" int ff_expanded_launch(const void* onehot, long long n,
                                  const void* guides, int g_rows, int thr,
                                  int mode, void* out, void* stream) {
  const int zero = 0;
  switch (mode) {
    case kFull:
      return launch_persistent(expanded_kernel<kFull>, onehot, n, guides, g_rows,
                               thr, out, stream, guide_smem(g_rows), kThreads, zero);
    case kDot:
      return launch_persistent(expanded_kernel<kDot>, onehot, n, guides, g_rows,
                               thr, out, stream, guide_smem(g_rows), kThreads, zero);
    case kCopy:
      return launch_persistent(expanded_kernel<kCopy>, onehot, n, guides, g_rows,
                               thr, out, stream, 0, kThreads, zero);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
