// The stage-1 variants of the experiment tool, one hit byte per target.
//
// Replaces six Pallas kernels of tools/experiment_stage1.py. Each launcher
// (X3's through its wrapper) takes the inputs of its TPU kernel and writes
// the same (1, n) int8 output, bit for bit:
//   X1 make_v1_gloop         ff_v1_gloop_launch          X5's function over
//                            the first g_rows // 128 * 128 guide rows (the
//                            TPU kernel's range(g_rows // g_tile)), on
//                            wgmma; with fewer than 128 rows its running max
//                            stays -1 and every byte is -1 >= thr
//   X2 make_v3_int16         ff_v3_int16_launch          X5's function at an
//                            int16 threshold, on wgmma
//   X3 make_v4_concat_onehot ff_v5_tile_launch at t_tile 4096 on the
//                            block-layout guides that the wrapper permutes
//                            to interleaved order (X5's function), on wgmma
//   X4 make_v6_bf16out       ff_v6_bf16out_launch        block-layout guides,
//                            the bf16 max of the counts >= bf16(thr), on the
//                            int8 tensor cores
//   X5 make_v5_tile          ff_v5_tile_launch           interleaved guides,
//                            32-bit max of the counts >= thr, in work units
//                            of t_tile targets, on the int8 tensor cores
//                            (wgmma)
//   X6 make_expanded         ff_expanded_launch          a pre-expanded
//                            (128, n) one-hot in place of the codes; mode
//                            full = hit byte, dot = guide 0's match count
//                            (both on wgmma), copy = one-hot row 0
// with
//   codes  (32, n)  int8 plane-major base codes; padding columns hold
//                   PAD_CODE = 4 in every row, rows >= L hold 0
//   onehot (128, n) int8, row 4i+b = (code_i == b) as the wrapper's
//                   expand_onehot builds it; X6 full and dot multiply any
//                   int8 bytes exactly, so nothing about them is assumed
//   guides (G, 128) int8 0/1 one-hot: interleaved (column 4i+b = base b at
//                   position i) or block layout (column 32b+i)
//
// What bounds them on Hopper: the 2 x 128 x G x n int8 operations of the
// one-hot product (1.11 ms at the tool's 2^23 targets x 1024 guides at the
// published 1,979 TOP/s); the bytes (33 per target from codes, 129 from the
// one-hot) are a small share. X6 copy runs on the CUDA cores; X4 runs the
// product on the int8 tensor cores with mma.sync; X1, X2, X3, X5 and X6
// full/dot run it with wgmma, which alone reaches the cores' full int8 rate.
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
// Design of X1, X2, X3, X5 and X6 full/dot (wgmma_kernel, the helpers in
// wgmma_s8.cuh): X1, X2 and X3 compute X5's function, so they run X5's
// kernel at their TPU kernels' t_tile of 4096; what is theirs is in the
// launchers below (X1's whole tiles, X2's int16 threshold) and, for X3, in
// its wrapper, which moves its block-layout guide column 32b+i to 4i+b once
// per call (one copy of G x 128 bytes). The product sums over the 128
// columns, so one permutation of the columns of both operands changes no
// count: the permuted guides times X5's interleaved B tile are the TPU
// kernel's block-layout product, code rows >= L (0, base A) included. A B
// tile built in block order instead (four packed codes a word, X4's
// __vcmpeq4 build) needs no permutation but ran 0.6% slower (PERF.md).
// The kernel is a persistent grid of one block per SM, three warpgroups a
// block. A = the interleaved guides, already K-major (row-major, 128 bytes a
// row), staged once per block with cp.async, at most 1024 rows (131,072 B) at
// a time and zero-padded to the 64-row m-tile, as X4 stages; B = one tile of
// 128 targets x 128 one-hot bytes, K-major, that each warpgroup builds
// itself, double-buffered (2 x 16,384 B a warpgroup; 229,952 B in all at 1024
// rows). Both lie chunk-major (byte k of row r at ((k / 16) * rows + r) * 16
// + k % 16), which is the no-swizzle layout of 8-row x 16-byte core matrices:
// descriptor sbo = 128, lbo = 16 * rows. Per m-tile a warpgroup issues wgmma
// m64n128k32 s8 for its four k-steps, commits, builds the next piece's B tile
// while they run (at the first m-tile of a piece), waits, and folds the 64
// accumulators; while one warpgroup folds, the other two keep the tensor
// cores busy.
//  - X5's B tile from the (32, n) codes: thread j takes target j, and
//    position i's 4 bytes are __vcmpeq4(c * 0x01010101, 0x03020100) &
//    0x01010101; PAD_CODE and targets past the piece's end give zero bytes.
//  - X6's from the N-major (128, n) one-hot: lane l reads one word (targets
//    4l..4l+3) from each of 16 rows of a 16-byte chunk, transposes each
//    position's 4x4 bytes with three __byte_perm per target, and stores one
//    16-byte chunk per target, in an order rotated by lane so that the 8
//    lanes of a store phase hit 8 bank groups; bytes are read one at a time
//    (and zero past the end) where n is not a multiple of 4 or the piece
//    ends inside the word.
//  - Work pieces: X5 walks units of t_tile targets (any t_tile >= 1, as
//    the TPU grid had one step per t_tile targets, the guide block fetched
//    once for the whole grid), 128 targets a piece, a unit's last piece
//    masked at the unit's end as at n; X6 walks pieces of 128. The answer
//    does not depend on t_tile.
//  - Per m-tile a thread issues few instructions besides its fold: the
//    descriptors are built once per stage and stepped by adding 16-byte
//    units, and k-step 0 overwrites the accumulators (scale-d 0), so none is
//    set beforehand.
//  - The hit epilogue (X1, X2, X3, X5, X6 full): each thread keeps the running max of
//    its two rows' counts per column held, one VIMNMX3 (__vimax3_s32, a
//    Hopper instruction) per two accumulators, from 0 (counts are >= 0, so
//    any thr <= 0 hits, as max(m) >= thr does); after the last m-tile it
//    packs (max >= thr) into one word, OR-ed over the lanes of a column
//    (shuffles) and the four warps (shared memory), and thread j writes
//    target j's byte, OR-ed into the earlier stages' byte ("max >= thr" is
//    "any >= thr"). Zero padding rows count 0 and change nothing. The first
//    form of this kernel took X4's epilogue (accumulators set to -max(thr,
//    0) before each m-tile, an AND of the sums' sign bits) and built every
//    descriptor anew, and ran slower on the card (PERF.md).
//  - X6 dot: the lanes holding guide 0 put its counts, as int8, in shared
//    memory, and every count is XOR-folded into the written byte through
//    `zero` (below).
//  - Three warpgroups, at 168 registers a thread, beat two; building the
//    next B tile in steps spread over the m-tiles, from registers held
//    across them, spilled to the stack and ran slower.
// tests/test_torch_stage1_variants.py models the layouts, the descriptor,
// the accumulator mapping, the transpose and the epilogues in numpy.
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

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_s8.cuh"
#include "wgmma_s8.cuh"

namespace {

using ff_mma::ldmatrix_x4;
using ff_mma::mma_s8;

constexpr int kThreads = 256;
constexpr int kCodeRows = 32;
constexpr int kOneHotRows = 128;
constexpr int kGuideTile = 128;   // X1: the TPU kernel's g_tile
constexpr long long kToolTile = 4096;  // X1, X2: the TPU kernels' t_tile
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
// X5 and X6 full/dot on wgmma
constexpr int kWgThreads = 128;   // one warpgroup
constexpr int kWarpGroups = 3;
constexpr int kWgmmaThreads = kWarpGroups * kWgThreads;
constexpr int kWgMTile = 64;      // guide rows per wgmma m-tile
constexpr int kBTile = ff_wgmma::kN * kOneHotRows;  // one B tile: 16,384 B
// a warpgroup's fold words (4 warps x 4 lane columns) and dot bytes
constexpr int kWgScratch = 16 * 4 + ff_wgmma::kN;

enum Mode { kFull = 0, kDot = 1, kCopy = 2 };
enum Src { kCodes = 0, kOneHot = 1 };

// X6 copy, the tool's read-rate probe, over the pre-expanded one-hot on a
// persistent grid: it reads all 128 rows and writes row 0. zero is 0 (see
// the header): the rows it does not write are folded into its output with it.
__global__ void __launch_bounds__(kThreads)
copy_kernel(const int8_t* __restrict__ oh, long long n,
            const int8_t* __restrict__ guides, int g_rows, int thr,
            int8_t* __restrict__ out, int zero) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += stride) {
    const int8_t row0 = oh[t];
    int fold = 0;
#pragma unroll
    for (int r = 1; r < kOneHotRows; ++r) {
      fold ^= oh[static_cast<long long>(r) * n + t];
    }
    out[t] = static_cast<int8_t>(row0 ^ (fold & zero));
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

// X1, X2, X5 and X6 full/dot on wgmma (see the header).
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(kWgThreads) : "memory");
}

// The work pieces of n targets in units of t_tile: per_unit pieces of 128
// targets a unit, the last unit holding only the pieces it needs.
struct Pieces {
  long long per_unit, count;
};

__host__ __device__ inline Pieces work_pieces(long long n, long long t_tile) {
  const long long span = t_tile < n ? t_tile : n;
  const long long per_unit = (span + ff_wgmma::kN - 1) / ff_wgmma::kN;
  const long long units = (n + t_tile - 1) / t_tile;
  const long long last = n - (units - 1) * t_tile;
  return {per_unit, (units - 1) * per_unit + (last + ff_wgmma::kN - 1) / ff_wgmma::kN};
}

// Targets [lo, hi) of work piece p: piece k of unit u = p / per_unit covers
// targets u * t_tile + 128k .. (capped at the unit's end and at n).
__device__ __forceinline__ void piece_range(long long p, long long per_unit,
                                            long long t_tile, long long n,
                                            long long& lo, long long& hi) {
  const long long unit = p / per_unit;
  lo = unit * t_tile + (p - unit * per_unit) * ff_wgmma::kN;
  hi = min(min(lo + ff_wgmma::kN, unit * t_tile + t_tile), n);
}

// The B tile of targets [lo, hi): target j = column j, its 128 interleaved
// one-hot bytes chunk-major (byte k at ((k / 16) * 128 + j) * 16 + k % 16);
// targets past hi are zero. tid is the thread's index in its warpgroup.
template <int kSrc>
__device__ __forceinline__ void build_b_tile(int8_t* s_b, const int8_t* __restrict__ src,
                                             long long n, long long lo, long long hi,
                                             bool aligned, int tid) {
  if (kSrc == kCodes) {
    // thread tid builds target tid: position i's word, byte b = (code_i == b)
    const long long col = lo + tid;
    uint32_t code[kCodeRows];
#pragma unroll
    for (int i = 0; i < kCodeRows; ++i) {
      code[i] = col < hi ? static_cast<uint8_t>(__ldg(src + static_cast<long long>(i) * n + col))
                         : static_cast<uint32_t>(kPadCode);
    }
#pragma unroll
    for (int c = 0; c < kOneHotRows / 16; ++c) {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q] = __vcmpeq4(code[4 * c + q] * 0x01010101u, 0x03020100u) & 0x01010101u;
      }
      *reinterpret_cast<uint4*>(s_b + (c * ff_wgmma::kN + tid) * 16) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    // lane l takes targets 4l..4l+3, warp w chunks 2w and 2w+1 (rows 16c..
    // 16c+15): one word of 4 targets per row, a 4x4 byte transpose per
    // position, one 16-byte store per target. Slot s stores target
    // (s + rot) & 3, so that the 8 lanes of each store phase hit 8
    // different 16-byte bank groups.
    const int lane = tid & 31;
    const long long col0 = lo + 4 * lane;
    const bool vec = aligned && col0 + 4 <= hi;
    const int rot = (lane >> 1) & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * (tid >> 5) + h;
      uint32_t r[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int8_t* row = src + static_cast<long long>(16 * c + q) * n;
        if (vec) {
          r[q] = __ldg(reinterpret_cast<const uint32_t*>(row + col0));
        } else {
          r[q] = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (col0 + k < hi) {
              r[q] |= static_cast<uint32_t>(static_cast<uint8_t>(row[col0 + k])) << (8 * k);
            }
          }
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = (s + rot) & 3;
        const uint32_t sel = k | (4 + k) << 4;  // byte k of x, then byte k of y
        uint32_t w[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint32_t u = __byte_perm(r[4 * p], r[4 * p + 1], sel);
          const uint32_t v = __byte_perm(r[4 * p + 2], r[4 * p + 3], sel);
          w[p] = __byte_perm(u, v, 0x5410);  // rows 4p..4p+3 at target k
        }
        *reinterpret_cast<uint4*>(s_b + (c * ff_wgmma::kN + 4 * lane + k) * 16) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

template <int kSrc, int kMode>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
wgmma_kernel(const int8_t* __restrict__ src, long long n,
             const int8_t* __restrict__ guides, int g_rows, int thr,
             long long t_tile, Pieces work, int8_t* __restrict__ out, int zero) {
  extern __shared__ __align__(128) int8_t smem[];
  const int staged_max = min(g_rows, kStageRows);
  const int rows_max = (staged_max + kWgMTile - 1) / kWgMTile * kWgMTile;
  const int wg = threadIdx.x / kWgThreads;
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int8_t* s_b = smem + rows_max * kOneHotRows + wg * 2 * kBTile;
  int8_t* scratch = smem + rows_max * kOneHotRows + kWarpGroups * 2 * kBTile + wg * kWgScratch;
  uint32_t* s_fold = reinterpret_cast<uint32_t*>(scratch);  // [warp][t]
  int8_t* s_first = scratch + 16 * 4;                        // dot: guide 0's counts
  const uint32_t a_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t b_base = static_cast<uint32_t>(__cvta_generic_to_shared(s_b));
  const long long per_unit = work.per_unit;
  const long long pieces = work.count;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpGroups;
  const long long first = static_cast<long long>(blockIdx.x) * kWarpGroups + wg;
  // X6's word loads (its pieces start at multiples of 128)
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 3) == 0 && (n & 3) == 0;
  for (int r0 = 0; r0 < g_rows; r0 += kStageRows) {
    const int rows = min(kStageRows, g_rows - r0);
    const int rows64 = (rows + kWgMTile - 1) / kWgMTile * kWgMTile;
    __syncthreads();  // no warpgroup still reads the previous stage
    // row r's 16-byte chunk c at (c * rows64 + r) * 16; padding rows zero
    for (int q = threadIdx.x; q < rows64 * kRowChunks; q += kWgmmaThreads) {
      const int r = q / kRowChunks;
      const uint32_t off = ((q - r * kRowChunks) * rows64 + r) * 16;
      if (r < rows) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(a_base + off),
                        "l"(guides + 16 * (static_cast<long long>(r0) * kRowChunks + q)));
      } else {
        *reinterpret_cast<uint4*>(smem + off) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    long long lo = 0, hi = 0;
    if (first < pieces) {
      piece_range(first, per_unit, t_tile, n, lo, hi);
      build_b_tile<kSrc>(s_b, src, n, lo, hi, aligned, tid);
    }
    ff_wgmma::fence_proxy_async();
    __syncthreads();

    // descriptors of k-step 0 of m-tile 0 and of B buffer 0; the others lie
    // whole 16-byte units further on (the address field, bits 0-13)
    const uint64_t desc_a = ff_wgmma::smem_desc(a_base, rows64 * 16, 128);
    const uint64_t desc_b = ff_wgmma::smem_desc(b_base, ff_wgmma::kN * 16, 128);
    const int m_tiles = rows64 / kWgMTile;
    int buf = 0;
    for (long long p = first; p < pieces; p += stride) {
      piece_range(p, per_unit, t_tile, n, lo, hi);
      const long long next = p + stride;
      int run[ff_wgmma::kAcc / 2];  // full: max count, per column held
#pragma unroll
      for (int k = 0; k < ff_wgmma::kAcc / 2; ++k) run[k] = 0;
      uint32_t fold = 0;            // dot: every count, folded
      for (int m = 0; m < m_tiles; ++m) {
        int d[ff_wgmma::kAcc];  // k-step 0 overwrites, the others add
        ff_wgmma::fence_operands(d);
        ff_wgmma::fence();
#pragma unroll
        for (int s = 0; s < kKSteps; ++s) {
          ff_wgmma::mma_s8(d, desc_a + 2 * s * rows64 + kWgMTile * m,
                           desc_b + (buf * kBTile + s * 2 * ff_wgmma::kN * 16) / 16, s > 0);
        }
        ff_wgmma::commit_group();
        if (m == 0 && next < pieces) {
          // the next piece's B tile, while this m-tile's wgmmas run
          long long nlo, nhi;
          piece_range(next, per_unit, t_tile, n, nlo, nhi);
          build_b_tile<kSrc>(s_b + (buf ^ 1) * kBTile, src, n, nlo, nhi, aligned, tid);
        }
        ff_wgmma::wait_group<0>();
        ff_wgmma::fence_operands(d);
        if (kMode == kFull) {
#pragma unroll
          for (int j = 0; j < ff_wgmma::kN / 8; ++j) {
            run[2 * j] = __vimax3_s32(run[2 * j], d[4 * j], d[4 * j + 2]);
            run[2 * j + 1] = __vimax3_s32(run[2 * j + 1], d[4 * j + 1], d[4 * j + 3]);
          }
        } else {
          if (r0 == 0 && m == 0 && warp == 0 && g == 0) {
#pragma unroll
            for (int j = 0; j < ff_wgmma::kN / 8; ++j) {
              s_first[8 * j + 2 * t] = static_cast<int8_t>(d[4 * j]);
              s_first[8 * j + 2 * t + 1] = static_cast<int8_t>(d[4 * j + 1]);
            }
          }
#pragma unroll
          for (int k = 0; k < ff_wgmma::kAcc; k += 2) {
            fold ^= static_cast<uint32_t>(d[k]) ^ static_cast<uint32_t>(d[k + 1]);
          }
        }
      }
      if (kMode == kFull) {
        // bit 2j+v: a row of this warp reaches thr at column 8j+2t+v
        uint32_t bits = 0;
#pragma unroll
        for (int k = 0; k < ff_wgmma::kAcc / 2; ++k) {
          bits |= static_cast<uint32_t>(run[k] >= thr) << k;
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, off);
        if (g == 0) s_fold[warp * 4 + t] = bits;
      }
      wg_barrier(wg);
      // thread tid writes column tid, OR-ed into (full) or kept from (dot)
      // what the earlier stages wrote
      const long long col = lo + tid;
      if (col < hi) {
        if (kMode == kFull) {
          const int bit = 2 * (tid >> 3) + (tid & 1);
          const int lc = (tid >> 1) & 3;
          const uint32_t any = s_fold[lc] | s_fold[4 + lc] | s_fold[8 + lc] | s_fold[12 + lc];
          const int hit = static_cast<int>((any >> bit) & 1u);
          out[col] = static_cast<int8_t>((r0 ? out[col] : 0) | hit);
        } else {
          const int8_t byte = r0 ? out[col] : s_first[tid];
          out[col] = static_cast<int8_t>(byte ^ static_cast<int8_t>(fold & zero));
        }
      }
      // the next B tile is visible to wgmma; s_fold and s_first are free
      ff_wgmma::fence_proxy_async();
      wg_barrier(wg);
      buf ^= 1;
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

}  // namespace

// Each launcher runs on `stream` and returns the cudaError_t of the launch
// (0 on success). codes: (32, n) int8; onehot: (128, n) int8; guides:
// (g_rows, 128) int8, 16-byte aligned, g_rows >= 1; out: (n,) int8. The
// kernels stage 1024 guide rows at a time in dynamic shared memory, so they
// take any g_rows; the wrappers cap it at 2048 (ops/scan_kernel.py
// MAX_GUIDE_ROWS). The caller checks shapes, types, alignment, 0/1 guide
// bytes and the thresholds' range.
static_assert(kOneHotRows == 4 * kCodeRows, "one-hot is 4 x 32 rows");

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

// X1, X2 (codes, t_tile 4096), X5 (codes, t_tile >= 1; X3 at 4096) and X6
// full/dot (one-hot, t_tile = 128): the persistent wgmma kernel, one block
// per SM
template <int kSrc, int kMode>
int launch_wgmma(const void* src, long long n, const void* guides, int g_rows,
                 int thr, long long t_tile, void* out, void* stream) {
  if (g_rows < 1 || t_tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int staged = g_rows < kStageRows ? g_rows : kStageRows;
  const size_t smem =
      static_cast<size_t>((staged + kWgMTile - 1) / kWgMTile * kWgMTile) * kOneHotRows +
      static_cast<size_t>(kWarpGroups) * (2 * kBTile + kWgScratch);
  cudaError_t err = cudaFuncSetAttribute(wgmma_kernel<kSrc, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Pieces work = work_pieces(n, t_tile);
  int grid = 0;
  err = persistent_grid(wgmma_kernel<kSrc, kMode>, kWgmmaThreads, smem, work.count,
                        kWarpGroups, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_kernel<kSrc, kMode><<<grid, kWgmmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(src), n, static_cast<const int8_t*>(guides), g_rows, thr,
      t_tile, work, static_cast<int8_t*>(out), 0);
  return static_cast<int>(cudaGetLastError());
}

// t_tile >= 1 targets per work unit; the answer does not depend on it. X3
// launches it at 4096 on its permuted guides (the wrapper's).
extern "C" int ff_v5_tile_launch(const void* codes, long long n,
                                 const void* guides, int g_rows, int thr,
                                 int t_tile, void* out, void* stream) {
  return launch_wgmma<kCodes, kFull>(codes, n, guides, g_rows, thr, t_tile, out, stream);
}

// any g_rows >= 1: only the first g_rows / 128 * 128 rows are read, so no
// 64-row m-tile or 1024-row stage holds a row past them. With at least one
// whole tile the counts are >= 0 and the kernel's max from 0 is X1's from
// -1; with none, X1's max stays -1 and every byte is -1 >= thr.
extern "C" int ff_v1_gloop_launch(const void* codes, long long n,
                                  const void* guides, int g_rows, int thr,
                                  void* out, void* stream) {
  if (g_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int rows = g_rows / kGuideTile * kGuideTile;
  if (rows == 0) {
    return static_cast<int>(cudaMemsetAsync(out, -1 >= thr ? 1 : 0, static_cast<size_t>(n),
                                            static_cast<cudaStream_t>(stream)));
  }
  return launch_wgmma<kCodes, kFull>(codes, n, guides, rows, thr, kToolTile, out, stream);
}

// thr in int16 range (the wrapper checks it): the counts are 0..32, so the
// kernel's s32 test max >= thr is X2's any(m >= int16(thr))
extern "C" int ff_v3_int16_launch(const void* codes, long long n,
                                  const void* guides, int g_rows, int thr,
                                  void* out, void* stream) {
  return launch_wgmma<kCodes, kFull>(codes, n, guides, g_rows, thr, kToolTile, out, stream);
}

// mode 0 = full, 1 = dot, 2 = copy (guides unused)
extern "C" int ff_expanded_launch(const void* onehot, long long n,
                                  const void* guides, int g_rows, int thr,
                                  int mode, void* out, void* stream) {
  switch (mode) {
    case kFull:
      return launch_wgmma<kOneHot, kFull>(onehot, n, guides, g_rows, thr, ff_wgmma::kN,
                                          out, stream);
    case kDot:
      return launch_wgmma<kOneHot, kDot>(onehot, n, guides, g_rows, thr, ff_wgmma::kN,
                                         out, stream);
    case kCopy:
      return launch_persistent(copy_kernel, onehot, n, guides, g_rows, thr, out, stream,
                               0, kThreads, 0);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
