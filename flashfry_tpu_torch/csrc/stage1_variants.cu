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
//                            the bf16 max of the counts >= bf16(thr), on
//                            wgmma with the targets as M
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
// one-hot) are a small share. X6 copy runs on the CUDA cores; every other
// variant runs the product with wgmma, which alone reaches the cores' full
// int8 rate: X4 with the targets as M (bf16out_kernel), X1, X2, X3, X5 and
// X6 full/dot with the guides as M (wgmma_kernel).
//
// Design of X4 (bf16out_kernel): stage1.cu's (K1's) design with K = 128,
// and its n-tile step (wgmma_s8.cuh issue_rs, fold_max, target_max).
// wgmma.mma_async m64n128k32 s8 x s8 -> s32 with the TARGETS as M (A, from
// registers, mma_s8_rs) and the GUIDES as N (B, from shared memory); four
// warpgroups of one accumulator set each, one block per SM, a persistent
// grid whose warpgroups stride over 64-target m-tiles. Where X4's function
// differs from K1's:
//  - K = 128, not compacted: k-step s is the block-layout columns
//    32s..32s+31, base s at positions 0..31. X4 takes any 0/1 block-layout
//    guide, and code rows >= L hold 0 (base A), so a 1 in columns 24..31
//    counts and all 32 code rows are read.
//  - The A words from 8 code bytes per lane per target: lane (g, t) of warp
//    w holds k-bytes 4t..4t+3 and 16+4t..16+4t+3 of targets 16w + g and
//    16w + g + 8, which in block order are positions 4t..4t+3 and
//    16+4t..16+4t+3, the same in every k-step. The lane reads its 16 code
//    bytes one m-tile ahead into registers, packs each four into a word w,
//    and k-step s's word is __vcmpeq4(w, s * 0x01010101) & 0x01010101:
//    PAD_CODE, any byte outside 0..3 and the ragged tail past n give zero
//    words and never count.
//  - Up to 2048 guide rows (262,144 B) do not fit a block's 232,448 B of
//    shared memory, so the block stages at most 1024 rows (131,072 B) at a
//    time with cp.async, chunk-major (byte k of row r at ((k / 16) * rows +
//    r) * 16 + k % 16: descriptor lbo = 16 * rows, sbo = 128), zero rows up
//    to the 128-row n-tile, and walks the targets once per stage. A target
//    maps to the same thread in every stage, and that thread ORs the later
//    stage's hit into its byte ("max >= thr" is "any >= thr"). Between
//    stages every wgmma has been waited for, then a barrier, the restage,
//    fence.proxy.async and a barrier. The tool's 1024 rows and 512 super
//    rows take one stage.
//  - The epilogue is K1's: running maxima from 0 in registers (one
//    __vimax3_s32 per two accumulators), the max over a target's four lanes
//    by two __shfl_xor_sync, one byte max >= thr. The counts are at most
//    32, exact in bf16, and bf16 rounding keeps order, so the TPU's byte,
//    max_g bf16(count_g) >= bf16(thr), is any_g(count_g >= thr) for every
//    int32 thr; counts are >= 0, so any thr <= 0 hits, and zero padding
//    rows count 0 and change nothing.
// tests/test_torch_stage1_variants.py models its A words, staging,
// descriptor reads, accumulators, fold and OR over stages in numpy
// (x4_model).
// On an H100 80GB HBM3 at 700 W, chip_smoke.py times X4 at 1.55 ms at the
// tool's 1024 rows and 0.93 ms on its 512 super rows (72% and 60% of the
// bound; 1.43 and 0.86 ms for the launcher alone), against 2.58 and 1.49
// ms for the warp-level m16n8k32 design it replaced, in turns on the same
// card (PERF.md). 128 registers a thread (the cap at 512 threads), no
// spills.
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
// tile built in block order instead (four packed codes a word, byte-compared
// with __vcmpeq4 as X4 builds its A words) needs no permutation but ran 0.6%
// slower (PERF.md).
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
//    form of this kernel took the epilogue of X4's earlier, warp-level
//    design (accumulators set to -max(thr, 0) before each m-tile, an AND of
//    the sums' sign bits) and built every descriptor anew, and ran slower
//    on the card (PERF.md).
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

#include "wgmma_s8.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCodeRows = 32;
constexpr int kOneHotRows = 128;
constexpr int kGuideTile = 128;   // X1: the TPU kernel's g_tile
constexpr long long kToolTile = 4096;  // X1, X2: the TPU kernels' t_tile
constexpr int kKSteps = kOneHotRows / 32;    // k-step b: base b at positions 0..31
constexpr int kRowChunks = kOneHotRows / 16;  // 16-byte chunks per guide row
constexpr int kStageRows = 1024;  // guide rows staged at a time: 131,072 B
constexpr int kPadCode = 4;
constexpr int kWgThreads = 128;   // one warpgroup
// X4 on wgmma, the targets as M
constexpr int kX4WarpGroups = 4;
constexpr int kX4Threads = kX4WarpGroups * kWgThreads;
constexpr int kX4MTile = 64;      // targets per warpgroup m-tile
constexpr int kX4NTile = ff_wgmma::kN;  // guide rows per wgmma n-tile
// X1, X2, X3, X5 and X6 full/dot on wgmma, the guides as M
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

// X4 (see the header). The code bytes lane (g, t) of warp w needs for the
// m-tile whose target 16w + g is col: c[v][4h + q] = position 16h + 4t + q
// of target col + 8v, zero-extended; targets past n are padding.
// `lane_codes` is codes + 4t * n.
__device__ __forceinline__ void load_block_codes(uint32_t (&c)[2][8],
                                                 const int8_t* __restrict__ lane_codes,
                                                 long long n, long long col) {
#pragma unroll
  for (int v = 0; v < 2; ++v) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const long long row = 16 * (p >> 2) + (p & 3);
      c[v][p] = col + 8 * v < n
                    ? static_cast<uint8_t>(__ldg(lane_codes + row * n + col + 8 * v))
                    : static_cast<uint32_t>(kPadCode);
    }
  }
}

// a[s][v + 2h] = the one-hot of base s at positions 16h + 4t + {0..3} of
// target row + 8v (mma_s8_rs's fragment; k-step s is block columns 32s..):
// the four code bytes packed into one word, byte-compared with s
__device__ __forceinline__ void block_a_words(uint32_t (&a)[kKSteps][4],
                                              const uint32_t (&c)[2][8]) {
#pragma unroll
  for (int v = 0; v < 2; ++v) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t w = __byte_perm(__byte_perm(c[v][4 * h], c[v][4 * h + 1], 0x0040),
                                     __byte_perm(c[v][4 * h + 2], c[v][4 * h + 3], 0x0040),
                                     0x5410);
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
        a[s][v + 2 * h] = __vcmpeq4(w, 0x01010101u * s) & 0x01010101u;
      }
    }
  }
}

__global__ void __launch_bounds__(kX4Threads, 1)
bf16out_kernel(const int8_t* __restrict__ codes, long long n,
               const int8_t* __restrict__ guides, int g_rows, int thr,
               int8_t* __restrict__ out) {
  extern __shared__ __align__(16) int8_t s_rows[];  // [kRowChunks][rows][16]
  const uint32_t s_base = static_cast<uint32_t>(__cvta_generic_to_shared(s_rows));
  const int wl = threadIdx.x % kWgThreads;
  const int warp = wl >> 5;
  const int lane = wl & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row = 16 * warp + g;  // the thread's first target in an m-tile
  const int8_t* lane_codes = codes + 4LL * t * n;
  const long long m_tiles = (n + kX4MTile - 1) / kX4MTile;
  const long long stride = static_cast<long long>(gridDim.x) * kX4WarpGroups;
  const long long first =
      static_cast<long long>(blockIdx.x) * kX4WarpGroups + threadIdx.x / kWgThreads;
  for (int r0 = 0; r0 < g_rows; r0 += kStageRows) {
    const int staged = min(kStageRows, g_rows - r0);
    const int rows = (staged + kX4NTile - 1) / kX4NTile * kX4NTile;
    uint32_t c[2][8];  // the next m-tile's code bytes, loaded a tile ahead
    if (first < m_tiles) load_block_codes(c, lane_codes, n, first * kX4MTile + row);
    // every wgmma of the previous stage was waited for (wait_group 0 after
    // each n-tile); after this barrier no warpgroup reads it
    __syncthreads();
    // row r's 16-byte chunk c at (c * rows + r) * 16; rows up to the n-tile zero
    for (int q = threadIdx.x; q < rows * kRowChunks; q += kX4Threads) {
      const int r = q / kRowChunks;
      const uint32_t off = ((q - r * kRowChunks) * rows + r) * 16;
      if (r < staged) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(s_base + off),
                        "l"(guides + 16 * (static_cast<long long>(r0) * kRowChunks + q)));
      } else {
        *reinterpret_cast<uint4*>(s_rows + off) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    ff_wgmma::fence_proxy_async();
    __syncthreads();

    uint64_t desc[kKSteps];
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      desc[s] = ff_wgmma::smem_desc(s_base + 2 * s * rows * 16, 16 * rows, 128);
    }
    const int n_tiles = rows / kX4NTile;
    for (long long mt = first; mt < m_tiles; mt += stride) {
      uint32_t a[kKSteps][4];
      block_a_words(a, c);
      if (mt + stride < m_tiles) {
        load_block_codes(c, lane_codes, n, (mt + stride) * kX4MTile + row);
      }
      int run[2][2] = {{0, 0}, {0, 0}};
      for (int j = 0; j < n_tiles; ++j) {
        int d[ff_wgmma::kAcc];  // k-step 0 overwrites, the others add
        ff_wgmma::issue_rs(d, a, desc, j);
        ff_wgmma::wait_group<0>();
        ff_wgmma::fold_max(run, d);
      }
      // lane t = 0 writes target row, t = 1 target row + 8, OR-ed into what
      // it wrote for the earlier stages
      const int top = ff_wgmma::target_max(run, t);
      const long long col = mt * kX4MTile + row + 8 * t;
      if (t < 2 && col < n) {
        out[col] = static_cast<int8_t>((r0 ? out[col] : 0) | (top >= thr));
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
  const size_t smem = static_cast<size_t>((staged + kX4NTile - 1) / kX4NTile * kX4NTile) *
                      kOneHotRows;
  cudaError_t err = cudaFuncSetAttribute(
      bf16out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  err = persistent_grid(bf16out_kernel, kX4Threads, smem, (n + kX4MTile - 1) / kX4MTile,
                        kX4WarpGroups, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  bf16out_kernel<<<grid, kX4Threads, smem, static_cast<cudaStream_t>(stream)>>>(
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
