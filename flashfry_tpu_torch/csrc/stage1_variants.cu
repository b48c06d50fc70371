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
//                            each count converted to bf16, a bf16 max, then
//                            >= bf16(thr)
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
// What bounds them on Hopper: as for stage1.cu, the G x n guide loop, an
// integer-issue loop of one popcount per target-guide pair; the bytes
// (33 per target from codes, 129 from the one-hot) are a small share.
//
// Design. stage1.cu's: each thread owns a target column and keeps its
// one-hot as four 32-bit masks (bit i of m_b: base i == b); each guide is
// packed into four words in shared memory. A target has at most one base per
// position, so the four AND-ed masks are disjoint and one popcount of their
// OR is the int8 product of the TPU kernel. That holds for guides with more
// than one 1 in a position group too (X4 on the tool's "g2bf" super rows,
// the max of two guides' rows): the masks a target contributes stay disjoint.
// The variants differ from stage1.cu, and from each other, only where their
// TPU kernels differed: the guide layout the packing reads, the epilogue (a
// max over all G, then the threshold; never stage1.cu's early exit), the
// grid, and X6's input. X1 re-packs each 128-row guide tile into shared
// memory for every pass over the block's targets, as the TPU kernel sliced
// its guide block per tile; each thread holds four targets, so a packed tile
// serves 1024 of them. X4 converts each pair of counts to one __nv_bfloat162
// and reduces with __hmax2, the card's form of the TPU's two-bf16-per-lane
// epilogue; counts are at most 32, so every bf16 value is exact.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCodeRows = 32;
constexpr int kOneHotRows = 128;
constexpr int kGuideTile = 128;   // X1: the TPU kernel's g_tile
constexpr int kGloopTargets = 4;  // X1: targets per thread

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
// X2, __nv_bfloat16 for X4, int for the others), then the threshold in Acc:
// no early exit
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

// X4: two guides' counts per __nv_bfloat162, reduced with __hmax2; the
// start value -1 never wins, since counts are >= 0 and g_rows >= 1
template <>
__device__ __forceinline__ int8_t max_hit<__nv_bfloat16>(const Masks& k,
                                                         const uint4* s_guide,
                                                         int g_rows, int thr) {
  __nv_bfloat162 best2 = __float2bfloat162_rn(-1.0f);
  int g = 0;
  for (; g + 1 < g_rows; g += 2) {
    best2 = __hmax2(best2, __floats2bfloat162_rn(
                               static_cast<float>(matches(k, s_guide[g])),
                               static_cast<float>(matches(k, s_guide[g + 1]))));
  }
  __nv_bfloat16 best = __hmax(__low2bfloat16(best2), __high2bfloat16(best2));
  if (g < g_rows) {
    best = __hmax(best, __float2bfloat16_rn(static_cast<float>(matches(k, s_guide[g]))));
  }
  return __hge(best, __float2bfloat16_rn(static_cast<float>(thr))) ? 1 : 0;
}

// X2 (Acc = int16_t, interleaved), X3 (Acc = int, block layout) and X4
// (Acc = __nv_bfloat16, block layout): persistent grid, the guide words
// packed once per resident block
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

// Grid of a persistent kernel: as many blocks as are resident on the card,
// and no more than the targets need at per_block targets a block.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, long long n,
                            long long per_block, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
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
  const cudaError_t err = persistent_grid(kernel, smem, n, per_block, &grid);
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
// (g_rows, 128) int8, 16-byte aligned, 1 <= g_rows <= 3072 (the packed words
// fit 48 KB of shared memory); out: (n,) int8. The caller checks shapes,
// types, alignment and the thresholds' range.
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
  return launch_persistent(max_kernel<kBlock, __nv_bfloat16>, codes, n, guides,
                           g_rows, thr, out, stream, guide_smem(g_rows), kThreads);
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
