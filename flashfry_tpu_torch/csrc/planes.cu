// Plane expand of the database build: packed target words -> plane-major
// base codes.
//
// Replaces no Pallas kernel: the JAX package leaves this step to XLA
// (`_expand_codes_jit`, flashfry_tpu/ops/scan.py:508, fused into one device
// pass), after splitting each word into two int32 halves on the host. Here
// the words reach the card as they lie in the database, int64 with the
// target's count in bits 48..63, and this kernel does all the bit work. For
// targets [0, n) of `words` it writes, into columns [start, start + n) of a
// (32, stride) int8 buffer,
//   row i < L:   (w >> 2 (L - 1 - i)) & 3   (base i; the largest shift, 46
//                for L = 24, never reaches the count bits)
//   row i >= L:  0
// and leaves every other column as it is.
//
// What bounds it on Hopper: bytes. 8 B read and 32 B written per target:
// 0.050 ms for a 4,194,304-target slab and 0.57 ms for 47.8M targets at
// 3.35 TB/s. The work is a few shifts per byte written.
//
// Design: one block of 256 threads per tile of 1024 consecutive targets,
// one launch per slab.
//  - Each thread loads the words of a run of 4 consecutive targets and packs
//    their 4 codes of each row into one 32-bit word in shared memory
//    (rows < L only: at most 24 x 1 KB).
//  - Then, row by row, each thread stores one 4-byte word of the row, so a
//    warp's store is 128 contiguous bytes. The buffer's row stride and
//    `start` may be anything (odd widths included), so the tile's bytes of a
//    row begin at some byte offset `a` (0..3) below a 4-byte boundary: the
//    thread assembles its aligned word from two shared-memory words with one
//    funnel shift, and the a head bytes and the < 4 tail bytes are stored
//    one by one. a is the same for every thread of a row, so nothing
//    diverges but the edges.
// No byte outside the tile's columns is written, so slabs of one build can
// share the buffer, and its PAD_CODE columns past n stay.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 4;                    // consecutive targets per thread
constexpr int kTile = kThreads * kRun;     // targets per block
constexpr int kRows = 32;                  // rows of the buffer
constexpr int kMaxL = 24;                  // base rows a target can have
constexpr int kWords = kTile / 4 + 1;      // 32-bit words per shared row (+1
                                           // for the funnel's upper word)

__global__ void __launch_bounds__(kThreads)
expand_kernel(const long long* __restrict__ words, long long n, int L,
              int8_t* __restrict__ out, long long stride, long long start) {
  __shared__ uint32_t packed[kMaxL][kWords];
  const int tid = threadIdx.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const int len = static_cast<int>(min(static_cast<long long>(kTile), n - t0));

  // 1. the codes of this thread's run, 4 per row packed into one word
  uint64_t w[kRun];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int c = tid * kRun + k;
    w[k] = c < len ? static_cast<uint64_t>(__ldg(words + t0 + c)) : 0ull;
  }
#pragma unroll
  for (int i = 0; i < kMaxL; ++i) {
    if (i < L) {
      const int s = 2 * (L - 1 - i);
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        v |= static_cast<uint32_t>((w[k] >> s) & 3u) << (8 * k);
      }
      packed[i][tid] = v;
    }
  }
  __syncthreads();

  // 2. row by row: aligned 4-byte words, then the head and tail bytes
  for (int r = 0; r < kRows; ++r) {
    int8_t* row = out + r * stride + start + t0;
    const int a = static_cast<int>((4 - (reinterpret_cast<uintptr_t>(row) & 3u)) & 3u);
    const int head = min(a, len);
    const int body = len > a ? (len - a) & ~3 : 0;   // bytes in whole words
    const bool base = r < L;
    const int j = a + 4 * tid;                        // this thread's word
    if (j + 4 <= a + body) {
      uint32_t v = 0;
      if (base) v = __funnelshift_r(packed[r][tid], packed[r][tid + 1], 8 * a);
      *reinterpret_cast<uint32_t*>(row + j) = v;
    }
    // bytes 0..head-1 and a+body..len-1 (fewer than 4 each)
    int b = -1;
    if (tid < head) b = tid;
    else if (tid >= 4 && tid < 8 && a + body + tid - 4 < len) b = a + body + tid - 4;
    if (b >= 0) {
      row[b] = base ? static_cast<int8_t>((packed[r][b >> 2] >> (8 * (b & 3))) & 3u) : 0;
    }
  }
}

}  // namespace

// words: (n,) int64 device pointer; out: the (32, stride) int8 buffer's
// first byte, a device pointer. Writes columns [start, start + n) of every
// row, on `stream`; returns the CUDA error code of the launch (0 =
// success). n <= 0 launches nothing. 1 <= L <= 24, 0 <= start and
// start + n <= stride.
extern "C" int ff_expand_launch(const void* words, long long n, int L,
                                void* out, long long stride, long long start,
                                void* stream) {
  if (n <= 0) return 0;
  if (L < 1 || L > kMaxL || start < 0 || start + n > stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (n + kTile - 1) / kTile;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  expand_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(words), n, L, static_cast<int8_t*>(out),
      stride, start);
  return static_cast<int>(cudaGetLastError());
}
