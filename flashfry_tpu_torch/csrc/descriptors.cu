// Mismatch descriptors of off-target scoring: two int32 words per off-target.
//
// Replaces `_desc_jit` of flashfry_tpu/scoring/device.py, a jitted JAX
// function that XLA fuses into one device pass on the TPU. For each
// off-target i it decodes the packed 2-bit sequence (lo[i] = bits 0..31,
// hi[i] = bits 32..47; position p sits at bit 2 * (L - 1 - p)), compares it
// with guide gi[i] at the active positions 0..act_n-1 in ascending order, and
// writes
//   w0 = d0 | d1 << 9 | d2 << 18 | min(count, 7) << 27 | (count > 6) << 30
//   w1 = d3 | d4 << 9 | d5 << 18 | pam << 27
// where d_k = pos << 4 | guide base << 2 | off-target base is the k-th
// mismatch, count the number of mismatches, and pam the last two bases
// (positions L-2, L-1) as a 4-bit code. Mismatches past the sixth only count.
// with
//   lo, hi, gi (n,)   int32
//   gcodes     (G, L) int8 guide base codes 0..3, position 0 first, L <= 24
//   w0, w1     (n,)   int32
//
// What bounds it on Hopper: by the roofline, bytes: 12 B read and 8 B
// written per off-target (0.100 ms for 2^24 off-targets at 3.35 TB/s). The
// first form, a loop over the active positions with a branch on each
// mismatch, was bound by instruction issue instead (0.41 ms at 2^24 on an
// H100 80GB HBM3 at 700 W): a thread takes the branch a few times, but a
// warp takes it at every position where any of its 32 off-targets
// mismatches, which is nearly every position.
//
// Design: a branch-free walk over the set mismatch bits, one thread per
// off-target, 256 threads a block, loads and stores coalesced over i.
//  - Guide words. pack_kernel, started by the same launcher just before,
//    turns each guide's L codes into one 64-bit word: the off-targets'
//    layout shifted up by 64 - 2L, so that position p sits at bits 63 - 2p
//    and 62 - 2p whatever L is. The main kernel reads one word per
//    off-target (from L1/L2: G x 8 bytes) in place of L code bytes.
//  - Mismatch bits. With the off-target shifted the same way, x = seq ^
//    guide; (x | x << 1) & active leaves bit 63 - 2p set iff position p
//    mismatches, where active (built on the host) holds bits 63 - 2p for
//    p < act_n only, so the PAM bits and the bits above 2L never count.
//  - count = popcount; then six unrolled steps, each on the highest set
//    bit: z = clz = 2p, so the walk goes in ascending position order; the
//    two bases are (seq << z) >> 62 and (guide << z) >> 62; the bit is
//    cleared. A step past the last mismatch writes 0 (a select, no branch),
//    and mismatches past the sixth are counted by the popcount alone.
// Words are unsigned, so every shift is logical. A guide index outside
// [0, G) is clamped into it, so no thread reads outside the guide words; the
// caller rejects such an index before the launch. On an H100 80GB HBM3 at
// 700 W, chip_smoke.py times it at 0.17 ms for 2^24 off-targets (PERF.md),
// 60% of the byte bound, with 30 registers a thread and no spills.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 24;
constexpr int kDescBits = 9;   // pos << 4 | g << 2 | o
constexpr int kPerWord = 3;    // descriptors per word
constexpr int kCountShift = 27;
constexpr int kOverflowShift = 30;
constexpr int kPamShift = 27;
constexpr uint64_t kTop = 1ull << 63;

// guide g's codes -> its word, position p at bits 63 - 2p and 62 - 2p
__global__ void __launch_bounds__(kThreads)
pack_kernel(const int8_t* __restrict__ gcodes, int n_guides, int L,
            uint64_t* __restrict__ words) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_guides) return;
  const int8_t* __restrict__ codes = gcodes + static_cast<long long>(g) * L;
  uint64_t w = 0;
  // unrolled to kMaxL, so the L loads are issued together, not one by one
#pragma unroll
  for (int p = 0; p < kMaxL; ++p) {
    if (p < L) w = (w << 2) | (static_cast<uint64_t>(codes[p]) & 3u);
  }
  words[g] = w << (64 - 2 * L);
}

__global__ void __launch_bounds__(kThreads)
descriptors_kernel(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
                   const int* __restrict__ gi, const uint64_t* __restrict__ words,
                   long long n, int n_guides, int L, uint64_t active,
                   uint32_t* __restrict__ w0, uint32_t* __restrict__ w1) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t l = lo[i];
  const uint64_t seq = ((static_cast<uint64_t>(hi[i]) << 32) | l) << (64 - 2 * L);
  const uint64_t guide = words[min(max(gi[i], 0), n_guides - 1)];
  const uint64_t x = seq ^ guide;
  uint64_t m = (x | (x << 1)) & active;
  const int count = __popcll(m);
  uint32_t a = 0, b = 0;
#pragma unroll
  for (int k = 0; k < 2 * kPerWord; ++k) {
    const int z = __clzll(static_cast<long long>(m)) & 63;  // 2p; 64 (m == 0) -> 0
    const uint32_t o = static_cast<uint32_t>((seq << z) >> 62);
    const uint32_t g = static_cast<uint32_t>((guide << z) >> 62);
    const uint32_t d = k < count ? (static_cast<uint32_t>(z >> 1) << 4) | (g << 2) | o : 0u;
    if (k < kPerWord) {
      a |= d << (kDescBits * k);
    } else {
      b |= d << (kDescBits * (k - kPerWord));
    }
    m &= ~(kTop >> z);  // m == 0 stays 0
  }
  a |= static_cast<uint32_t>(min(count, 7)) << kCountShift;
  a |= static_cast<uint32_t>(count > 2 * kPerWord) << kOverflowShift;
  b |= (l & 15u) << kPamShift;  // positions L-2 and L-1: bits 3..0 of lo
  w0[i] = a;
  w1[i] = b;
}

}  // namespace

// lo, hi, gi, w0, w1: (n,) int32; gcodes: (n_guides, L) int8; words:
// (n_guides,) 8-byte scratch for the guide words; all device pointers,
// contiguous. 1 <= n_guides, 2 <= L <= 24, 0 <= act_n <= L. Launches the
// pack kernel, then the descriptor kernel, on `stream`; returns the CUDA
// error code of the launches (0 = success); n <= 0 launches nothing.
extern "C" int ff_descriptors_launch(const void* lo, const void* hi,
                                     const void* gi, const void* gcodes,
                                     void* words, long long n, int n_guides,
                                     int L, int act_n, void* w0, void* w1,
                                     void* stream) {
  if (n <= 0) return 0;
  if (n_guides < 1 || L < 2 || L > kMaxL || act_n < 0 || act_n > L)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (n + kThreads - 1) / kThreads;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // bits 63 - 2p for p < act_n
  const uint64_t active =
      act_n == 0 ? 0 : (~0ull << (64 - 2 * act_n)) & 0xAAAAAAAAAAAAAAAAull;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  pack_kernel<<<(n_guides + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int8_t*>(gcodes), n_guides, L, static_cast<uint64_t*>(words));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  descriptors_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const int*>(gi), static_cast<const uint64_t*>(words), n,
      n_guides, L, active, static_cast<uint32_t*>(w0), static_cast<uint32_t*>(w1));
  return static_cast<int>(cudaGetLastError());
}
