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
// written per off-target, against a few hundred integer instructions. The
// guide codes (G x L bytes, tens of KB) are read from L1/L2. As written the
// kernel is bound by instruction issue instead: on an H100 80GB HBM3 at 700 W
// it takes 0.41 ms for 2^24 off-targets where the bytes need 0.10 ms, with the
// off-targets grouped by guide or in random order alike. A thread takes the
// mismatch branch only a few times, but a warp takes it at every position
// where any of its 32 off-targets mismatches, which is nearly every position.
//
// Design. The simple one: one thread per off-target, 256 threads a block,
// loads and stores coalesced over i; the descriptor words are built in
// registers and nothing else touches device memory. Words are unsigned so
// every shift is logical. A guide index outside [0, G) is clamped into it, so
// no thread reads outside gcodes; the caller rejects such an index before the
// launch. A faster form would XOR the packed guide and off-target words and
// walk only the set bits; the score command launches this kernel once per
// run, on as many off-targets as discover found, so it has not been needed.

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

__global__ void __launch_bounds__(kThreads)
descriptors_kernel(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
                   const int* __restrict__ gi, const int8_t* __restrict__ gcodes,
                   long long n, int n_guides, int L, int act_n,
                   uint32_t* __restrict__ w0, uint32_t* __restrict__ w1) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t l = lo[i];
  const uint32_t h = hi[i];
  const int g_row = min(max(gi[i], 0), n_guides - 1);
  const int8_t* __restrict__ guide = gcodes + static_cast<long long>(g_row) * L;
  uint32_t a = 0, b = 0;
  int count = 0;
  for (int p = 0; p < act_n; ++p) {
    const int s = 2 * (L - 1 - p);  // a base never straddles the 32-bit split
    const uint32_t o = ((s < 32 ? l >> s : h >> (s - 32))) & 3u;
    const uint32_t g = static_cast<uint32_t>(__ldg(guide + p)) & 3u;
    if (o != g) {
      const uint32_t d = (static_cast<uint32_t>(p) << 4) | (g << 2) | o;
      if (count < kPerWord) {
        a |= d << (kDescBits * count);
      } else if (count < 2 * kPerWord) {
        b |= d << (kDescBits * (count - kPerWord));
      }
      ++count;
    }
  }
  a |= static_cast<uint32_t>(min(count, 7)) << kCountShift;
  a |= static_cast<uint32_t>(count > 2 * kPerWord) << kOverflowShift;
  b |= (l & 15u) << kPamShift;  // positions L-2 and L-1: bits 3..0 of lo
  w0[i] = a;
  w1[i] = b;
}

}  // namespace

// lo, hi, gi, w0, w1: (n,) int32; gcodes: (n_guides, L) int8; all device
// pointers, contiguous. 1 <= n_guides, 2 <= L <= 24, 0 <= act_n <= L. Returns
// the CUDA error code of the launch (0 = success); n <= 0 launches nothing.
extern "C" int ff_descriptors_launch(const void* lo, const void* hi,
                                     const void* gi, const void* gcodes,
                                     long long n, int n_guides, int L, int act_n,
                                     void* w0, void* w1, void* stream) {
  if (n <= 0) return 0;
  if (n_guides < 1 || L < 2 || L > kMaxL || act_n < 0 || act_n > L)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (n + kThreads - 1) / kThreads;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  descriptors_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const int*>(gi), static_cast<const int8_t*>(gcodes), n,
      n_guides, L, act_n, static_cast<uint32_t*>(w0), static_cast<uint32_t*>(w1));
  return static_cast<int>(cudaGetLastError());
}
