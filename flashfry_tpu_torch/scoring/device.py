"""Device-side mismatch-descriptor extraction for off-target scoring.

Counterpart of flashfry_tpu/scoring/device.py (`_desc_jit`, which the JAX
package leaves to XLA to fuse into one device pass). The card does all the
integer work of off-target scoring: decode the packed 2-bit sequences,
compare each off-target against its guide at the enzyme's active positions,
and compact the mismatch descriptors (position, guide base, off-target
base) plus the PAM dinucleotide into two int32 words per off-target. The
host turns descriptors into scores with O(#mismatches) exact f64 table
gathers in the numpy oracle's multiplication order (scoring/otbatch.py), so
the formatted output keeps its last ulp whatever the device. Traffic is
12 B per off-target up (packed words + guide index) and 8 B down.

Word layout (consumed by otbatch.unpack_descriptors):
  w0: d0|d1|d2 (9 bits each: pos<<4|g<<2|o, ascending position) |
      min(mmc,7) (3 bits @27) | overflow=mmc>6 (bit 30)
  w1: d3|d4|d5 | PAM dinucleotide code (4 bits @27)

`descriptors` is the wrapper: CPU tensors go to the plain PyTorch version
`descriptors_plain`; CUDA tensors launch the hand-written kernel of
`csrc/descriptors.cu` or raise. The kernel runs one thread per off-target
and no per-position loop: it XORs the packed off-target with its guide's
packed word (built on the card from gcodes, into scratch this wrapper
allocates), collapses each 2-bit difference to one bit, counts the bits
and walks at most six of them from the first position; its header says
what bounds it on Hopper. `descriptors.launches` counts wrapper calls that
launch it. `extract_descriptors` is the host entry point the score batch
calls.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import numpy as np
import torch

from ..bitcoding import STRING_MASK
from ..ops.scan import split_words

MAX_L = 24  # 2-bit bases of one sequence: 32 in the low word, 16 in the high


def guide_codes(glongs: np.ndarray, L: int) -> np.ndarray:
    """Packed guide longs -> (G, L) int8 base codes, position 0 first."""
    seq = np.asarray(glongs, dtype=np.uint64) & STRING_MASK
    gcodes = np.empty((seq.shape[0], L), dtype=np.int8)
    for p in range(L):
        gcodes[:, p] = ((seq >> np.uint64(2 * (L - 1 - p))) & np.uint64(3)
                        ).astype(np.int8)
    return gcodes


def descriptors_plain(lo: torch.Tensor, hi: torch.Tensor, gi: torch.Tensor,
                      gcodes: torch.Tensor, act_n: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch descriptor pass on any device: lo/hi (N,) int32 packed
    sequence halves, gi (N,) int32 guide index, gcodes (G, L) int8 guide
    base codes -> (w0, w1) int32 (N,), over active positions 0..act_n-1."""
    L = gcodes.shape[1]
    gsel = gcodes.index_select(0, gi)                        # (N, L) int8
    zero = torch.zeros_like(lo)
    w0, w1, c = zero, zero, zero
    for p in range(act_n):
        s = 2 * (L - 1 - p)  # bases never straddle the 32-bit split
        w = lo if s < 32 else hi
        # >> on int32 is arithmetic; & 3 after it is right for shifts <= 30
        o = (w >> (s % 32)) & 3
        g = gsel[:, p].to(torch.int32)
        m = o != g
        d = (p << 4) | (g << 2) | o
        in0 = m & (c < 3)
        in1 = m & (c >= 3) & (c < 6)
        # shift amounts clamped to the selected range: where() computes both
        # branches, and the unselected lanes' shifts would pass the int32 width
        sh0 = 9 * c.clamp(max=2)
        sh1 = 9 * (c - 3).clamp(0, 2)
        w0 = w0 | torch.where(in0, d << sh0, zero)
        w1 = w1 | torch.where(in1, d << sh1, zero)
        c = c + m.to(torch.int32)
    w0 = w0 | (c.clamp(max=7) << 27) | ((c > 6).to(torch.int32) << 30)
    # PAM dinucleotide: positions L-2, L-1 live in the low word
    pam = (((lo >> 2) & 3) << 2) | (lo & 3)
    return w0, w1 | (pam << 27)


def check_inputs(lo: torch.Tensor, hi: torch.Tensor, gi: torch.Tensor,
                 gcodes: torch.Tensor, act_n: int) -> None:
    """Raise on what the descriptor pass does not take: lo, hi, gi (N,)
    int32 and gcodes (G >= 1, L <= 24) int8, all contiguous and on one
    device (the CPU or a CUDA card), 0 <= act_n <= L."""
    for name, t in (("lo", lo), ("hi", hi), ("gi", gi)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != lo.shape:
            raise TypeError("descriptors takes %s as (N,) int32, got %s %s"
                            % (name, tuple(t.shape), t.dtype))
    if gcodes.dtype != torch.int8 or gcodes.dim() != 2:
        raise TypeError("descriptors takes gcodes as (G, L) int8, got %s %s"
                        % (tuple(gcodes.shape), gcodes.dtype))
    G, L = gcodes.shape
    if G < 1 or not 2 <= L <= MAX_L or not 0 <= act_n <= L:
        raise ValueError("descriptors takes G >= 1, 2 <= L <= %d and 0 <= "
                         "act_n <= L, got G=%d, L=%d, act_n=%d"
                         % (MAX_L, G, L, act_n))
    tensors = (lo, hi, gi, gcodes)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("descriptors takes contiguous tensors")
    if any(t.device != lo.device for t in tensors):
        raise ValueError("descriptors takes all tensors on one device, got %s"
                         % ", ".join(str(t.device) for t in tensors))
    if lo.device.type not in ("cpu", "cuda"):
        raise ValueError("descriptors runs on cpu or cuda, not %s" % lo.device)


def descriptors(lo: torch.Tensor, hi: torch.Tensor, gi: torch.Tensor,
                gcodes: torch.Tensor, act_n: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """lo/hi/gi (N,) int32, gcodes (G, L) int8 -> (w0, w1) int32 (N,).

    CPU tensors run descriptors_plain. CUDA tensors launch the kernel of
    csrc/descriptors.cu on the current stream (counted in
    descriptors.launches); a failed build or launch raises. Every gi must
    lie in [0, G): the plain version raises on one that does not, the
    kernel reads guide G-1 (or 0) for it and never outside gcodes.
    N = 0 returns empty tensors without a launch."""
    check_inputs(lo, hi, gi, gcodes, act_n)
    if lo.device.type == "cpu":
        return descriptors_plain(lo, hi, gi, gcodes, act_n)
    n = lo.shape[0]
    w0, w1 = torch.empty_like(lo), torch.empty_like(lo)
    if n == 0:
        return w0, w1
    from ..ops._build import descriptors_library
    fn = descriptors_library().ff_descriptors_launch
    p = ctypes.c_void_p
    # scratch for the packed guide words the launcher builds first
    words = torch.empty(gcodes.shape[0], dtype=torch.int64, device=lo.device)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        err = fn(p(lo.data_ptr()), p(hi.data_ptr()), p(gi.data_ptr()),
                 p(gcodes.data_ptr()), p(words.data_ptr()), n, gcodes.shape[0],
                 gcodes.shape[1], int(act_n), p(w0.data_ptr()), p(w1.data_ptr()),
                 p(stream))
    if err != 0:
        raise RuntimeError("ff_descriptors_launch failed: cudaError %d" % err)
    descriptors.launches += 1
    return w0, w1


descriptors.launches = 0


def extract_descriptors(flat: np.ndarray, gi: np.ndarray, glongs: np.ndarray,
                        L: int, act_pos: np.ndarray,
                        device: Union[str, torch.device]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Run the descriptor pass on `device`; returns host (w0, w1) int32[N].
    act_pos must be the contiguous guide region 0..act_n-1 (true for every
    cas9 pack: the comparison mask excludes exactly the 3 trailing PAM
    bases), and every gi an index into glongs."""
    act_pos = np.asarray(act_pos)
    if not (act_pos == np.arange(act_pos.shape[0])).all():
        raise ValueError("the descriptor pass takes a contiguous leading "
                         "active region, got positions %s" % act_pos.tolist())
    n = int(flat.shape[0])
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    gi32 = np.ascontiguousarray(gi, dtype=np.int32)
    G = int(np.asarray(glongs).shape[0])
    if int(gi32.min()) < 0 or int(gi32.max()) >= G:
        raise ValueError("guide index outside [0, %d)" % G)
    lo, hi = split_words(flat)
    dev = torch.device(device)
    w0, w1 = descriptors(*(torch.from_numpy(a).to(dev) for a in
                           (lo, hi, gi32, guide_codes(glongs, L))),
                         int(act_pos.shape[0]))
    return w0.cpu().numpy(), w1.cpu().numpy()
