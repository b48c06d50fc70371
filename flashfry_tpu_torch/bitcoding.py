"""2-bit packed target encoding, vectorized over numpy uint64 arrays.

TPU-native re-design of the reference's scalar BitEncoding
(reference: src/main/scala/bitcoding/BitEncoding.scala). Layout is kept
bit-identical so that counts, masks and text output match:

  * a target of <=24 bases occupies the low 48 bits, 2 bits/base, first
    character in the highest occupied pair (BitEncoding.scala:46-67);
  * the occurrence count sits in the high 16 bits (``count << 48``);
  * mismatch counting is XOR -> AND masks -> fold bit pairs -> popcount
    (BitEncoding.scala:127-132).

Everything here operates on numpy arrays (host side). The device-side scan
uses a different, MXU-friendly one-hot representation built from these packed
values (see flashfry_tpu.ops.scan).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple, Union

import numpy as np

from .standards import ParameterPack

ENCODE_A = 0
ENCODE_C = 1
ENCODE_G = 2
ENCODE_T = 3

CHARACTER_MASK = 0x3
STRING_LIMIT = 24

STRING_MASK = np.uint64(0xFFFFFFFFFFFF)
UPPER_BITS = np.uint64(0xAAAAAAAAAAAA)
LOWER_BITS = np.uint64(0x555555555555)

_U0 = np.uint64(0)
_U1 = np.uint64(1)
_U2 = np.uint64(2)
_U3 = np.uint64(3)
_U48 = np.uint64(48)

# byte value -> 2-bit base code; 255 marks a non-ACGT byte
_BASE_LUT = np.full(256, 255, dtype=np.uint8)
for _ch, _code in (("A", ENCODE_A), ("C", ENCODE_C), ("G", ENCODE_G), ("T", ENCODE_T),
                   ("a", ENCODE_A), ("c", ENCODE_C), ("g", ENCODE_G), ("t", ENCODE_T)):
    _BASE_LUT[ord(_ch)] = _code

_CODE_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


def popcount64(x: np.ndarray) -> np.ndarray:
    """SWAR popcount over uint64 arrays (the vectorized stand-in for
    java.lang.Long.bitCount at BitEncoding.scala:130)."""
    x = x.astype(np.uint64, copy=True)
    m1 = np.uint64(0x5555555555555555)
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    h01 = np.uint64(0x0101010101010101)
    with np.errstate(over="ignore"):  # SWAR multiply wraps by design
        x = x - ((x >> _U1) & m1)
        x = (x & m2) + ((x >> _U2) & m2)
        x = (x + (x >> np.uint64(4))) & m4
        return ((x * h01) >> np.uint64(56)).astype(np.int64)


def strings_to_codes(seqs: Sequence[str]) -> np.ndarray:
    """Convert equal-length sequences to a (N, L) uint8 code matrix.

    Raises on non-ACGT characters, mirroring the reference's
    IllegalStateException (BitEncoding.scala:60).
    """
    if len(seqs) == 0:
        return np.zeros((0, 0), dtype=np.uint8)
    length = len(seqs[0])
    joined = "".join(seqs)
    if len(joined) != length * len(seqs):
        raise ValueError("all sequences must have equal length")
    raw = np.frombuffer(joined.encode("ascii"), dtype=np.uint8).reshape(len(seqs), length)
    codes = _BASE_LUT[raw]
    if (codes == 255).any():
        bad = np.argwhere(codes == 255)[0]
        raise ValueError("Unable to encode character %r in %s" % (seqs[bad[0]][bad[1]], seqs[bad[0]]))
    return codes


def codes_to_longs(codes: np.ndarray) -> np.ndarray:
    """Pack a (N, L) base-code matrix into uint64 sequence bits (no count)."""
    n, length = codes.shape
    if length > STRING_LIMIT:
        raise ValueError("String is too long to be encoded (%d > 24)" % length)
    enc = np.zeros(n, dtype=np.uint64)
    for i in range(length):
        enc = (enc << _U2) | codes[:, i].astype(np.uint64)
    return enc


def longs_to_codes(longs: np.ndarray, length: int) -> np.ndarray:
    """Unpack uint64 sequence bits into a (N, L) base-code matrix
    (inverse of codes_to_longs; BitEncoding.scala:85-99)."""
    longs = np.asarray(longs, dtype=np.uint64)
    out = np.empty((longs.shape[0], length), dtype=np.uint8)
    for i in range(length):
        shift = np.uint64(2 * (length - 1 - i))
        out[:, i] = ((longs >> shift) & _U3).astype(np.uint8)
    return out


def codes_to_strings(codes: np.ndarray) -> List[str]:
    return [bytes(_CODE_TO_BASE[row]).decode("ascii") for row in codes]


@dataclass(frozen=True)
class BinAndMask:
    """A bin's shifted long encoding plus its comparison mask
    (BitEncoding.scala:228)."""
    bin: str
    bin_long: np.uint64
    guide_mask: np.uint64


class BitEncoding:
    """Vectorized encoder bound to one enzyme's parameters."""

    def __init__(self, parameter_pack: ParameterPack):
        self.pack = parameter_pack
        self.comparison_mask = np.uint64(parameter_pack.comparison_bit_encoding)

    # ---------------- encode / decode ----------------

    def encode_batch(self, seqs: Sequence[str], counts: Union[int, np.ndarray] = 1) -> np.ndarray:
        """Encode sequences (+counts) into uint64s (BitEncoding.scala:46-67)."""
        codes = strings_to_codes([s.upper() for s in seqs])
        enc = codes_to_longs(codes)
        counts_arr = np.broadcast_to(np.asarray(counts, dtype=np.uint64), enc.shape)
        if (np.asarray(counts, dtype=np.int64) < 1).any():
            raise ValueError("String count has a count <= 0")
        return enc | (counts_arr << _U48)

    def encode(self, seq: str, count: int = 1) -> int:
        return int(self.encode_batch([seq], count)[0])

    def decode_batch(self, longs: np.ndarray, actual_size: int = None) -> Tuple[List[str], np.ndarray]:
        """Decode uint64s back to (sequences, counts) (BitEncoding.scala:85-99)."""
        if actual_size is None:
            actual_size = self.pack.total_scan_length
        longs = np.asarray(longs, dtype=np.uint64)
        counts = (longs >> _U48).astype(np.int64)
        codes = longs_to_codes(longs & STRING_MASK, actual_size)
        return codes_to_strings(codes), counts

    def decode(self, encoding: int, actual_size: int = None) -> Tuple[str, int]:
        seqs, counts = self.decode_batch(np.array([encoding], dtype=np.uint64), actual_size)
        return seqs[0], int(counts[0])

    @staticmethod
    def update_count(encoded: np.ndarray, count) -> np.ndarray:
        """Replace the count bits (BitEncoding.scala:108-111)."""
        encoded = np.asarray(encoded, dtype=np.uint64)
        return (encoded & STRING_MASK) | (np.asarray(count, dtype=np.uint64) << _U48)

    @staticmethod
    def get_count(encoded) -> np.ndarray:
        """Read the count bits (BitEncoding.scala:114)."""
        return (np.asarray(encoded, dtype=np.uint64) >> _U48).astype(np.int64)

    # ---------------- comparisons ----------------

    def mismatches(self, enc1, enc2, additional_mask=STRING_MASK) -> np.ndarray:
        """Vectorized XOR + masked fold + popcount mismatch counting
        (BitEncoding.scala:127-132). Broadcasts enc1 against enc2.

        Large equal-shape pairs route through the native popcount kernel
        (one uint8 output allocation instead of the numpy chain's ~9
        full-size temporaries — fresh pages fault at 20-60 MB/s in this
        sandbox, so the alloc count IS the runtime; measured 13 s -> 0.2 s
        at 18M pairs). Result dtype is int64 (numpy path) or uint8 (native
        path); every caller treats it as small non-negative ints."""
        a = np.asarray(enc1, dtype=np.uint64)
        b = np.asarray(enc2, dtype=np.uint64)
        if (a.ndim == 1 and a.shape == b.shape and a.shape[0] > (1 << 16)):
            from . import native as _native
            r = _native.mismatch_counts(
                a, b, mask=int(np.uint64(additional_mask) & self.comparison_mask))
            if r is not None:
                return r
        first = (a ^ b) & np.uint64(additional_mask) & self.comparison_mask
        return popcount64((first & UPPER_BITS) | ((first << _U1) & UPPER_BITS))

    def mismatches_indexed(self, a: np.ndarray, b_small: np.ndarray,
                           gi: np.ndarray,
                           additional_mask=STRING_MASK) -> np.ndarray:
        """mismatches(a, b_small[gi]) without materializing the gather
        (native kernel indexes b in place; numpy fallback gathers)."""
        a = np.asarray(a, dtype=np.uint64)
        b_small = np.asarray(b_small, dtype=np.uint64)
        from . import native as _native
        r = _native.mismatch_counts(
            a, b_small, gi=gi,
            mask=int(np.uint64(additional_mask) & self.comparison_mask))
        if r is not None:
            return r
        return self.mismatches(a, b_small[np.asarray(gi, dtype=np.int64)],
                               additional_mask)

    def mismatches_cross(self, guides: np.ndarray, targets: np.ndarray,
                         additional_mask=STRING_MASK) -> np.ndarray:
        """(G, T) mismatch-count matrix: every guide against every target.

        Host-side (numpy) reference for the TPU scan kernel. Computed in row
        blocks with in-place ops and two reusable scratch buffers — fresh
        multi-hundred-MB temporaries are pathologically slow in sandboxed
        environments with expensive first-touch page faults.
        """
        a = np.asarray(guides, dtype=np.uint64)
        b = np.asarray(targets, dtype=np.uint64)
        n, m = a.shape[0], b.shape[0]
        mask = np.uint64(additional_mask) & self.comparison_mask
        out = np.empty((n, m), dtype=np.int8)
        block = max(1, min(n, (1 << 22) // max(m, 1) + 1))
        x = np.empty((block, m), dtype=np.uint64)
        s = np.empty((block, m), dtype=np.uint64)
        m1 = np.uint64(0x5555555555555555)
        m2 = np.uint64(0x3333333333333333)
        m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
        h01 = np.uint64(0x0101010101010101)
        with np.errstate(over="ignore"):
            for lo in range(0, n, block):
                hi = min(n, lo + block)
                xv, sv = x[: hi - lo], s[: hi - lo]
                np.bitwise_xor(a[lo:hi, None], b[None, :], out=xv)
                xv &= mask
                # fold 2-bit pairs to single bits at even positions
                np.right_shift(xv, _U1, out=sv)
                sv |= xv
                sv &= LOWER_BITS
                # SWAR popcount, in place
                np.right_shift(sv, _U1, out=xv)
                xv &= m1
                sv -= xv
                np.right_shift(sv, _U2, out=xv)
                xv &= m2
                sv &= m2
                sv += xv
                np.right_shift(sv, np.uint64(4), out=xv)
                sv += xv
                sv &= m4
                sv *= h01
                np.right_shift(sv, np.uint64(56), out=sv)
                out[lo:hi] = sv
        return out

    def mismatch_bin(self, bin_and_mask: BinAndMask, guides) -> np.ndarray:
        """Mismatches between a bin prefix and guides (BitEncoding.scala:142-144)."""
        g = np.asarray(guides, dtype=np.uint64)
        return self.mismatches(bin_and_mask.bin_long, g & bin_and_mask.guide_mask)

    def bin_to_long_comparator(self, bin_seq: str, right_shift_bases: int = 0) -> BinAndMask:
        """Build a shifted bin encoding + mask (BitEncoding.scala:153-157)."""
        bin_long = self.bin_shift(len(bin_seq), np.uint64(self.encode(bin_seq)), right_shift_bases)
        return BinAndMask(bin_seq, bin_long, self.comp_bitmask_for_bin(len(bin_seq), right_shift_bases))

    def comp_bitmask_for_bin(self, bin_size: int, right_shift_bases: int = 0) -> np.uint64:
        """Mask covering a bin's base positions (BitEncoding.scala:167-170)."""
        base = STRING_MASK >> np.uint64(48 - bin_size * 2)
        return self.bin_shift(bin_size, base, right_shift_bases)

    def bin_shift(self, bin_size: int, base: np.uint64, right_shift_bases: int = 0) -> np.uint64:
        """Shift a right-justified bin pattern into comparison position
        (BitEncoding.scala:179-185). For 5' PAM enzymes the bin sits after
        the PAM."""
        p = self.pack
        if p.five_prime_pam:
            shift = 2 * (p.total_scan_length - (bin_size + p.pam_length + right_shift_bases))
        else:
            shift = 2 * (p.total_scan_length - (bin_size + right_shift_bases))
        if shift < 0:
            raise ValueError("bin too wide for scan length")
        return (np.uint64(base) << np.uint64(shift)) & STRING_MASK

    # ---------------- bin keys ----------------

    def bin_index_of_targets(self, target_longs: np.ndarray, bin_width: int) -> np.ndarray:
        """For packed targets, the integer index of their length-``bin_width``
        prefix bin (the first ``bin_width`` bases after the PAM for 5'-PAM
        enzymes; BinWriter.scala:58-64). Bins are numbered lexicographically
        (A=0 < C < G < T), matching BaseCombinationGenerator order."""
        p = self.pack
        longs = np.asarray(target_longs, dtype=np.uint64) & STRING_MASK
        if p.five_prime_pam:
            start = p.pam_length
        else:
            start = 0
        # bases [start, start+bin_width) live at bit offset
        # 2*(L-1-i) for base i; the prefix as an integer is just a shift+mask.
        shift = np.uint64(2 * (p.total_scan_length - (start + bin_width)))
        return ((longs >> shift) & np.uint64((1 << (2 * bin_width)) - 1)).astype(np.int64)


def bin_index_to_string(idx: int, width: int) -> str:
    """Inverse of bin numbering: lexicographic index -> base string."""
    out = []
    for i in range(width):
        out.append("ACGT"[(idx >> (2 * (width - 1 - i))) & 0x3])
    return "".join(out)


def all_bins(width: int) -> List[str]:
    """Lexicographic k-mer enumeration, AAAA..->TTTT..
    (utils/BaseCombinationGenerator.scala)."""
    return [bin_index_to_string(i, width) for i in range(4 ** width)]
