"""Vectorized CRISPR site discovery over FASTA contigs.

Re-designs the reference's regex scanner (reference:
src/main/scala/reference/ReferenceEncoder.scala:104-175 `SimpleSiteFinder`)
as numpy array ops: the lookahead regexes become fixed-offset base tests over
a code array, which finds the same (overlapping) site set.

Pattern semantics replicated exactly:
  * every base in the scan window must be one of ACGT (the reference regexes
    only admit [ACGTacgt]; N-containing windows are dropped);
  * forward patterns test PAM bases at fixed window offsets
    (e.g. spcas9ngg fwd = window[21:23] == "GG",
     StandardScanParameters.scala:148);
  * reverse-strand sites are reported as the reverse complement of the
    window, at the window's start coordinate (ReferenceEncoder.scala:145-163);
  * per contig, all forward sites are emitted (ascending position) and then
    all reverse sites (ascending position) — ReferenceEncoder.scala:121-164;
  * context = window +/- flank, captured only when the full width is
    available (ReferenceEncoder.scala:126-136).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import native
from .bitcoding import _BASE_LUT, codes_to_longs, codes_to_strings
from .positions import BitPosition
from .standards import ParameterPack


def _pam_window_patterns(pack: ParameterPack) -> Tuple[List[str], List[str]]:
    """Expand a parameter pack into (fwd, rev) full-window patterns over
    {A,C,G,T,N}, N meaning any of ACGT.

    These reproduce the reference's regexes (StandardScanParameters.scala):
      spcas9      fwd .{21}[AG]G        rev C[CT].{21}
      spcas9ngg   fwd .{21}GG           rev CC.{21}
      spcas9nag   fwd .{21}AG           rev CT.{21}
      (19bp packs: same with one fewer leading N)
      cpf1        fwd TTT.{21}          rev .{21}AAA
    """
    L = pack.total_scan_length
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    fwd, rev = [], []
    for pam in pack.pam:
        if pack.five_prime_pam:
            pat = pam + "N" * (L - len(pam))
        else:
            pat = "N" * (L - len(pam)) + pam
        fwd.append(pat)
        # reverse pattern: reverse complement of the forward pattern
        rev.append("".join(comp[c] for c in reversed(pat)))
    return fwd, rev


@dataclass
class DiscoveredSites:
    """Columnar site set for one FASTA scan."""

    pack: ParameterPack
    bit_position: BitPosition
    contig_ids: np.ndarray      # int32[N], 1-based ids matching bit_position
    positions: np.ndarray       # int32[N] window start within contig
    forward: np.ndarray         # bool[N]
    sequences: np.ndarray       # uint64[N] packed bases (count == 1)
    contexts: Optional[List[Optional[str]]] = None  # only when flank capture requested
    bases_list: Optional[List[str]] = None

    def __len__(self) -> int:
        return int(self.contig_ids.shape[0])

    @property
    def contig_names(self) -> List[str]:
        return self.bit_position.contig_names_in_order

    def bases(self) -> List[str]:
        if self.bases_list is None:
            from .bitcoding import longs_to_codes
            codes = longs_to_codes(self.sequences & np.uint64(0xFFFFFFFFFFFF),
                                   self.pack.total_scan_length)
            self.bases_list = codes_to_strings(codes)
        return self.bases_list

    def position_longs(self) -> np.ndarray:
        """Packed genomic positions for every site (BitPosition layout)."""
        return BitPosition.encode_batch(
            self.contig_ids.astype(np.uint64),
            self.positions.astype(np.uint64),
            np.full(len(self), self.pack.total_scan_length, dtype=np.uint64),
            self.forward,
        )


def _scan_codes(codes: np.ndarray, patterns: Sequence[str], L: int) -> np.ndarray:
    """Return sorted start indices where any pattern matches and the whole
    window is ACGT-only. Uses the native C++ scanner when available
    (native/flashfry_native.cpp), else vectorized numpy."""
    n = codes.shape[0]
    if n < L:
        return np.zeros(0, dtype=np.int64)
    hits = native.scan_sites(codes, patterns, L)
    if hits is not None:
        return hits
    return _scan_codes_numpy(codes, patterns, L)


def _scan_codes_numpy(codes: np.ndarray, patterns: Sequence[str], L: int) -> np.ndarray:
    """Pure-numpy reference scanner (fallback + parity oracle for the native
    path)."""
    n = codes.shape[0]
    if n < L:
        return np.zeros(0, dtype=np.int64)
    invalid = (codes == 255).astype(np.int32)
    cum = np.concatenate([[0], np.cumsum(invalid)])
    window_ok = (cum[L:] - cum[:-L]) == 0  # shape n-L+1

    any_match = np.zeros(n - L + 1, dtype=bool)
    code_of = {"A": 0, "C": 1, "G": 2, "T": 3}
    for pat in patterns:
        m = window_ok.copy()
        for off, ch in enumerate(pat):
            if ch == "N":
                continue
            m &= codes[off: off + n - L + 1] == code_of[ch]
        any_match |= m
    return np.nonzero(any_match)[0]


def _extract_windows(codes: np.ndarray, starts: np.ndarray, L: int) -> np.ndarray:
    if starts.size == 0:
        return np.zeros((0, L), dtype=np.uint8)
    return codes[starts[:, None] + np.arange(L)[None, :]]


def _pack_from_starts(codes: np.ndarray, starts: np.ndarray, L: int,
                      reverse_complement: bool) -> np.ndarray:
    """Pack windows straight from start offsets into uint64 sequence bits,
    avoiding the (N, L) window materialization when the native library is up."""
    packed = native.pack_windows(codes, starts, L, reverse_complement)
    if packed is not None:
        return packed
    windows = _extract_windows(codes, starts.astype(np.int64), L)
    if reverse_complement:
        windows = (3 - windows)[:, ::-1]
    return codes_to_longs(windows)


def scan_contig(sequence_codes: np.ndarray, pack: ParameterPack):
    """Scan one contig's code array; returns (fwd_starts, rev_starts)."""
    fwd_pats, rev_pats = _pam_window_patterns(pack)
    L = pack.total_scan_length
    fwd = _scan_codes(sequence_codes, fwd_pats, L)
    rev = _scan_codes(sequence_codes, rev_pats, L)
    return fwd, rev


FUSED_SCAN_MIN_CONTIGS = 64


def find_target_sites(fasta_iter, pack: ParameterPack,
                      flanking_sequence: int = 0,
                      capture_context: bool = False) -> DiscoveredSites:
    """Scan contigs for candidate sites.

    fasta_iter yields (contig_name, uppercase sequence string) — use
    utils.iterate_fasta. Site emission order matches the reference: per
    contig, forward sites ascending then reverse sites ascending
    (ReferenceEncoder.scala:121-164).

    Many-record inputs (guide libraries: 10^5 tiny FASTA records) take a
    fused path — one scan over all contigs joined with (L-1)-base N gaps
    (N-containing windows are dropped by the pattern semantics, so no
    cross-contig window can match) — instead of paying per-contig numpy
    fixed costs. A differential test pins it to the per-contig path.
    """
    contigs = list(fasta_iter)
    if len(contigs) >= FUSED_SCAN_MIN_CONTIGS:
        return _find_target_sites_fused(contigs, pack, flanking_sequence,
                                        capture_context)
    return _find_target_sites_percontig(contigs, pack, flanking_sequence,
                                        capture_context)


def _find_target_sites_fused(contigs, pack: ParameterPack,
                             flanking_sequence: int = 0,
                             capture_context: bool = False) -> DiscoveredSites:
    """One scan over all contigs joined with (L-1)-byte \\x00 gaps.

    \\x00 codes to 255 (invalid) so any window touching a gap is dropped by
    the ACGT-only window rule — exactly the per-contig semantics, without the
    per-record numpy fixed costs. Hits are mapped back to (contig, local
    position) and re-emitted in the reference's order: per contig, forward
    ascending then reverse ascending (ReferenceEncoder.scala:121-164).
    """
    L = pack.total_scan_length
    gap = L - 1
    bitpos = BitPosition()

    names: List[str] = []
    parts: List[bytes] = []
    for name, seq in contigs:
        bitpos.add_reference(name)
        names.append(name)
        parts.append(bytes(seq) if isinstance(seq, (bytes, bytearray, memoryview))
                     else seq.encode("ascii"))
    lengths = np.array([len(p) for p in parts], dtype=np.int64)
    raw = np.frombuffer((b"\x00" * gap).join(parts), dtype=np.uint8)
    codes = _BASE_LUT[raw]

    # contig i occupies fused [offsets[i], offsets[i] + lengths[i])
    offsets = np.zeros(len(parts), dtype=np.int64)
    if len(parts) > 1:
        offsets[1:] = np.cumsum(lengths[:-1] + gap)
    cids = np.array([bitpos.contig_map[n] for n in names], dtype=np.int64)

    fwd_pats, rev_pats = _pam_window_patterns(pack)
    fwd_g = _scan_codes(codes, fwd_pats, L)
    rev_g = _scan_codes(codes, rev_pats, L)
    n_f, n_r = fwd_g.size, rev_g.size

    starts_g = np.concatenate([fwd_g, rev_g])
    cidx = np.searchsorted(offsets, starts_g, side="right") - 1
    local = starts_g - offsets[cidx]
    strand = np.concatenate([np.zeros(n_f, dtype=np.int8),
                             np.ones(n_r, dtype=np.int8)])

    count_one = np.uint64(1) << np.uint64(48)
    longs = np.concatenate([
        _pack_from_starts(codes, fwd_g, L, False),
        _pack_from_starts(codes, rev_g, L, True),
    ]) | count_one

    # reference emission order: (contig, strand fwd-first, position)
    order = np.lexsort((local, strand, cidx))

    contexts: Optional[List[Optional[str]]] = None
    bases_accum: Optional[List[str]] = None
    if capture_context:
        windows = _extract_windows(codes, fwd_g.astype(np.int64), L)
        rev_windows = _extract_windows(codes, rev_g.astype(np.int64), L)
        rev_windows = (3 - rev_windows)[:, ::-1]
        bases_pre = codes_to_strings(windows) + codes_to_strings(rev_windows)
        bases_accum = [bases_pre[i] for i in order]

        flank = flanking_sequence
        full = L + 2 * flank
        valid = (local >= flank) & (local + L + flank <= lengths[cidx])
        ctx_pre: List[Optional[str]] = [None] * starts_g.size
        vidx = np.nonzero(valid)[0]
        if vidx.size:
            ctx_rows = raw[(starts_g[vidx] - flank)[:, None]
                           + np.arange(full)[None, :]]
            blob = ctx_rows.tobytes().decode("ascii")
            from .utils import reverse_comp_string
            for k, i in enumerate(vidx):
                ctx = blob[k * full: (k + 1) * full]
                ctx_pre[i] = ctx if strand[i] == 0 else reverse_comp_string(ctx)
        contexts = [ctx_pre[i] for i in order]

    return DiscoveredSites(
        pack=pack,
        bit_position=bitpos,
        contig_ids=cids[cidx][order],
        positions=local[order],
        forward=(strand == 0)[order],
        sequences=longs[order],
        contexts=contexts,
        bases_list=bases_accum,
    )


def _find_target_sites_percontig(fasta_iter, pack: ParameterPack,
                                 flanking_sequence: int = 0,
                                 capture_context: bool = False) -> DiscoveredSites:
    """Per-contig scan + SINGLE-WRITE columnar assembly.

    The round-4 version built per-strand intermediates (np.full contig ids,
    .astype position copies) and finished with concatenate().astype() —
    at hg38 scale that was ~10 s of pure copies per 300 Mbp (cProfile,
    round-5). Each output column is now written exactly once into a
    preallocated array; contig ids are run-length expanded at the end.

    Contigs may be str OR bytes-like (ASCII): the index phase passes raw
    bytes so the 3 GB genome never round-trips through a Python str."""
    L = pack.total_scan_length
    bitpos = BitPosition()
    count_one = np.uint64(1) << np.uint64(48)

    longs_parts: List[np.ndarray] = []
    pos_parts: List[np.ndarray] = []
    runs: List[Tuple[int, int, int]] = []  # (cid, n_fwd, n_rev) per contig
    contexts: List[Optional[str]] = []
    bases_accum: List[str] = []

    for name, seq in fasta_iter:
        bitpos.add_reference(name)
        cid = bitpos.contig_map[name]
        if isinstance(seq, (bytes, bytearray, memoryview)):
            raw = np.frombuffer(seq, dtype=np.uint8)
        else:
            raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        codes = _BASE_LUT[raw]
        fwd_starts, rev_starts = scan_contig(codes, pack)

        # pack straight from offsets (reverse strand as reverse complement)
        longs_parts.append(_pack_from_starts(codes, fwd_starts, L, False))
        longs_parts.append(_pack_from_starts(codes, rev_starts, L, True))
        pos_parts.append(np.asarray(fwd_starts, dtype=np.int64))
        pos_parts.append(np.asarray(rev_starts, dtype=np.int64))
        runs.append((cid, int(fwd_starts.size), int(rev_starts.size)))

        if capture_context:
            fwd_windows = _extract_windows(codes, fwd_starts.astype(np.int64), L)
            rev_windows = _extract_windows(codes, rev_starts.astype(np.int64), L)
            rev_windows = (3 - rev_windows)[:, ::-1]
            bases_accum.extend(codes_to_strings(fwd_windows))
            bases_accum.extend(codes_to_strings(rev_windows))
            full = L + 2 * flanking_sequence
            from .utils import reverse_comp_string

            def ctx_str(start):
                lo = max(0, int(start) - flanking_sequence)
                ctx = seq[lo: int(start) + L + flanking_sequence]
                if isinstance(ctx, (bytes, bytearray, memoryview)):
                    ctx = bytes(ctx).decode("ascii")
                return ctx if len(ctx) == full else None

            for start in fwd_starts:
                contexts.append(ctx_str(start))
            for start in rev_starts:
                ctx = ctx_str(start)
                contexts.append(None if ctx is None else reverse_comp_string(ctx))

    total = sum(p.shape[0] for p in pos_parts)
    sequences = np.empty(total, dtype=np.uint64)
    positions = np.empty(total, dtype=np.int64)
    forward = np.empty(total, dtype=bool)
    contig_ids = np.empty(total, dtype=np.int64)
    o = 0
    for i, (cid, n_f, n_r) in enumerate(runs):
        for j, n_s in ((2 * i, n_f), (2 * i + 1, n_r)):
            np.bitwise_or(longs_parts[j], count_one, out=sequences[o:o + n_s])
            positions[o:o + n_s] = pos_parts[j]
            forward[o:o + n_s] = (j % 2 == 0)
            contig_ids[o:o + n_s] = cid
            o += n_s

    return DiscoveredSites(
        pack=pack,
        bit_position=bitpos,
        contig_ids=contig_ids,
        positions=positions,
        forward=forward,
        sequences=sequences,
        contexts=contexts if capture_context else None,
        bases_list=bases_accum if capture_context else None,
    )
