"""Tab-delimited output/input — byte-compatible with the reference format.

Mirrors targetio/TabDelimitedHandler.scala: column layout (:38-91), row
rendering (:132-154) and the OT token grammar
``SEQ_count_mismatches<contig:pos^F|...>{score=val!...}`` (CRISPRHit.toOutput,
crispr/CRISPRHit.scala:54-88). The parser accepts our own output (and the
reference's), reconstructing guide + off-target state for the score module.

TPU-first data model: a guide's off-target set is stored **columnar** —
one packed-uint64 array of OT sequences, one CSR array of genomic
coordinates — so scoring and rendering are numpy table operations instead
of per-hit Python loops (the reference walks ArrayBuffer[CRISPRHit]
objects; a JVM does that cheaply, CPython does not). ``OffTargetHit``
objects remain as views / construction records for the parser and tests.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .bitcoding import BitEncoding, STRING_MASK, longs_to_codes, _CODE_TO_BASE
from .javafmt import scala_hashmap_iteration_order
from .positions import BitPosition


def _scala_ordered_score_items(cols: Dict[str, list]) -> List[Tuple[str, list]]:
    """Per-OT score columns in Scala mutable.HashMap iteration order — the
    order CRISPRHit.toOutputScores renders multi-score tokens in
    (CRISPRHit.scala:95-102). Per-hit subsets keep the restriction of this
    order (bucket placement is per-key; only a >12-model map could resize
    and diverge, far beyond the reference's two per-OT models)."""
    if len(cols) <= 1:
        return list(cols.items())
    return [(k, cols[k]) for k in scala_hashmap_iteration_order(list(cols))]

HEADER_COMMENT = "# "
SEP = "\t"
FORWARD = "FWD"
REVERSE = "RVS"
OVERFLOW = "OVERFLOW"
TARGET_OK = "OK"
POSITION_FORWARD = "F"
POSITION_REVERSE = "R"
CONTIG_SEPARATOR = ":"
STRAND_SEPARATOR = "^"
OFF_TARGET_SEPARATOR = ","
WITHIN_OFF_TARGET_SEPARATOR = "_"
POSITION_LIST_FRONT = "<"
POSITION_LIST_BACK = ">"
POSITION_LIST_SEPARATOR = "|"
SCORES_FRONT = "{"
SCORES_BACK = "}"
SCORES_SEPARATOR = "!"
SCORES_PAIRING = "="

DEFAULT_COLUMNS = ["contig", "start", "stop", "target", "context", "overflow", "orientation"]
FINAL_COLUMNS = ["otCount", "offTargets"]
SET_COLUMN_COUNT = 8
MISSING_ANNOTATION = "NA"

_EXTRACT_POSITION_BLOCK = re.compile(r".*\<(.+?)\>.*")
_EXTRACT_SCORE_BLOCK = re.compile(r".*\{(.+?)\}.*")

_EMPTY_U64 = np.zeros(0, dtype=np.uint64)
_ZERO_OFFSETS = np.zeros(1, dtype=np.int64)


@dataclass
class OffTargetHit:
    """One off-target sequence hit (crispr/CRISPRHit.scala) — a view /
    construction record; the canonical store is the guide's columnar
    arrays."""
    sequence: int                       # packed target long (count in high bits)
    coordinates: np.ndarray             # packed position longs
    valid_coordinates: bool = True
    scores: Optional[Dict[str, str]] = None

    @property
    def off_target_count(self) -> int:
        return int(self.coordinates.shape[0])

    def add_score(self, key: str, value: str) -> None:
        if self.scores is None:
            self.scores = {}
        assert key not in self.scores, "Scores already contains " + key
        self.scores[key] = value


class GuideWithOffTargets:
    """A candidate guide plus its collected off-targets
    (crispr/CRISPRSiteOT.scala), stored columnar.

    Off-target columns:
      ot_longs          uint64[n]   packed sequence|count<<48, traversal order
      ot_coords         uint64[P]   concatenated packed genomic positions
      ot_coord_offsets  int64[n+1]  CSR offsets into ot_coords
      ot_valid          bool[n]     validOffTargetCoordinates flags
      ot_score_cols     {name: [str|None]*n}  per-OT score annotations

    ``off_targets`` materializes OffTargetHit views for small-scale use
    (tests, parser round-trips); the hot paths read the arrays directly.
    """

    __slots__ = ("contig", "start", "bases", "forward_strand", "sequence_context",
                 "long_encoding", "overflow_cap", "current_total",
                 "inherited_overflow", "named_annotations",
                 "_arr", "_b_seqs", "_b_coords", "_b_valid", "ot_score_cols")

    def __init__(self, contig: str, start: int, bases: str, forward_strand: bool,
                 sequence_context: Optional[str], long_encoding: int,
                 overflow_cap: int = 2000, current_total: int = 0,
                 inherited_overflow: bool = False):
        self.contig = contig
        self.start = start
        self.bases = bases
        self.forward_strand = forward_strand
        self.sequence_context = sequence_context
        self.long_encoding = long_encoding
        self.overflow_cap = overflow_cap
        self.current_total = current_total
        self.inherited_overflow = inherited_overflow
        self.named_annotations: Dict[str, List[str]] = {}
        self._arr: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = None
        self._b_seqs: Optional[List[int]] = None
        self._b_coords: Optional[List[np.ndarray]] = None
        self._b_valid: Optional[List[bool]] = None
        self.ot_score_cols: Optional[Dict[str, List[Optional[str]]]] = None

    # ---------------- columnar store ----------------

    def set_ots_arrays(self, longs: np.ndarray, coords: np.ndarray,
                       coord_offsets: np.ndarray,
                       valid: Optional[np.ndarray] = None) -> None:
        """Bulk-install the OT set (the scan epilogue's fast path)."""
        if valid is None:
            valid = np.ones(longs.shape[0], dtype=bool)
        self._arr = (np.asarray(longs, dtype=np.uint64),
                     np.asarray(coords, dtype=np.uint64),
                     np.asarray(coord_offsets, dtype=np.int64), valid)
        self._b_seqs = self._b_coords = self._b_valid = None
        self.current_total = int(coord_offsets[-1]) if len(coord_offsets) else 0

    def ot_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(ot_longs, ot_coords, ot_coord_offsets, ot_valid), finalizing any
        pending appends."""
        if self._arr is None:
            if not self._b_seqs:
                self._arr = (_EMPTY_U64, _EMPTY_U64, _ZERO_OFFSETS,
                             np.zeros(0, dtype=bool))
            else:
                longs = np.array(self._b_seqs, dtype=np.uint64)
                sizes = np.fromiter((c.shape[0] for c in self._b_coords),
                                    np.int64, len(self._b_coords))
                offsets = np.zeros(len(sizes) + 1, dtype=np.int64)
                np.cumsum(sizes, out=offsets[1:])
                coords = (np.concatenate(self._b_coords).astype(np.uint64)
                          if offsets[-1] else _EMPTY_U64)
                self._arr = (longs, coords, offsets,
                             np.array(self._b_valid, dtype=bool))
        return self._arr

    @property
    def num_ots(self) -> int:
        if self._arr is not None:
            return int(self._arr[0].shape[0])
        return len(self._b_seqs) if self._b_seqs else 0

    def add_ot(self, hit: OffTargetHit) -> None:
        """CRISPRSiteOT.addOT (:41-46): count the hit's positions."""
        if self._b_seqs is None:
            if self._arr is not None and self._arr[0].shape[0]:
                longs, coords, offsets, valid = self._arr
                self._b_seqs = [int(x) for x in longs]
                self._b_coords = [coords[offsets[i]:offsets[i + 1]]
                                  for i in range(longs.shape[0])]
                self._b_valid = [bool(v) for v in valid]
            else:
                self._b_seqs, self._b_coords, self._b_valid = [], [], []
        self._arr = None
        self._b_seqs.append(int(hit.sequence))
        self._b_coords.append(np.asarray(hit.coordinates, dtype=np.uint64))
        self._b_valid.append(bool(hit.valid_coordinates))
        if hit.scores:
            n = len(self._b_seqs)
            if self.ot_score_cols is None:
                self.ot_score_cols = {}
            for k, v in hit.scores.items():
                col = self.ot_score_cols.setdefault(k, [])
                col.extend([None] * (n - 1 - len(col)))
                col.append(v)
        self.current_total += int(np.asarray(hit.coordinates).shape[0])

    def set_ot_score_col(self, name: str, values: Sequence[Optional[str]]) -> None:
        """Attach one per-OT score column (CRISPRHit.addScore, vectorized)."""
        assert len(values) == self.num_ots
        if self.ot_score_cols is None:
            self.ot_score_cols = {}
        assert name not in self.ot_score_cols, "Scores already contains " + name
        self.ot_score_cols[name] = list(values)

    def _score_dict_for(self, i: int) -> Optional[Dict[str, str]]:
        if not self.ot_score_cols:
            return None
        d = {k: col[i] for k, col in self.ot_score_cols.items()
             if i < len(col) and col[i] is not None}
        return d or None

    @property
    def off_targets(self) -> List[OffTargetHit]:
        """OffTargetHit views (convenience accessor — not for hot paths)."""
        longs, coords, offsets, valid = self.ot_arrays()
        return [OffTargetHit(int(longs[i]), coords[offsets[i]:offsets[i + 1]],
                             bool(valid[i]), self._score_dict_for(i))
                for i in range(longs.shape[0])]

    # ---------------- reference semantics ----------------

    @property
    def full(self) -> bool:
        return self.overflow_cap > 0 and self.current_total >= self.overflow_cap

    @property
    def stop(self) -> int:
        return self.start + len(self.bases)

    def ot_count_total(self) -> int:
        if self._arr is not None:
            return int(self._arr[2][-1])
        return sum(c.shape[0] for c in self._b_coords) if self._b_coords else 0


def write_header(models: Sequence, write_ots: bool) -> str:
    cols = list(DEFAULT_COLUMNS)
    for m in models:
        cols.extend(m.header_columns())
    if write_ots:
        return SEP.join(cols) + SEP + SEP.join(FINAL_COLUMNS) + "\n"
    return SEP.join(cols) + SEP + FINAL_COLUMNS[0] + "\n"


# ---------------------------------------------------------------------------
# rendering (TabDelimitedOutput, TabDelimitedHandler.scala:132-154)
# ---------------------------------------------------------------------------

def _decode_seq_strings(longs: np.ndarray, L: int) -> Tuple[str, int]:
    """Batch-decode packed targets to ONE ascii string of concatenated
    sequences; caller slices [i*L:(i+1)*L]. Orders of magnitude faster than
    per-hit decode() calls."""
    codes = longs_to_codes(np.asarray(longs, dtype=np.uint64) & STRING_MASK, L)
    return bytes(_CODE_TO_BASE[codes].reshape(-1)).decode("ascii"), L


def render_ot_tokens(guides: Sequence[GuideWithOffTargets],
                     bit_encoding: BitEncoding, pos_enc: BitPosition,
                     write_positions: bool) -> List[str]:
    """The comma-joined off-target token string for every guide
    (CRISPRHit.toOutput semantics, crispr/CRISPRHit.scala:54-88).

    Rendered by the native tokenizer when available (~50x the Python
    renderer at the 2M-token workload), else by batched numpy decodes over
    the concatenated columnar OT arrays."""
    n_guides = len(guides)
    if n_guides == 0:
        return []
    arrs = [g.ot_arrays() for g in guides]
    n_per = np.fromiter((a[0].shape[0] for a in arrs), np.int64, n_guides)
    total = int(n_per.sum())
    if total == 0:
        return [""] * n_guides
    hit_start = np.zeros(n_guides + 1, dtype=np.int64)
    np.cumsum(n_per, out=hit_start[1:])

    native_out = _render_native(guides, arrs, hit_start, bit_encoding, pos_enc,
                                write_positions)
    if native_out is not None:
        buf, _, guide_out = native_out
        return [buf[guide_out[i]:guide_out[i + 1]].tobytes().decode("ascii")
                for i in range(n_guides)]

    all_longs = np.concatenate([a[0] for a in arrs])
    guide_longs = np.fromiter((g.long_encoding for g in guides), np.uint64, n_guides)
    mm = bit_encoding.mismatches(np.repeat(guide_longs, n_per), all_longs)
    counts = (all_longs >> np.uint64(48)).astype(np.int64)

    L = bit_encoding.pack.total_scan_length
    big, _ = _decode_seq_strings(all_longs, L)
    cnt_l = counts.tolist()
    mm_l = mm.tolist()
    toks = ["%s_%d_%d" % (big[i * L:(i + 1) * L], c, m)
            for i, (c, m) in enumerate(zip(cnt_l, mm_l))]

    if write_positions:
        valid = np.concatenate([a[3] for a in arrs])
        coffs_local = [a[2] for a in arrs]
        csizes = np.concatenate([np.diff(o) for o in coffs_local])
        coords = np.concatenate([a[1] for a in arrs]) if csizes.sum() else _EMPTY_U64
        coff = np.zeros(total + 1, dtype=np.int64)
        np.cumsum(csizes, out=coff[1:])
        if coords.shape[0]:
            cids, starts, _, fwd = BitPosition.decode_batch(coords)
            names = np.empty(max(pos_enc.index_to_contig.keys(), default=0) + 1,
                             dtype=object)
            for idx, nm in pos_enc.index_to_contig.items():
                names[idx] = nm
            cname_arr = names[cids]
            st_l = starts.tolist()
            fw_l = fwd.tolist()
            parts = ["%s:%d^%s" % (nm, st, "F" if f else "R")
                     for nm, st, f in zip(cname_arr.tolist(), st_l, fw_l)]
        else:
            parts = []
        v_l = valid.tolist()
        co_l = coff.tolist()
        toks = [t if (not v_l[i] or co_l[i] == co_l[i + 1])
                else "%s<%s>" % (t, "|".join(parts[co_l[i]:co_l[i + 1]]))
                for i, t in enumerate(toks)]
        # per-OT scores render only in position-output mode
        # (CRISPRHit.toOutput:57-88 vs :82-87)
        for gi, g in enumerate(guides):
            if g.ot_score_cols:
                s, e = int(hit_start[gi]), int(hit_start[gi + 1])
                items = _scala_ordered_score_items(g.ot_score_cols)
                for i in range(s, e):
                    pairs = [k + SCORES_PAIRING + col[i - s] for k, col in items
                             if (i - s) < len(col) and col[i - s] is not None]
                    if pairs:
                        toks[i] += SCORES_FRONT + SCORES_SEPARATOR.join(pairs) + SCORES_BACK

    return [OFF_TARGET_SEPARATOR.join(toks[hit_start[i]:hit_start[i + 1]])
            for i in range(n_guides)]


def _contig_name_list(pos_enc: BitPosition) -> List[str]:
    """Contig names indexed by contig id (index 0 = unused)."""
    hi = max(pos_enc.index_to_contig.keys(), default=0)
    names = [""] * (hi + 1)
    for idx, nm in pos_enc.index_to_contig.items():
        names[idx] = nm
    return names


def _render_native(guides, arrs, hit_start, bit_encoding: BitEncoding,
                   pos_enc: BitPosition, write_positions: bool) -> Optional[List[str]]:
    from . import native
    if native.get_native() is None:
        return None
    n_guides = len(guides)
    all_longs = np.concatenate([a[0] for a in arrs])
    valid = np.concatenate([a[3] for a in arrs])
    if write_positions:
        coords = np.concatenate([a[1] for a in arrs])
        csizes = np.concatenate([np.diff(a[2]) for a in arrs])
        coff = np.zeros(all_longs.shape[0] + 1, dtype=np.int64)
        np.cumsum(csizes, out=coff[1:])
    else:
        coords = np.zeros(0, dtype=np.uint64)
        coff = np.zeros(all_longs.shape[0] + 1, dtype=np.int64)

    score_blocks = None
    if write_positions and any(g.ot_score_cols for g in guides):
        blocks: List[str] = []
        for gi, g in enumerate(guides):
            n = int(hit_start[gi + 1] - hit_start[gi])
            if not g.ot_score_cols:
                blocks.extend([""] * n)
            elif len(g.ot_score_cols) == 1:
                # the common shape: one score model attached (CFD)
                name, col = next(iter(g.ot_score_cols.items()))
                pre = SCORES_FRONT + name + SCORES_PAIRING
                blocks.extend(
                    (pre + col[i] + SCORES_BACK)
                    if i < len(col) and col[i] is not None else ""
                    for i in range(n))
            else:
                items = _scala_ordered_score_items(g.ot_score_cols)
                for i in range(n):
                    pairs = [kk + SCORES_PAIRING + col[i] for kk, col in items
                             if i < len(col) and col[i] is not None]
                    blocks.append(SCORES_FRONT + SCORES_SEPARATOR.join(pairs) +
                                  SCORES_BACK if pairs else "")
        soffs = np.zeros(all_longs.shape[0] + 1, dtype=np.int64)
        np.cumsum(np.fromiter(map(len, blocks), np.int64, len(blocks)),
                  out=soffs[1:])
        score_blocks = ("".join(blocks).encode("ascii"), soffs)

    guide_longs = np.fromiter((g.long_encoding for g in guides), np.uint64, n_guides)
    cmp_mask = int(bit_encoding.comparison_mask & STRING_MASK)
    return native.render_ot_tokens(
        all_longs, hit_start, guide_longs, cmp_mask,
        bit_encoding.pack.total_scan_length, write_positions,
        coords, coff, valid, _contig_name_list(pos_enc), score_blocks)


def _guide_prefix(guide: GuideWithOffTargets, models: Sequence) -> str:
    """Row columns up to (and including) otCount (TabDelimitedHandler:132-154)."""
    out = [guide.contig, str(guide.start), str(guide.stop), guide.bases,
           guide.sequence_context if guide.sequence_context is not None else "NONE",
           OVERFLOW if (guide.full or guide.inherited_overflow) else TARGET_OK,
           FORWARD if guide.forward_strand else REVERSE]
    for model in models:
        out.extend(",".join(guide.named_annotations.get(col, [MISSING_ANNOTATION]))
                   for col in model.header_columns())
    out.append(str(guide.ot_count_total()))
    return SEP.join(out)


def render_output(guides: Sequence[GuideWithOffTargets], bit_encoding: BitEncoding,
                  pos_enc: BitPosition, models: Sequence = (), write_ots: bool = True,
                  write_positions: bool = False) -> List[str]:
    """All output lines (header + rows) as a list of strings."""
    lines = [write_header(models, write_ots)]
    if write_ots:
        tokens = render_ot_tokens(guides, bit_encoding, pos_enc, write_positions)
        for g, tok in zip(guides, tokens):
            lines.append(_guide_prefix(g, models) + SEP + tok + "\n")
    else:
        for g in guides:
            lines.append(_guide_prefix(g, models) + "\n")
    return lines


def write_guide_line(guide: GuideWithOffTargets, bit_encoding: BitEncoding,
                     pos_enc: BitPosition, models: Sequence,
                     write_ots: bool, write_positions: bool) -> str:
    """One output row (kept for tests / incremental writers)."""
    if write_ots:
        tok = render_ot_tokens([guide], bit_encoding, pos_enc, write_positions)[0]
        return _guide_prefix(guide, models) + SEP + tok + "\n"
    return _guide_prefix(guide, models) + "\n"


def write_output(path: str, guides: Sequence[GuideWithOffTargets],
                 bit_encoding: BitEncoding, pos_enc: BitPosition,
                 models: Sequence = (), write_ots: bool = True,
                 write_positions: bool = False, batch: int = 512) -> None:
    """Write the output file. OT token sections stream from the native
    renderer in guide batches straight into the file as memoryview slices —
    bounded buffers, no whole-file string assembly."""
    import gzip
    opener = gzip.open if str(path).endswith(".gz") else open
    from . import native as _native
    use_native = write_ots and _native.get_native() is not None
    with opener(path, "wb") as fh:
        fh.write(write_header(models, write_ots).encode("ascii"))
        if not write_ots:
            for g in guides:
                fh.write((_guide_prefix(g, models) + "\n").encode("ascii"))
            return
        for lo in range(0, len(guides), batch):
            chunk = guides[lo:lo + batch]
            arrs = [g.ot_arrays() for g in chunk]
            hit_start = np.zeros(len(chunk) + 1, dtype=np.int64)
            np.cumsum([a[0].shape[0] for a in arrs], out=hit_start[1:])
            res = (_render_native(chunk, arrs, hit_start, bit_encoding,
                                  pos_enc, write_positions)
                   if use_native else None)
            if res is not None:
                buf, _, guide_out = res
                mv = memoryview(buf)
                for i, g in enumerate(chunk):
                    fh.write((_guide_prefix(g, models) + SEP).encode("ascii"))
                    fh.write(mv[guide_out[i]:guide_out[i + 1]])
                    fh.write(b"\n")
            else:
                toks = render_ot_tokens(chunk, bit_encoding, pos_enc,
                                        write_positions)
                for g, tok in zip(chunk, toks):
                    fh.write((_guide_prefix(g, models) + SEP + tok + "\n")
                             .encode("ascii"))


# ---------------------------------------------------------------------------
# parsing (TabDelimitedInput, TabDelimitedHandler.scala:169-334)
# ---------------------------------------------------------------------------

@dataclass
class ParsedInput:
    guides: List[GuideWithOffTargets]
    annotations: List[str]
    with_ots: bool


def parse_input(path: str, bit_encoding: BitEncoding, pos_enc: BitPosition,
                maximum_mismatches: int,
                filter_out_overflowed: bool = False) -> ParsedInput:
    from . import native
    from .utils import open_maybe_gzip
    with open_maybe_gzip(path, "rb") as fh:
        buf = fh.read()
    hdr_end = buf.find(b"\n")
    assert hdr_end > 0, "Header line not long enough for file: " + path
    header = buf[:hdr_end].decode("ascii").split(SEP)
    assert len(header) > len(DEFAULT_COLUMNS) + len(FINAL_COLUMNS) - 1, \
        "Header line not long enough for file: " + path
    assert header[:len(DEFAULT_COLUMNS)] == DEFAULT_COLUMNS, \
        "Mismatched line doesn't contain the standard header tokens: " + path

    remaining = header[len(DEFAULT_COLUMNS):]
    with_ots = len(remaining) >= 2 and remaining[-2] == FINAL_COLUMNS[0] and remaining[-1] == FINAL_COLUMNS[1]
    assert with_ots or remaining[-1] == FINAL_COLUMNS[0], "Unable to parse out the final columns"
    annotations = remaining[:-2] if with_ots else remaining[:-1]
    token_length = len(header)

    guides = None
    if native.get_native() is not None:
        guides = _parse_guides_bytes(buf, hdr_end + 1, annotations,
                                     bit_encoding, pos_enc, with_ots,
                                     token_length, maximum_mismatches)
    if guides is None:
        lines = buf.decode("utf-8").split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        guides = _parse_guides(lines[1:], annotations, bit_encoding, pos_enc,
                               with_ots, token_length, maximum_mismatches)
    if filter_out_overflowed:
        guides = [g for g in guides if not g.inherited_overflow and not g.full]
    return ParsedInput(guides, annotations, with_ots)


def _parse_guides_bytes(buf: bytes, body_start: int, annotations: List[str],
                        bit_encoding: BitEncoding, pos_enc: BitPosition,
                        with_ots: bool, token_length: int,
                        maximum_mismatches: int
                        ) -> Optional[List[GuideWithOffTargets]]:
    """Zero-copy parse of the raw file bytes.

    Line and tab boundaries come from two vectorized scans, the small guide
    fields decode from tiny slices, and the OT token columns (the bulk of
    the file — ~850 MB at 100k-guide library scale) are handed to the
    native tokenizer as (beg, end) RANGES into the original buffer. The
    string path copies every OT column three times (per-line split, column
    join, ascii encode) before the tokenizer sees a byte — fresh pages
    fault at 20-60 MB/s here, so those copies were most of the parse phase.
    Returns None on any structural surprise (wrong per-line column count,
    native parse error); the caller falls back to the string parser."""
    from . import native
    arr = np.frombuffer(buf, np.uint8)
    nl = np.nonzero(arr == 10)[0]
    nl = nl[nl >= body_start]
    starts = np.concatenate([[body_start], nl[:-1] + 1]) if nl.size else \
        np.asarray([body_start], dtype=np.int64)
    ends = nl if nl.size else np.asarray([len(buf)], dtype=np.int64)
    if nl.size and int(nl[-1]) != len(buf) - 1:
        # no trailing newline: one more line after the last newline
        starts = np.append(starts, nl[-1] + 1)
        ends = np.append(ends, len(buf))
    keep = starts < ends  # drop empty lines (trailing newline)
    starts, ends = starts[keep], ends[keep]
    n = starts.shape[0]
    if n == 0:
        return []

    tabs = np.nonzero(arr == 9)[0]
    lo = np.searchsorted(tabs, starts)
    hi = np.searchsorted(tabs, ends)
    if not np.array_equal(hi - lo, np.full(n, token_length - 1)):
        return None  # malformed rows: use the tolerant string parser
    # per-line tab positions: TB[i, k] = k-th tab of line i
    TB = tabs[lo[:, None] + np.arange(token_length - 1)[None, :]]

    def field(i: int, k: int) -> bytes:
        b = starts_l[i] if k == 0 else TB_l[i][k - 1] + 1
        e = ends_l[i] if k == token_length - 1 else TB_l[i][k]
        return buf[b:e]

    starts_l, ends_l, TB_l = starts.tolist(), ends.tolist(), TB.tolist()
    targets = [field(i, 3).decode("ascii") for i in range(n)]
    try:
        longs = bit_encoding.encode_batch(targets)
    except ValueError:
        longs = np.array([bit_encoding.encode(t) for t in targets],
                         dtype=np.uint64)

    n_ann = len(annotations)
    count_col = (SET_COLUMN_COUNT - 1) + n_ann
    guides: List[GuideWithOffTargets] = []
    caps = np.empty(n, dtype=np.int64)
    ok_b = TARGET_OK.encode("ascii")       # hoisted: the per-row encodes
    fwd_b = FORWARD.encode("ascii")        # alone cost ~0.3 s at 100k rows
    longs_l = longs.tolist()
    for i in range(n):
        context = field(i, 4)
        is_overflowed = field(i, 5) != ok_b
        # overflowCount reconstruction (TabDelimitedHandler.scala:242-247)
        cap = int(field(i, count_col)) + (0 if is_overflowed else 1)
        caps[i] = cap
        g = GuideWithOffTargets(
            contig=field(i, 0).decode("ascii"), start=int(field(i, 1)),
            bases=targets[i],
            forward_strand=field(i, 6) == fwd_b,
            sequence_context=(None if context == b"NONE"
                              else context.decode("ascii")),
            long_encoding=longs_l[i], overflow_cap=cap,
            inherited_overflow=is_overflowed)
        for k, a in enumerate(annotations):
            g.named_annotations[a] = [field(i, 7 + k).decode("ascii")]
        guides.append(g)

    if not with_ots:
        return guides

    col_beg = TB[:, token_length - 2] + 1
    parsed = native.parse_ot_tokens(buf, col_beg, ends, caps,
                                    maximum_mismatches,
                                    bit_encoding.pack.total_scan_length,
                                    _contig_name_list(pos_enc))
    if parsed is None:
        return None
    _install_parsed_ots(guides, parsed, buf)
    return guides


def _install_parsed_ots(guides, parsed, buf) -> None:
    """Attach the native tokenizer's columnar outputs to the guides
    (shared by the bytes and string parse paths)."""
    ot_longs, valid, coords, coord_offsets, hit_start, score_ranges = parsed
    for i, g in enumerate(guides):
        s, e = int(hit_start[i]), int(hit_start[i + 1])
        if s == e:
            continue
        offs = coord_offsets[s:e + 1] - coord_offsets[s]
        g.set_ots_arrays(ot_longs[s:e],
                         coords[coord_offsets[s]:coord_offsets[e]],
                         offs, valid[s:e])
    if score_ranges:
        per_guide: Dict[int, List[Tuple[int, Dict[str, str]]]] = {}
        for hit, beg, end in score_ranges:
            gi = int(np.searchsorted(hit_start, hit, side="right")) - 1
            d = dict(pair.split(SCORES_PAIRING)
                     for pair in buf[beg:end].decode("ascii")
                     .split(SCORES_SEPARATOR))
            per_guide.setdefault(gi, []).append((hit - int(hit_start[gi]), d))
        for gi, pairs in per_guide.items():
            g = guides[gi]
            cols_d: Dict[str, List[Optional[str]]] = {}
            for local, d in pairs:
                for k, v in d.items():
                    col = cols_d.setdefault(k, [None] * g.num_ots)
                    col[local] = v
            for k, col in cols_d.items():
                g.set_ot_score_col(k, col)


def _parse_guides(rows: List[str], annotations: List[str],
                  bit_encoding: BitEncoding, pos_enc: BitPosition,
                  with_ots: bool, token_length: int,
                  maximum_mismatches: int) -> List[GuideWithOffTargets]:
    """All guide rows at once: guide encodings batched, OT token columns
    handed to the native tokenizer (flashfry_native.cpp::ff_parse_ot_tokens)
    when available, per-token host parsing otherwise."""
    from . import native

    split = [ln.split(SEP) for ln in rows]
    n = len(split)
    if n == 0:
        return []
    targets = [sp[3] for sp in split]
    try:
        longs = bit_encoding.encode_batch(targets)
    except ValueError:
        longs = np.array([bit_encoding.encode(t) for t in targets], dtype=np.uint64)

    guides: List[GuideWithOffTargets] = []
    cols: List[str] = []
    caps = np.empty(n, dtype=np.int64)
    for i, sp in enumerate(split):
        contig, start, _stop, target, context, overflow_col, orientation = sp[:7]
        is_overflowed = overflow_col != TARGET_OK
        # overflowCount reconstruction (TabDelimitedHandler.scala:242-247)
        ot_count_col = int(sp[(SET_COLUMN_COUNT - 1) + len(annotations)])
        caps[i] = ot_count_col + (0 if is_overflowed else 1)
        g = GuideWithOffTargets(
            contig=contig, start=int(start), bases=target,
            forward_strand=orientation == FORWARD,
            sequence_context=None if context == "NONE" else context,
            long_encoding=int(longs[i]), overflow_cap=int(caps[i]),
            inherited_overflow=is_overflowed)
        for k, a in enumerate(annotations):
            g.named_annotations[a] = [sp[7 + k]]
        guides.append(g)
        cols.append(sp[-1] if (with_ots and len(sp) == token_length) else "")

    if not with_ots or not any(cols):
        return guides

    parsed = None
    if native.get_native() is not None:
        buf = "".join(cols).encode("ascii")
        col_offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(c) for c in cols], out=col_offsets[1:])
        parsed = native.parse_ot_tokens(buf, col_offsets[:-1], col_offsets[1:],
                                        caps, maximum_mismatches,
                                        bit_encoding.pack.total_scan_length,
                                        _contig_name_list(pos_enc))
    if parsed is not None:
        _install_parsed_ots(guides, parsed, buf)
        return guides

    for g, col in zip(guides, cols):
        if col:
            for token in col.split(OFF_TARGET_SEPARATOR):
                _add_off_target(g, token, maximum_mismatches, pos_enc, bit_encoding)
    return guides


def _add_off_target(guide: GuideWithOffTargets, token: str, maximum_mismatches: int,
                    pos_enc: BitPosition, bit_encoding: BitEncoding) -> None:
    """TabDelimitedHandler.scala:278-334."""
    pieces = token.split(WITHIN_OFF_TARGET_SEPARATOR)
    seq = pieces[0]
    count = int(pieces[1])
    # the mismatch field may be terminated by a position block OR (for hits
    # that came from a positionless file and were then scored) a score
    # block; the reference crashes on the latter shape its own score module
    # can emit (TabDelimitedHandler.scala:287-291) — we accept it
    mismatches = int(pieces[2].split(POSITION_LIST_FRONT)[0]
                     .split(SCORES_FRONT)[0])

    hit: Optional[OffTargetHit] = None
    if mismatches <= maximum_mismatches:
        if POSITION_LIST_FRONT in token:
            block = _EXTRACT_POSITION_BLOCK.match(token).group(1)
            coords = []
            for pe in block.split(POSITION_LIST_SEPARATOR):
                cname, rest = pe.split(CONTIG_SEPARATOR, 1)
                pos_str, strand = rest.split(STRAND_SEPARATOR)
                coords.append(pos_enc.encode(cname, int(pos_str), len(seq), strand == POSITION_FORWARD))
            assert count <= 32767, "The count was too large to encode"
            hit = OffTargetHit(bit_encoding.encode(seq, count),
                               np.array(coords, dtype=np.uint64), True)
        else:
            assert count <= 32767, "The count was too large to encode"
            hit = OffTargetHit(bit_encoding.encode(seq, count),
                               np.zeros(count, dtype=np.uint64), False)
        if SCORES_FRONT in token:
            block = _EXTRACT_SCORE_BLOCK.match(token).group(1)
            for pair in block.split(SCORES_SEPARATOR):
                k, v = pair.split(SCORES_PAIRING)
                hit.add_score(k, v)
        if not guide.full:
            guide.add_ot(hit)
    elif SCORES_FRONT in token:
        raise AssertionError(
            "We currently require positional information to define off-target scores")
