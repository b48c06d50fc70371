"""Build-on-demand ctypes loader for the native host kernels.

The C++ source lives in csrc/flashfry_native.cpp; it is compiled once per
checkout with g++ -O3 (OpenMP when available) into a cached shared object in
the package's _build/ directory (or $FLASHFRY_TPU_CACHE) and loaded with
ctypes. Everything degrades gracefully: if no compiler is present
or compilation fails, callers fall back to the pure-numpy paths
(``get_native()`` returns None).

Set FLASHFRY_TPU_NO_NATIVE=1 to force the numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "flashfry_native.cpp")

_lib = None
_lib_tried = False


def _build_lib() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    cache_dir = os.environ.get("FLASHFRY_TPU_CACHE", os.path.join(_PKG, "_build"))
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, "flashfry_native_%s.so" % digest)
    if not os.path.exists(so_path):
        tmp = so_path + ".%d.tmp" % os.getpid()
        base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
        for cmd in (base + ["-fopenmp"], base):  # retry without OpenMP
            try:
                res = subprocess.run(cmd, capture_output=True, timeout=120)
            except (OSError, subprocess.TimeoutExpired):
                return None
            if res.returncode == 0:
                os.replace(tmp, so_path)
                break
        else:
            return None
    lib = ctypes.CDLL(so_path)
    i64, i32, u8p = ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ff_scan_sites.restype = i64
    lib.ff_scan_sites.argtypes = [u8p, i64, i32, i32, i32p, i32p, u8p, i64p, i64]
    lib.ff_pack_windows.restype = None
    lib.ff_pack_windows.argtypes = [u8p, i64p, i64, i32, i32, u64p]
    lib.ff_group_sorted.restype = i64
    lib.ff_group_sorted.argtypes = [u64p, i64, u64p, i64p]
    lib.ff_build_index.restype = i64
    lib.ff_build_index.argtypes = [u64p, i64p, i64p, i64p, u8p, i32,
                                   i64, i64, i64, u64p, u64p, i64p, i64p, i64p]
    u64, c_char_p = ctypes.c_uint64, ctypes.c_char_p
    lib.ff_render_ot_tokens.restype = i64
    lib.ff_render_ot_tokens.argtypes = [
        u64p, i64, i64p, i64, u64p, u64, i32, i32,
        u64p, i64p, u8p, c_char_p, i64p, i64, c_char_p, i64p,
        c_char_p, i64, i64p]
    lib.ff_parse_ot_tokens.restype = i64
    lib.ff_parse_ot_tokens.argtypes = [
        c_char_p, i64p, i64p, i64, i64p, i64, i32, c_char_p, i64p, i64,
        u64p, u8p, i64, u64p, i64p, i64, i64p,
        i64p, i64p, i64p, i64, i64p]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.ff_segment_fold_f64.restype = None
    lib.ff_segment_fold_f64.argtypes = [f64p, f64p, u8p, i64p, i64,
                                        f64p, f64p, u8p]
    lib.ff_rnafold_mfe_batch.restype = i64
    lib.ff_rnafold_mfe_batch.argtypes = [i32p, u8p, i64p, i64, i32, i32p]
    lib.ff_score_ots.restype = i64
    lib.ff_score_ots.argtypes = [u64p, i64p, i64, u64p, i64, i32,
                                 i32p, i32,
                                 f64p, f64p, f64p, f64p, i32, f64p, i32,
                                 f64p, f64p, f64p, u8p]
    lib.ff_mismatches.restype = i64
    lib.ff_mismatches.argtypes = [u64p, u64p, i64p, i64, ctypes.c_uint64, u8p]
    lib.ff_collect_hits.restype = i64
    lib.ff_collect_hits.argtypes = [i64p, i64p, i64, i64p, u64p, u64p,
                                    i64p, i64, i64p, u64p, i64p, u64p, i64]
    return lib


def get_native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if not _lib_tried:
        _lib_tried = True
        if os.environ.get("FLASHFRY_TPU_NO_NATIVE"):
            _lib = None
        else:
            try:
                _lib = _build_lib()
            except Exception:
                _lib = None
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def compile_patterns(patterns: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full-window {A,C,G,T,N} patterns -> (starts, offsets, bases) constraint
    arrays for ff_scan_sites. N positions impose no constraint."""
    code_of = {"A": 0, "C": 1, "G": 2, "T": 3}
    starts: List[int] = [0]
    offsets: List[int] = []
    bases: List[int] = []
    for pat in patterns:
        for off, ch in enumerate(pat):
            if ch != "N":
                offsets.append(off)
                bases.append(code_of[ch])
        starts.append(len(offsets))
    return (np.asarray(starts, dtype=np.int32),
            np.asarray(offsets, dtype=np.int32),
            np.asarray(bases, dtype=np.uint8))


def scan_sites(codes: np.ndarray, patterns: Sequence[str], L: int) -> Optional[np.ndarray]:
    """Native window scan; returns sorted start indices, or None if the
    native library is unavailable."""
    lib = get_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    starts, offsets, bases = compile_patterns(patterns)
    n = codes.shape[0]
    cap = max(1024, n // 4 + 16)
    while True:
        out = np.empty(cap, dtype=np.int64)
        got = lib.ff_scan_sites(
            _ptr(codes, ctypes.c_uint8), n, L, len(patterns),
            _ptr(starts, ctypes.c_int32), _ptr(offsets, ctypes.c_int32),
            _ptr(bases, ctypes.c_uint8), _ptr(out, ctypes.c_int64), cap)
        if got >= 0:
            # in-place shrink (np.empty never touched the tail pages, and
            # the old out[:got].copy() rewrote ~150 MB per hg38 contig scan)
            out.resize((got,), refcheck=False)
            return out
        cap = max(cap * 2, n + 1)  # n+1 windows is a hard upper bound


def pack_windows(codes: np.ndarray, starts: np.ndarray, L: int,
                 reverse_complement: bool = False) -> Optional[np.ndarray]:
    """Pack (and optionally reverse-complement) L-base windows into uint64s."""
    lib = get_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    out = np.empty(starts.shape[0], dtype=np.uint64)
    lib.ff_pack_windows(_ptr(codes, ctypes.c_uint8), _ptr(starts, ctypes.c_int64),
                        starts.shape[0], L, 1 if reverse_complement else 0,
                        _ptr(out, ctypes.c_uint64))
    return out


def build_index(seqs: np.ndarray, bins: np.ndarray, contig_ids: np.ndarray,
                positions: np.ndarray, forward: np.ndarray, target_length: int,
                num_bins: int, max_positions_per_target: int):
    """One-pass sort/dedup/CSR database build. Returns
    (targets, positions, pos_offsets, bin_start) or None when the native
    library is unavailable or num_bins exceeds the 16-bit composite-key room."""
    lib = get_native()
    if lib is None or num_bins > (1 << 16):
        return None
    n = seqs.shape[0]
    seqs = np.ascontiguousarray(seqs, dtype=np.uint64)
    bins = np.ascontiguousarray(bins, dtype=np.int64)
    contig_ids = np.ascontiguousarray(contig_ids, dtype=np.int64)
    positions = np.ascontiguousarray(positions, dtype=np.int64)
    forward = np.ascontiguousarray(forward, dtype=np.uint8)
    targets_out = np.empty(n, dtype=np.uint64)
    positions_out = np.empty(n, dtype=np.uint64)
    pos_offsets_out = np.empty(n + 1, dtype=np.int64)
    bin_start_out = np.empty(num_bins + 1, dtype=np.int64)
    n_pos = np.zeros(1, dtype=np.int64)
    nt = lib.ff_build_index(
        _ptr(seqs, ctypes.c_uint64), _ptr(bins, ctypes.c_int64),
        _ptr(contig_ids, ctypes.c_int64), _ptr(positions, ctypes.c_int64),
        _ptr(forward, ctypes.c_uint8), target_length, n, num_bins,
        max_positions_per_target,
        _ptr(targets_out, ctypes.c_uint64), _ptr(positions_out, ctypes.c_uint64),
        _ptr(pos_offsets_out, ctypes.c_int64), _ptr(bin_start_out, ctypes.c_int64),
        _ptr(n_pos, ctypes.c_int64))
    np_kept = int(n_pos[0])
    # in-place shrink: the old [:k].copy() trims rewrote ~9 GB at hg38
    # scale (targets + positions + offsets); resize frees the tails instead
    targets_out.resize((nt,), refcheck=False)
    positions_out.resize((np_kept,), refcheck=False)
    pos_offsets_out.resize((nt + 1,), refcheck=False)
    return (targets_out, positions_out, pos_offsets_out, bin_start_out)


def _contig_table(names: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    """Concatenate contig names (indexed by contig id) into (buf, offsets)."""
    enc = [n.encode("ascii") for n in names]
    offsets = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in enc], out=offsets[1:])
    return b"".join(enc), offsets


def render_ot_tokens(ot_longs: np.ndarray, hit_start: np.ndarray,
                     guide_longs: np.ndarray, cmp_mask: int, L: int,
                     write_positions: bool, coords: np.ndarray,
                     coord_offsets: np.ndarray, valid: np.ndarray,
                     contig_names: Sequence[str],
                     score_blocks: Optional[Tuple[bytes, np.ndarray]]):
    """Native OT-token rendering. Returns (ascii str, per-guide offsets) or
    None when the native library is unavailable / a contig id is out of
    range (caller uses the numpy renderer)."""
    lib = get_native()
    if lib is None:
        return None
    n_hits = int(ot_longs.shape[0])
    n_guides = int(guide_longs.shape[0])
    ot_longs = np.ascontiguousarray(ot_longs, dtype=np.uint64)
    hit_start = np.ascontiguousarray(hit_start, dtype=np.int64)
    guide_longs = np.ascontiguousarray(guide_longs, dtype=np.uint64)
    coords = np.ascontiguousarray(coords, dtype=np.uint64)
    coord_offsets = np.ascontiguousarray(coord_offsets, dtype=np.int64)
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8)
    cbuf, coffs = _contig_table(contig_names)
    if score_blocks is not None:
        sbuf, soffs = score_blocks
        soffs = np.ascontiguousarray(soffs, dtype=np.int64)
        sbuf_arg, soffs_arg = sbuf, _ptr(soffs, ctypes.c_int64)
        score_bytes = len(sbuf)
    else:
        sbuf_arg, soffs_arg, score_bytes = None, None, 0
    max_name = max((len(n) for n in contig_names), default=0)
    cap = n_hits * (L + 28) + int(coord_offsets[-1]) * (18 + max_name) + score_bytes + 64
    guide_out = np.zeros(n_guides + 1, dtype=np.int64)
    for _ in range(3):
        out = np.empty(max(cap, 64), dtype=np.uint8)
        got = lib.ff_render_ot_tokens(
            _ptr(ot_longs, ctypes.c_uint64), n_hits,
            _ptr(hit_start, ctypes.c_int64), n_guides,
            _ptr(guide_longs, ctypes.c_uint64), ctypes.c_uint64(cmp_mask),
            L, 1 if write_positions else 0,
            _ptr(coords, ctypes.c_uint64), _ptr(coord_offsets, ctypes.c_int64),
            _ptr(valid_u8, ctypes.c_uint8),
            cbuf, _ptr(coffs, ctypes.c_int64), len(contig_names),
            sbuf_arg, soffs_arg,
            out.ctypes.data_as(ctypes.c_char_p), cap,
            _ptr(guide_out, ctypes.c_int64))
        if got == -2:
            return None
        if got >= 0:
            # raw (buffer, used bytes, per-guide offsets) — callers slice
            # with memoryviews; no whole-buffer copy/decode (fresh
            # multi-hundred-MB pages are pathologically slow here)
            return out, int(got), guide_out
        cap *= 2
    return None


def parse_ot_tokens(buf: bytes, col_beg: np.ndarray, col_end: np.ndarray,
                    caps: np.ndarray,
                    max_mm: int, L: int, contig_names: Sequence[str]):
    """Native OT-token parsing. Guide g's token column is
    buf[col_beg[g]:col_end[g]] — ranges may point straight into the raw
    file bytes (zero-copy). Returns (longs, valid, coords, coord_offsets,
    hit_start, score_ranges[(hit, beg, end)]) or None (caller falls back to
    the host parser)."""
    lib = get_native()
    if lib is None:
        return None
    n_guides = int(col_beg.shape[0])
    col_beg = np.ascontiguousarray(col_beg, dtype=np.int64)
    col_end = np.ascontiguousarray(col_end, dtype=np.int64)
    caps = np.ascontiguousarray(caps, dtype=np.int64)
    cbuf, coffs = _contig_table(contig_names)
    n_hit_cap = buf.count(b",") + n_guides + 1
    n_coord_cap = max(buf.count(b"^"), n_hit_cap) + 1
    n_score_cap = buf.count(b"{") + 1
    hit_start = np.zeros(n_guides + 1, dtype=np.int64)
    n_scores = np.zeros(1, dtype=np.int64)
    for _ in range(8):
        longs = np.empty(n_hit_cap, dtype=np.uint64)
        valid = np.empty(n_hit_cap, dtype=np.uint8)
        coords = np.empty(n_coord_cap, dtype=np.uint64)
        coord_offsets = np.empty(n_hit_cap + 1, dtype=np.int64)
        s_hit = np.empty(n_score_cap, dtype=np.int64)
        s_beg = np.empty(n_score_cap, dtype=np.int64)
        s_end = np.empty(n_score_cap, dtype=np.int64)
        got = lib.ff_parse_ot_tokens(
            buf, _ptr(col_beg, ctypes.c_int64), _ptr(col_end, ctypes.c_int64),
            n_guides,
            _ptr(caps, ctypes.c_int64), max_mm, L,
            cbuf, _ptr(coffs, ctypes.c_int64), len(contig_names),
            _ptr(longs, ctypes.c_uint64), _ptr(valid, ctypes.c_uint8), n_hit_cap,
            _ptr(coords, ctypes.c_uint64), _ptr(coord_offsets, ctypes.c_int64),
            n_coord_cap, _ptr(hit_start, ctypes.c_int64),
            _ptr(s_hit, ctypes.c_int64), _ptr(s_beg, ctypes.c_int64),
            _ptr(s_end, ctypes.c_int64), n_score_cap, _ptr(n_scores, ctypes.c_int64))
        if got == -2:
            return None
        if got >= 0:
            n, ns = int(got), int(n_scores[0])
            return (longs[:n], valid[:n].astype(bool),
                    coords[:coord_offsets[n]], coord_offsets[:n + 1],
                    hit_start.copy(),
                    list(zip(s_hit[:ns].tolist(), s_beg[:ns].tolist(),
                             s_end[:ns].tolist())))
        n_coord_cap *= 4
    return None


def group_sorted(sorted_vals: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Run-length group a sorted uint64 array -> (unique values, counts)."""
    lib = get_native()
    if lib is None:
        return None
    sorted_vals = np.ascontiguousarray(sorted_vals, dtype=np.uint64)
    n = sorted_vals.shape[0]
    uniq = np.empty(n, dtype=np.uint64)
    counts = np.empty(n, dtype=np.int64)
    g = lib.ff_group_sorted(_ptr(sorted_vals, ctypes.c_uint64), n,
                            _ptr(uniq, ctypes.c_uint64), _ptr(counts, ctypes.c_int64))
    return uniq[:g].copy(), counts[:g].copy()


def rnafold_mfe_batch(params_blob: np.ndarray, seq_codes: np.ndarray,
                      offsets: np.ndarray, dangles: int) -> Optional[np.ndarray]:
    """Batch RNA MFE fold over the native Zuker DP. seq_codes: concatenated
    0=N,1=A,2=C,3=G,4=U codes; offsets: (n+1,) int64 bounds. Returns energies
    in 10 cal/mol (int32) or None (caller uses the Python fold)."""
    lib = get_native()
    if lib is None:
        return None
    params_blob = np.ascontiguousarray(params_blob, dtype=np.int32)
    seq_codes = np.ascontiguousarray(seq_codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = offsets.shape[0] - 1
    out = np.empty(n, dtype=np.int32)
    rc = lib.ff_rnafold_mfe_batch(
        _ptr(params_blob, ctypes.c_int32), _ptr(seq_codes, ctypes.c_uint8),
        _ptr(offsets, ctypes.c_int64), n, dangles,
        _ptr(out, ctypes.c_int32))
    if rc != 0:
        return None
    return out


def score_ots(flat: np.ndarray, gi: np.ndarray, glongs: np.ndarray, L: int,
              act_pos: np.ndarray,
              cfd_tables=None, hsu_tables=None, jost_tables=None):
    """Fused per-OT activity scores (ff_score_ots). Any of the three model
    table tuples may be None to skip that column:
      cfd_tables  = (mm_table (4,4,20) f64, pam_table (4,4) f64)
      hsu_tables  = (one_minus (gs,) f64, pam_table (4,4) f64)
      jost_tables = (table (19,4,4) f64, plo int)
    Returns dict with 'differs' u8[N] plus 'cfd'/'hsu'/'jost' f64[N] for the
    requested models, or None when the native library is unavailable."""
    lib = get_native()
    if lib is None:
        return None
    n = int(flat.shape[0])
    flat = np.ascontiguousarray(flat, dtype=np.uint64)
    gi = np.ascontiguousarray(gi, dtype=np.int64)
    glongs = np.ascontiguousarray(glongs, dtype=np.uint64)
    act_pos = np.ascontiguousarray(act_pos, dtype=np.int32)
    dp = ctypes.POINTER(ctypes.c_double)
    null = ctypes.cast(None, dp)
    out = {"differs": np.empty(n, dtype=np.uint8)}
    cfd_mm = cfd_pam = hsu_om = hsu_pam = jost_t = null
    cfd_o = hsu_o = jost_o = null
    hsu_gs, jost_lo = 0, 0
    # keep the contiguous table copies alive across the call
    keep = []
    if cfd_tables is not None:
        mm_t = np.ascontiguousarray(cfd_tables[0], dtype=np.float64)
        pam_t = np.ascontiguousarray(cfd_tables[1], dtype=np.float64)
        keep += [mm_t, pam_t]
        cfd_mm, cfd_pam = _ptr(mm_t, ctypes.c_double), _ptr(pam_t, ctypes.c_double)
        out["cfd"] = np.empty(n, dtype=np.float64)
        cfd_o = _ptr(out["cfd"], ctypes.c_double)
    if hsu_tables is not None:
        om_t = np.ascontiguousarray(hsu_tables[0], dtype=np.float64)
        pam_t = np.ascontiguousarray(hsu_tables[1], dtype=np.float64)
        keep += [om_t, pam_t]
        hsu_om, hsu_pam = _ptr(om_t, ctypes.c_double), _ptr(pam_t, ctypes.c_double)
        hsu_gs = int(om_t.shape[0])
        out["hsu"] = np.empty(n, dtype=np.float64)
        hsu_o = _ptr(out["hsu"], ctypes.c_double)
    if jost_tables is not None:
        j_t = np.ascontiguousarray(jost_tables[0], dtype=np.float64)
        keep.append(j_t)
        jost_t = _ptr(j_t, ctypes.c_double)
        jost_lo = int(jost_tables[1])
        out["jost"] = np.empty(n, dtype=np.float64)
        jost_o = _ptr(out["jost"], ctypes.c_double)
    lib.ff_score_ots(
        _ptr(flat, ctypes.c_uint64), _ptr(gi, ctypes.c_int64), n,
        _ptr(glongs, ctypes.c_uint64), int(glongs.shape[0]), L,
        _ptr(act_pos, ctypes.c_int32), int(act_pos.shape[0]),
        cfd_mm, cfd_pam, hsu_om, hsu_pam, hsu_gs, jost_t, jost_lo,
        cfd_o, hsu_o, jost_o, _ptr(out["differs"], ctypes.c_uint8))
    del keep
    return out


def collect_hits(t: np.ndarray, g: np.ndarray, pos_offsets, positions,
                 targets, caps: np.ndarray):
    """Native discover-hit collection (ff_collect_hits). Inputs may be
    memory-mapped database arrays (read in place). Returns
    (hit_start (G+1), out_longs (H), coord_offsets (H+1), out_coords (C))
    or None when the native library is unavailable or the arrays are not
    directly addressable."""
    lib = get_native()
    if lib is None:
        return None
    t = np.ascontiguousarray(t, dtype=np.int64)
    g = np.ascontiguousarray(g, dtype=np.int64)
    caps = np.ascontiguousarray(caps, dtype=np.int64)
    for arr, dt in ((pos_offsets, np.int64), (positions, np.uint64),
                    (targets, np.uint64)):
        if arr.dtype != dt or not arr.flags["C_CONTIGUOUS"]:
            return None
    n = int(t.shape[0])
    n_guides = int(caps.shape[0])
    hit_start = np.zeros(n_guides + 1, dtype=np.int64)
    out_longs = np.empty(n, dtype=np.uint64)
    coord_offsets = np.zeros(n + 1, dtype=np.int64)
    coords_cap = n + (n >> 2) + 1024  # most targets have 1 position
    for _ in range(2):
        out_coords = np.empty(coords_cap, dtype=np.uint64)
        got = lib.ff_collect_hits(
            _ptr(t, ctypes.c_int64), _ptr(g, ctypes.c_int64), n,
            _ptr(pos_offsets, ctypes.c_int64), _ptr(positions, ctypes.c_uint64),
            _ptr(targets, ctypes.c_uint64),
            _ptr(caps, ctypes.c_int64), n_guides,
            _ptr(hit_start, ctypes.c_int64), _ptr(out_longs, ctypes.c_uint64),
            _ptr(coord_offsets, ctypes.c_int64),
            _ptr(out_coords, ctypes.c_uint64), coords_cap)
        if got >= 0:
            h = int(hit_start[-1])
            return (hit_start, out_longs[:h],
                    coord_offsets[:h + 1], out_coords[:got])
        coords_cap = -int(got)  # exact size from the count pass
    return None


def mismatch_counts(a: np.ndarray, b: np.ndarray, gi=None,
                    mask: int = 0xFFFFFFFFFFFFFFFF):
    """Masked popcount mismatch counts (ff_mismatches): out[i] =
    popcount-pairs((a[i] ^ b[gi[i] if gi else i]) & mask). Returns uint8[n]
    or None when the native library is unavailable."""
    lib = get_native()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    n = int(a.shape[0])
    out = np.empty(n, dtype=np.uint8)
    if gi is None:
        assert b.shape[0] == n
        gi_p = ctypes.cast(None, ctypes.POINTER(ctypes.c_int64))
    else:
        gi = np.ascontiguousarray(gi, dtype=np.int64)
        assert gi.shape[0] == n
        gi_p = _ptr(gi, ctypes.c_int64)
    lib.ff_mismatches(_ptr(a, ctypes.c_uint64), _ptr(b, ctypes.c_uint64),
                      gi_p, n, ctypes.c_uint64(mask),
                      _ptr(out, ctypes.c_uint8))
    return out


def segment_fold(vals: np.ndarray, weights: np.ndarray, mask: np.ndarray,
                 offsets: np.ndarray):
    """Masked per-segment LEFT-FOLD sum of weights + max of vals.

    Returns (sums f64[S], maxs f64[S], any u8[S]) or None without the
    native lib. Strict left-to-right accumulation — bit-identical to the
    reference's Scala List.sum aggregation (see ff_segment_fold_f64)."""
    lib = get_native()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_seg = offsets.shape[0] - 1
    sums = np.empty(n_seg, dtype=np.float64)
    maxs = np.empty(n_seg, dtype=np.float64)
    anys = np.empty(n_seg, dtype=np.uint8)
    lib.ff_segment_fold_f64(
        _ptr(vals, ctypes.c_double), _ptr(weights, ctypes.c_double),
        _ptr(mask, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), n_seg,
        _ptr(sums, ctypes.c_double), _ptr(maxs, ctypes.c_double),
        _ptr(anys, ctypes.c_uint8))
    return sums, maxs, anys
