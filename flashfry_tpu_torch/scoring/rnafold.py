"""`folding` metric: minimum-free-energy RNA secondary structure of the guide.

The reference scores this through rnafold4j, a Java port of ViennaRNA 1.8.5
(reference: src/main/scala/scoring/RNAFold4j.scala; the library itself is a
git submodule, .gitmodules:1-3, with its Turner-1999 interior-loop tables
shipped as resources src/main/resources/RNAFold_int*_37.txt).

This is an independent implementation of the same energy model: a Zuker
minimum-free-energy fold over the Turner 1999 nearest-neighbor parameters at
37C (the parameter set of ViennaRNA 1.8.x), suited to guide-length sequences
(<= 24 nt, so plain-Python DP is instant and exact). DNA input is folded as
RNA (T == U), matching rnafold4j's byte-level behavior.

Parameter provenance:
  * 1x1 / 2x1 / 2x2 interior-loop tables: parsed from the reference's
    ViennaRNA resource dumps by tools/extract_rnafold_tables.py into
    data/rnafold_int.json.
  * stack / hairpin / bulge / interior sizes, terminal mismatches, dangles,
    multiloop + AU-end penalties, tetraloop bonuses: the published Turner
    1999 / ViennaRNA 1.8.x values, transcribed below. The four golden MFEs
    in the reference's RNAFold4jTest.scala reproduce exactly (-3.5, -4.4,
    -10.5, -10.7); see tests/test_rnafold.py.

Dangling-end model: dangles=1 (the ViennaRNA 1.8.x library default used by
fold()): each unpaired base contributes to at most one adjacent helix, chosen
by energy minimization. dangles=2 is also implemented for reference.
"""

from __future__ import annotations

import json
import math
import os
from typing import List

from .base import SingleGuideScoreModel
from ..javafmt import java_double_to_string

INF = 10_000_000
MAXLOOP = 30

# base encoding: N=0 A=1 C=2 G=3 U=4 (ViennaRNA order)
_BASE = {"A": 1, "C": 2, "G": 3, "U": 4, "T": 4}

# pair types: 0 no-pair, CG=1 GC=2 GU=3 UG=4 AU=5 UA=6
_PAIR = {(2, 3): 1, (3, 2): 2, (3, 4): 3, (4, 3): 4, (1, 4): 5, (4, 1): 6}
_RTYPE = [0, 2, 1, 4, 3, 6, 5]

# ---------------------------------------------------------------------------
# Turner 1999 parameters, 37C, in 10 cal/mol (ViennaRNA 1.8.x energy set)
# ---------------------------------------------------------------------------

# stack[type][type2] where type2 is the inner pair read 3'->5' (j-1, i+1)
_STACK = [
    [INF] * 7,
    [INF, -240, -330, -210, -140, -210, -210],  # CG
    [INF, -330, -340, -250, -150, -220, -240],  # GC
    [INF, -210, -250,  130,  -50, -140, -130],  # GU
    [INF, -140, -150,  -50,   30,  -60, -100],  # UG
    [INF, -210, -220, -140,  -60, -110,  -90],  # AU
    [INF, -210, -240, -130, -100,  -90, -130],  # UA
]

_HAIRPIN = [INF, INF, INF, 570, 560, 560, 540, 590, 560, 640, 650, 660, 670,
            678, 686, 694, 701, 707, 713, 719, 725, 730, 735, 740, 744, 749,
            753, 757, 761, 765, 769]
_BULGE = [INF, 380, 280, 320, 360, 400, 440, 459, 470, 480, 490, 500, 510,
          519, 527, 534, 541, 548, 554, 560, 565, 571, 576, 580, 585, 589,
          594, 598, 602, 605, 609]
_INTERNAL = [INF, INF, 410, 510, 490, 530, 570, 587, 601, 614, 625, 635, 645,
             653, 661, 669, 676, 682, 688, 694, 700, 705, 710, 715, 720, 724,
             728, 732, 736, 740, 744]

# terminal mismatch, hairpin loops: mismatchH[type][si1][sj1].
# CG/GC blocks are the Turner 1999 tstackh values (the CG block is also
# pinned by the reference's golden MFEs); wobble closings reuse the AU/UA
# blocks, as in the 1999 rule set.
_MMH_CG = [[0, 0, 0, 0, 0],
           [0, -150, -150, -140, -180],
           [0, -100,  -90, -290,  -80],
           [0, -220, -200, -160, -110],
           [0, -170, -120, -200, -120]]
_MMH_GC = [[0, 0, 0, 0, 0],
           [0, -110, -150, -130, -210],
           [0, -110,  -70, -240,  -50],
           [0, -240, -290, -140, -120],
           [0, -190, -100, -220, -150]]
_MMH_AU = [[0, 0, 0, 0, 0],
           [0,  -30,  -50,  -30,  -30],
           [0,  -10,  -20, -150,  -20],
           [0, -110, -120,  -20,   20],
           [0,  -30,  -30,  -60, -110]]
_MMH_UA = [[0, 0, 0, 0, 0],
           [0,  -50,  -30,  -60,  -50],
           [0,  -20,  -10, -120,    0],
           [0, -140, -120,  -70,  -20],
           [0,  -30,  -10,  -50,  -80]]
_MISMATCH_H = [[[0] * 5 for _ in range(5)],
               _MMH_CG, _MMH_GC, _MMH_AU, _MMH_UA, _MMH_AU, _MMH_UA]

# terminal mismatch, interior loops: 0 base, -110 for G.A/A.G, -70 for U.U,
# +70 closing penalty for non-CG/GC pairs (Turner 1999 interior rules).
def _mmi_block(shift: int) -> List[List[int]]:
    block = [[shift] * 5 for _ in range(5)]
    block[1][3] = shift - 110  # A.G
    block[3][1] = shift - 110  # G.A
    block[4][4] = shift - 70   # U.U
    return block


_MISMATCH_I = [[[0] * 5 for _ in range(5)],
               _mmi_block(0), _mmi_block(0),
               _mmi_block(70), _mmi_block(70), _mmi_block(70), _mmi_block(70)]

# dangle5[type][base]: unpaired base 5' of the helix end; dangle3 likewise 3'
_DANGLE5 = [
    [INF] * 5,
    [0, -50, -30, -20, -10],  # CG
    [0, -20, -30,   0,   0],  # GC
    [0, -30, -30, -40, -20],  # GU
    [0, -30, -10, -20, -20],  # UG
    [0, -30, -30, -40, -20],  # AU
    [0, -30, -10, -20, -20],  # UA
]
_DANGLE3 = [
    [INF] * 5,
    [0, -110, -40, -130, -60],  # CG
    [0, -170, -80, -170, -120], # GC
    [0,  -70, -10,  -70, -10],  # GU
    [0,  -80, -50,  -80, -60],  # UG
    [0,  -70, -10,  -70, -10],  # AU
    [0,  -80, -50,  -80, -60],  # UA
]

_TERMINAL_AU = 50
_ML_CLOSING = 340
_ML_INTERN = 40
_ML_BASE = 0
_NINIO = 50
_MAX_NINIO = 300
_LXC = 107.856

_TETRALOOPS = {
    "GGGGAC": -300, "GGUGAC": -300, "CGAAAG": -300, "GGAGAC": -300,
    "CGCAAG": -300, "GGAAAC": -300, "CGGAAG": -300, "CUUCGG": -300,
    "CGUGAG": -300, "CGAAGG": -250, "CUACGG": -250, "GGCAAC": -250,
    "CGCGAG": -250, "UGAGAG": -250, "CGAGAG": -200, "AGAAAU": -200,
    "CGUAAG": -200, "CUAACG": -200, "UGAAAG": -200, "GGAAGC": -150,
    "GGGAAC": -150, "UGAAAA": -150, "AGCAAU": -150, "AGUAAU": -150,
    "CGGGAG": -150, "AGUGAU": -150, "GGCGAC": -150, "GGGAGC": -150,
    "GAAAAC": -150, "UGGAAA": -150,
}

_int_tables = None


def _load_int_tables():
    global _int_tables
    if _int_tables is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "rnafold_int.json")
        with open(path) as fh:
            _int_tables = json.load(fh)
    return _int_tables


def _size_extrapolate(table, size: int) -> int:
    if size <= MAXLOOP:
        return table[size]
    return table[MAXLOOP] + int(_LXC * math.log(size / 30.0))


def _hairpin_energy(i: int, j: int, t: int, s, rna: str) -> int:
    """HairpinE: loop size penalty + tetraloop bonus + terminal mismatch
    (triloops get the closing AU penalty instead of a mismatch)."""
    size = j - i - 1
    e = _size_extrapolate(_HAIRPIN, size)
    if size == 4:
        # the tetraloop 6-mer starts at the 5' closing base (1-based i ->
        # 0-based i-1), as in ViennaRNA 1.8.x HairpinE
        # (strncpy(tl, string+i-1, 6))
        e += _TETRALOOPS.get(rna[i - 1:i + 5], 0)
    if size == 3:
        if t > 2:
            e += _TERMINAL_AU
    else:
        e += _MISMATCH_H[t][s[i + 1]][s[j - 1]]
    return e


def _loop_energy(n1: int, n2: int, t: int, t2: int,
                 si1: int, sj1: int, sp1: int, sq1: int, tabs) -> int:
    """Stack / bulge / interior energy between pair (i,j) of type t and inner
    pair (p,q) of reversed type t2; n1 = p-i-1 unpaired 5', n2 = j-q-1
    unpaired 3'. Mirrors ViennaRNA 1.8.x LoopEnergy."""
    nl, ns = (n1, n2) if n1 > n2 else (n2, n1)
    if nl == 0:
        return _STACK[t][t2]
    if ns == 0:  # bulge
        e = _size_extrapolate(_BULGE, nl)
        if nl == 1:
            e += _STACK[t][t2]
        else:
            if t > 2:
                e += _TERMINAL_AU
            if t2 > 2:
                e += _TERMINAL_AU
        return e
    if ns == 1:
        if nl == 1:
            return tabs["int11"][t][t2][si1][sj1]
        if nl == 2:
            if n1 == 1:
                return tabs["int21"][t][t2][si1][sq1][sj1]
            return tabs["int21"][t2][t][sq1][si1][sp1]
    elif n1 == 2 and n2 == 2:
        return tabs["int22"][t][t2][si1][sp1][sq1][sj1]
    e = _size_extrapolate(_INTERNAL, n1 + n2)
    e += min(_MAX_NINIO, (nl - ns) * _NINIO)
    e += _MISMATCH_I[t][si1][sj1] + _MISMATCH_I[t2][sq1][sp1]
    return e


def fold_mfe(sequence: str, dangles: int = 1) -> float:
    """Minimum free energy (kcal/mol) of the best secondary structure.

    dangles=1 (default) is the conditional single-dangle model; dangles=2
    applies both dangles at every helix end unconditionally.
    """
    rna = sequence.upper().replace("T", "U")
    n = len(rna)
    s = [0] + [_BASE.get(ch, 0) for ch in rna]  # 1-based
    if n < 5:
        return 0.0
    tabs = _load_int_tables()

    ptype = [[0] * (n + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        for j in range(i + 1, n + 1):
            ptype[i][j] = _PAIR.get((s[i], s[j]), 0)

    c = [[INF] * (n + 1) for _ in range(n + 1)]    # closed by pair (i,j)
    fml = [[INF] * (n + 1) for _ in range(n + 1)]  # >=1 ML branch in [i,j]
    fm1 = [[INF] * (n + 1) for _ in range(n + 1)]  # exactly 1 branch, 5' at i

    def ml_branch(i: int, j: int) -> int:
        """Helix occupying [i..j] as a multiloop branch (dangle variants
        consume flanking bases inside the segment for dangles=1)."""
        best = INF
        t = ptype[i][j]
        if t:
            e = c[i][j] + _ML_INTERN + (_TERMINAL_AU if t > 2 else 0)
            if dangles == 2:
                e += _DANGLE5[t][s[i - 1]] + _DANGLE3[t][s[j + 1] if j < n else 0]
            best = min(best, e)
        if dangles == 1:
            t = ptype[i + 1][j] if i + 1 < j else 0
            if t:
                best = min(best, c[i + 1][j] + _ML_INTERN + _ML_BASE +
                           (_TERMINAL_AU if t > 2 else 0) + _DANGLE5[t][s[i]])
            t = ptype[i][j - 1] if i < j - 1 else 0
            if t:
                best = min(best, c[i][j - 1] + _ML_INTERN + _ML_BASE +
                           (_TERMINAL_AU if t > 2 else 0) + _DANGLE3[t][s[j]])
            t = ptype[i + 1][j - 1] if i + 1 < j - 1 else 0
            if t:
                best = min(best, c[i + 1][j - 1] + _ML_INTERN + 2 * _ML_BASE +
                           (_TERMINAL_AU if t > 2 else 0) +
                           _DANGLE5[t][s[i]] + _DANGLE3[t][s[j]])
        return best

    for span in range(4, n):
        for i in range(1, n - span + 1):
            j = i + span
            t = ptype[i][j]
            if t:
                e = _hairpin_energy(i, j, t, s, rna)
                # interior loops / stacks / bulges
                for p in range(i + 1, min(i + MAXLOOP + 2, j - 4) + 1):
                    n1 = p - i - 1
                    for q in range(max(p + 4, j - 1 - (MAXLOOP - n1)), j):
                        t2 = ptype[p][q]
                        if not t2:
                            continue
                        e2 = _loop_energy(n1, j - q - 1, t, _RTYPE[t2],
                                          s[i + 1], s[j - 1], s[p - 1],
                                          s[q + 1], tabs)
                        e = min(e, e2 + c[p][q])
                # multiloop closing
                tt = _RTYPE[t]
                close_au = _TERMINAL_AU if tt > 2 else 0
                for u in range(i + 1, j - 1):
                    base = fml[i + 1][u] + fm1[u + 1][j - 1]
                    if base < INF:
                        e_ml = base + _ML_CLOSING + _ML_INTERN + close_au
                        if dangles == 2:
                            e_ml += _DANGLE3[tt][s[i + 1]] + _DANGLE5[tt][s[j - 1]]
                        e = min(e, e_ml)
                    if dangles == 1:
                        if i + 2 <= u:
                            b2 = fml[i + 2][u] + fm1[u + 1][j - 1]
                            if b2 < INF:
                                e = min(e, b2 + _ML_CLOSING + _ML_INTERN +
                                        close_au + _ML_BASE + _DANGLE3[tt][s[i + 1]])
                        if u + 1 <= j - 2:
                            b3 = fml[i + 1][u] + fm1[u + 1][j - 2]
                            if b3 < INF:
                                e = min(e, b3 + _ML_CLOSING + _ML_INTERN +
                                        close_au + _ML_BASE + _DANGLE5[tt][s[j - 1]])
                        if i + 2 <= u and u + 1 <= j - 2:
                            b4 = fml[i + 2][u] + fm1[u + 1][j - 2]
                            if b4 < INF:
                                e = min(e, b4 + _ML_CLOSING + _ML_INTERN +
                                        close_au + 2 * _ML_BASE +
                                        _DANGLE3[tt][s[i + 1]] + _DANGLE5[tt][s[j - 1]])
                c[i][j] = e

            # fm1: exactly one branch with 5' end at i
            e = fm1[i][j - 1] + _ML_BASE if fm1[i][j - 1] < INF else INF
            tb = ptype[i][j]
            if tb:
                eb = c[i][j] + _ML_INTERN + (_TERMINAL_AU if tb > 2 else 0)
                if dangles == 2:
                    eb += _DANGLE5[tb][s[i - 1]] + _DANGLE3[tb][s[j + 1] if j < n else 0]
                e = min(e, eb)
            fm1[i][j] = e

            # fml: at least one branch
            e = min(fml[i + 1][j] + _ML_BASE if fml[i + 1][j] < INF else INF,
                    fml[i][j - 1] + _ML_BASE if fml[i][j - 1] < INF else INF,
                    ml_branch(i, j))
            for u in range(i + 4, j - 4):
                if fml[i][u] < INF and fml[u + 1][j] < INF:
                    e = min(e, fml[i][u] + fml[u + 1][j])
            fml[i][j] = e

    # exterior loop
    f5 = [0] * (n + 1)
    for j in range(5, n + 1):
        best = f5[j - 1]
        for i in range(1, j - 3):
            prev = f5[i - 1]
            t = ptype[i][j]
            if t and c[i][j] < INF:
                e = prev + c[i][j] + (_TERMINAL_AU if t > 2 else 0)
                if dangles == 2:
                    e += (_DANGLE5[t][s[i - 1]] if i > 1 else 0) + \
                         (_DANGLE3[t][s[j + 1]] if j < n else 0)
                best = min(best, e)
            if dangles == 1:
                t = ptype[i + 1][j] if i + 1 < j else 0
                if t and c[i + 1][j] < INF:
                    best = min(best, prev + c[i + 1][j] +
                               (_TERMINAL_AU if t > 2 else 0) + _DANGLE5[t][s[i]])
                t = ptype[i][j - 1] if i < j - 1 else 0
                if t and c[i][j - 1] < INF:
                    best = min(best, prev + c[i][j - 1] +
                               (_TERMINAL_AU if t > 2 else 0) + _DANGLE3[t][s[j]])
                t = ptype[i + 1][j - 1] if i + 1 < j - 1 else 0
                if t and c[i + 1][j - 1] < INF:
                    best = min(best, prev + c[i + 1][j - 1] +
                               (_TERMINAL_AU if t > 2 else 0) +
                               _DANGLE5[t][s[i]] + _DANGLE3[t][s[j]])
        f5[j] = best

    return f5[n] / 100.0


_RF_MAGIC = 0x52464031  # "RF@1" — must match native/flashfry_native.cpp
_params_blob_cache = None


def _params_blob():
    """All energy parameters as one flat int32 blob for the native fold
    (ff_rnafold_mfe_batch). Field order must match rnafold::parse_params in
    native/flashfry_native.cpp; this module stays the source of truth for
    every constant."""
    global _params_blob_cache
    if _params_blob_cache is not None:
        return _params_blob_cache
    import numpy as np
    tabs = _load_int_tables()
    tetra = []
    for seq, bonus in _TETRALOOPS.items():
        tetra.extend([_BASE[ch] for ch in seq] + [bonus])
    head = [_RF_MAGIC, _TERMINAL_AU, _ML_CLOSING, _ML_INTERN, _ML_BASE,
            _NINIO, _MAX_NINIO, int(_LXC * 1e6), len(_TETRALOOPS), 0]
    parts = [head]
    for tab in (_STACK, _HAIRPIN, _BULGE, _INTERNAL, _MISMATCH_H, _MISMATCH_I,
                _DANGLE5, _DANGLE3, tabs["int11"], tabs["int21"], tabs["int22"]):
        parts.append(np.asarray(tab, dtype=np.int64).ravel())
    parts.append(tetra)
    _params_blob_cache = np.concatenate(
        [np.asarray(p, dtype=np.int32) for p in parts])
    return _params_blob_cache


def fold_mfe_batch(sequences: List[str], dangles: int = 1) -> List[float]:
    """MFE of many sequences: native batch DP (OpenMP; ~100x the pure-Python
    fold) with exact-duplicate memoization, falling back to fold_mfe per
    sequence when the native library is unavailable."""
    import numpy as np
    from ..native import rnafold_mfe_batch

    uniq: dict = {}
    for seq in sequences:
        uniq.setdefault(seq.upper().replace("T", "U"), None)
    keys = list(uniq)
    out = None
    if keys:
        codes = np.concatenate([
            np.array([_BASE.get(ch, 0) for ch in k], dtype=np.uint8)
            if k else np.empty(0, dtype=np.uint8) for k in keys])
        offsets = np.zeros(len(keys) + 1, dtype=np.int64)
        np.cumsum([len(k) for k in keys], out=offsets[1:])
        out = rnafold_mfe_batch(_params_blob(), codes, offsets, dangles)
    if out is not None:
        for k, e in zip(keys, out):
            uniq[k] = e / 100.0
    else:
        for k in keys:
            uniq[k] = fold_mfe(k, dangles)
    return [uniq[seq.upper().replace("T", "U")] for seq in sequences]


class RNAFold4j(SingleGuideScoreModel):
    """`folding` metric: guide free energy at each length from smallest_guide
    up to the full guide (RNAFold4j.scala:28-127)."""

    def __init__(self):
        self.pack = None
        self.smallest_guide = 0
        self._length_positions = []  # (length, start, stop)

    def score_name(self) -> str:
        return "RNAFold4j"

    def score_description(self) -> str:
        return "RNAFold4j free energy calculation"

    def header_columns(self) -> List[str]:
        return ["FreeEnergy%d" % ln for ln, _, _ in self._length_positions]

    def valid_over_enzyme(self, pack) -> bool:
        self.pack = pack
        return True

    def valid_over_target_sequence(self, pack, guide) -> bool:
        return True

    def setup(self) -> None:
        """Guide-length -> slice map (RNAFold4j.scala:29-40)."""
        g0, g1 = self.pack.guide_range
        guide_length = abs(g0 - g1)
        self._length_positions = []
        for ln in range(self.smallest_guide, guide_length + 1):
            if self.pack.five_prime_pam:
                self._length_positions.append((ln, g0, g0 + ln))
            else:
                self._length_positions.append((ln, g1 - ln, g1))

    def score_guide(self, guide) -> List[List[str]]:
        out = []
        for _, start, stop in self._length_positions:
            seq = guide.bases[start:stop]
            out.append([java_double_to_string(fold_mfe(seq))])
        return out

    def score_guides(self, guides, bit_enc, pos_enc, pack) -> None:
        """Batched scoring: ONE native fold call over every (guide, length)
        slice (the per-guide path costs ~1 ms/guide in Python; the reference
        loops scoreSequence per guide per length, RNAFold4j.scala:61-74)."""
        seqs = [g.bases[start:stop] for g in guides
                for _, start, stop in self._length_positions]
        energies = fold_mfe_batch(seqs)
        cols = self.header_columns()
        k = 0
        for g in guides:
            for col in cols:
                g.named_annotations[col] = [java_double_to_string(energies[k])]
                k += 1
