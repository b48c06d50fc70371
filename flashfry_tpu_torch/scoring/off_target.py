"""Off-target activity models: Doench 2016 CFD, Hsu 2013 (crispr.mit.edu),
Jost & Santos CRISPRi.

Counterparts of scoring/Doench2016CFDScore.scala,
scoring/CrisprMitEduOffTarget.scala and scoring/JostAndSantosCRISPRi.scala.
Coefficient tables are the published model parameters, extracted to JSON in
scoring/data/.

TPU-first formulation: each model's per-position lookup becomes a dense
(guide-base, ot-base, position) float table, and a guide's whole OT set is
scored with one gather + row-product over its columnar code matrix — the
reference walks each OT string character by character
(Doench2016CFDScore.scala:132-151); a scalar loop there costs CPython
minutes at the paper's 1000-guide x 2000-OT workload. Identity positions
contribute an exact 1.0 factor, so the vectorized row product reproduces the
reference's sequential fold bit-for-bit (multiplying by 1.0 is exact in
IEEE-754), and per-guide aggregation uses Python's left-fold ``sum`` to match
Scala's ``List.sum`` ordering.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from ..bitcoding import STRING_MASK, longs_to_codes, strings_to_codes
from ..javafmt import java_double_to_string
from ..standards import (CAS9_SCAN_LENGTH_19MER, CAS9_SCAN_LENGTH_20MER,
                         ParameterPack)
from .base import SingleGuideScoreModel, fold_sum

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

_BASES = "ACGT"
# DNA complement in 2-bit code space: A(0)<->T(3), C(1)<->G(2)
_COMP_CODE = np.array([3, 2, 1, 0])


def _load(name):
    with open(os.path.join(_DATA, name)) as fh:
        return json.load(fh)


def _guide_codes(guide) -> np.ndarray:
    return strings_to_codes([guide.bases])[0]


def _ot_codes(longs: np.ndarray, L: int) -> np.ndarray:
    return longs_to_codes(np.asarray(longs, dtype=np.uint64) & STRING_MASK, L)


class Doench2016CFDScore(SingleGuideScoreModel):
    """CFD max-OT + specificity score (Doench2016CFDScore.scala:53-88,
    mismatch/pam tables :173-214)."""

    high_score_is_good = False

    def __init__(self):
        d = _load("doench2016cfd.json")
        self._threshold = d["threshold"]
        self._enc = None
        # (guide base, ot base, position) activity table; identity = 1.0.
        # key "rX:dY,pos": X = guide base as RNA, Y = complement of the OT
        # base (the Doench table is keyed on the DNA strand the RNA pairs
        # with; Doench2016CFDScore.scala:139-144).
        self._mm_table = np.full((4, 4, 20), np.nan)
        self._mm_table[np.arange(4), np.arange(4), :] = 1.0
        rna = {"A": "A", "C": "C", "G": "G", "T": "U"}
        for gc in range(4):
            for oc in range(4):
                if gc == oc:
                    continue
                for pos in range(20):
                    key = "r%s:d%s,%d" % (rna[_BASES[gc]],
                                          _BASES[_COMP_CODE[oc]], pos + 1)
                    if key in d["mm_lookup"]:
                        self._mm_table[gc, oc, pos] = d["mm_lookup"][key]
        # PAM activity by the last two PAM bases (pamLookup :212-214)
        self._pam_table = np.full((4, 4), np.nan)
        for pam, v in d["pam_lookup"].items():
            self._pam_table["ACGT".index(pam[0]), "ACGT".index(pam[1])] = v

    def score_name(self) -> str:
        return "Doench2016CFDScore"

    def score_description(self) -> str:
        return ("Score off-target effects from Doench 'Optimized sgRNA design to maximize "
                "activity and minimize off-target effects of CRISPR-Cas9'")

    def header_columns(self) -> List[str]:
        return ["DoenchCFD_maxOT", "DoenchCFD_specificityscore"]

    def valid_over_enzyme(self, pack: ParameterPack) -> bool:
        return pack.enzyme_family == "cas9" and pack.total_scan_length == CAS9_SCAN_LENGTH_20MER

    def valid_over_target_sequence(self, pack, guide) -> bool:
        return pack.total_scan_length == 23 and pack.enzyme_family == "cas9"

    def bit_encoder(self, bit_encoding) -> None:
        self._enc = bit_encoding

    def score_guides(self, guides, bit_enc, pos_enc, pack) -> None:
        """Batched scoring: ONE backend-dispatched per-OT pass over every
        guide's whole OT set at once (scoring/otbatch.py: numpy oracle /
        fused native kernel / device descriptor extraction — all
        bit-identical), then a tiny per-guide fold that reproduces
        score_guide bit-for-bit (the per-guide sums stay strict left-folds
        to match Scala's List.sum ordering)."""
        from .base import MISSING_ANNOTATION, flatten_guide_ots
        from .otbatch import get_batch
        assert self._enc is not None, "Our bitEncoder has not been set"
        scorable = []
        for g in guides:
            if self.valid_over_target_sequence(pack, g):
                assert len(g.bases) == 23, \
                    "We saw an unexpected guide size of %d" % len(g.bases)
                scorable.append(g)
            else:
                for col in self.header_columns():
                    g.named_annotations[col] = [MISSING_ANNOTATION]
        if not scorable:
            return
        from .base import flatten_guide_ots_cached
        flat, offsets, glongs, gi = flatten_guide_ots_cached(scorable)

        batch = get_batch(flat, gi, glongs, 23,
                          np.asarray(sorted(pack.comparison_mask_positions()),
                                     np.int32))
        # sel: exclude exact-guide-sequence hits (Doench2016CFDScore.scala:67)
        # == any mismatch at the 20 guide positions == the mask-differs flag
        score_a, sel_a = batch.cfd(self._mm_table, self._pam_table)
        assert not np.isnan(score_a[sel_a.astype(bool)]).any(), \
            "Missing CFD table key"
        w_a = score_a * (flat >> np.uint64(48)).astype(np.float64)

        from .base import segment_fold
        sums, maxs, anys = segment_fold(score_a, w_a, sel_a, offsets)
        sums_l, maxs_l, anys_l = sums.tolist(), maxs.tolist(), anys.tolist()
        offs = offsets.tolist()
        name = self.score_name()
        for i, g in enumerate(scorable):
            if self.attach_ot_scores:
                s, e = offs[i], offs[i + 1]
                if e > s:
                    g.set_ot_score_col(name, [
                        java_double_to_string(v) if m else None
                        for v, m in zip(score_a[s:e].tolist(),
                                        sel_a[s:e].tolist())])
            if anys_l[i]:
                specificity = 1.0 / (1.0 + sums_l[i])
                max_score = maxs_l[i]
            else:
                specificity, max_score = 1.0, 0.0
            max_out = (java_double_to_string(max_score)
                       if max_score >= self._threshold else "0.0")
            g.named_annotations["DoenchCFD_maxOT"] = [max_out]
            g.named_annotations["DoenchCFD_specificityscore"] = [
                java_double_to_string(specificity)]

    def score_guide(self, guide) -> List[List[str]]:
        assert len(guide.bases) == 23, "We saw an unexpected guide size of %d" % len(guide.bases)
        assert self._enc is not None, "Our bitEncoder has not been set"
        longs, _, _, _ = guide.ot_arrays()
        n = longs.shape[0]
        g = _guide_codes(guide)
        oc = _ot_codes(longs, 23)
        # exclude exact-guide-sequence hits (Doench2016CFDScore.scala:67)
        sel = (oc[:, :20] != g[None, :20]).any(axis=1)

        vals = self._mm_table[g[None, :20], oc[:, :20], np.arange(20)[None, :]]
        assert not np.isnan(vals[sel]).any(), "Missing CFD table key"
        cand = np.multiply.reduce(vals, axis=1)
        pam = self._pam_table[oc[:, 21], oc[:, 22]]
        score = pam * cand

        if n:
            col: List[Optional[str]] = [
                java_double_to_string(s) if m else None
                for s, m in zip(score.tolist(), sel.tolist())]
            guide.set_ot_score_col(self.score_name(), col)

        counts = (longs >> np.uint64(48)).astype(np.float64)
        weighted = score * counts
        if sel.any():
            specificity = 1.0 / (1.0 + fold_sum(weighted[sel].tolist()))
            max_score = float(score[sel].max())
        else:
            specificity = 1.0
            max_score = 0.0
        # CRISPOR-guided threshold at 0.023 (Doench2016CFDScore.scala:83)
        max_out = java_double_to_string(max_score) if max_score >= self._threshold else "0.0"
        return [[max_out], [java_double_to_string(specificity)]]

    def score_cfd(self, guide: str, ot_string: str) -> float:
        """Doench2016CFDScore.scala:132-151 (scalar wrapper over the table)."""
        assert len(guide) == 20 and len(ot_string) == 20
        g = strings_to_codes([guide.upper()])[0]
        o = strings_to_codes([ot_string.upper()])[0]
        vals = self._mm_table[g, o, np.arange(20)]
        assert not np.isnan(vals).any(), "Missing CFD table key"
        return float(np.multiply.reduce(vals))


class CrisprMitEduOffTarget(SingleGuideScoreModel):
    """Hsu 2013 / crispr.mit.edu aggregate score
    (CrisprMitEduOffTarget.scala:73-148)."""

    high_score_is_good = True

    GUIDE_SIZE = 20
    PAM_START = 21
    PAM_STOP = 23

    def __init__(self):
        d = _load("hsu2013.json")
        self._coeff = d["offtarget_coeff"]
        self._one_minus = 1.0 - np.asarray(d["offtarget_coeff"], dtype=np.float64)
        self._pam_adj = d["pam_adjustment"]
        self._default_pam = d["default_pam_value"]
        self._pam_table = np.full((4, 4), float(d["default_pam_value"]))
        for pam, v in d["pam_adjustment"].items():
            self._pam_table["ACGT".index(pam[0]), "ACGT".index(pam[1])] = v
        self.consider_on_target = False
        self._enc = None

    def score_name(self) -> str:
        return "Hsu2013"

    def score_description(self) -> str:
        return "The scoring scheme from crispr.mit.edu"

    def header_columns(self) -> List[str]:
        return [self.score_name()]

    def valid_over_enzyme(self, pack: ParameterPack) -> bool:
        return pack.enzyme_family == "cas9" and pack.total_scan_length == CAS9_SCAN_LENGTH_20MER

    def valid_over_target_sequence(self, pack, guide) -> bool:
        return self.valid_over_enzyme(pack)

    def bit_encoder(self, bit_encoding) -> None:
        self._enc = bit_encoding

    def score_guide(self, guide) -> List[List[str]]:
        return [[java_double_to_string(self.score_crispr(guide))]]

    def score_guides(self, guides, bit_enc, pos_enc, pack) -> None:
        """Batched: per-OT Hsu scores for every guide's OT set in one
        vectorized pass (formulas identical to _ot_scores, so per-OT values
        are bit-identical), then the per-guide aggregate as the same Python
        left-fold as score_crispr."""
        from .base import MISSING_ANNOTATION, flatten_guide_ots
        assert self._enc is not None, "We don't have a valid bit encoding to work with"
        scorable = []
        for g in guides:
            if self.valid_over_target_sequence(pack, g):
                scorable.append(g)
            else:
                for col in self.header_columns():
                    g.named_annotations[col] = [MISSING_ANNOTATION]
        if not scorable:
            return
        from .base import flatten_guide_ots_cached
        flat, offsets, glongs, gi = flatten_guide_ots_cached(scorable)

        from .otbatch import get_batch
        batch = get_batch(flat, gi, glongs, 23,
                          np.asarray(sorted(pack.comparison_mask_positions()),
                                     np.int32))
        score_a, differs = batch.hsu(self._one_minus, self._pam_table,
                                     self.GUIDE_SIZE)
        if self.consider_on_target:
            keep_a = np.ones(flat.shape[0], dtype=np.uint8)
        else:
            # on-target exclusion == mismatches(ot, guide) != 0 under the
            # enzyme mask == the mask-differs flag
            keep_a = differs

        from .base import segment_fold
        sums, _, _ = segment_fold(score_a, score_a, keep_a, offsets)
        name = self.score_name()
        for g, total in zip(scorable, sums.tolist()):
            agg = (100.0 / (100.0 + total)) * 100.0
            g.named_annotations[name] = [java_double_to_string(agg)]

    def _ot_scores(self, guide) -> np.ndarray:
        """Per-OT Hsu scores for the whole columnar OT set
        (CrisprMitEduOffTarget.scala:107-148, vectorized)."""
        longs, _, _, _ = guide.ot_arrays()
        g = _guide_codes(guide)
        oc = _ot_codes(longs, 23)
        M = oc[:, :self.GUIDE_SIZE] != g[None, :self.GUIDE_SIZE]
        mmc = M.sum(axis=1)
        part_one = np.multiply.reduce(np.where(M, self._one_minus[None, :], 1.0),
                                      axis=1)
        first = np.argmax(M, axis=1)
        last = (self.GUIDE_SIZE - 1) - np.argmax(M[:, ::-1], axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            avg_dist = (last - first) / np.maximum(mmc - 1, 1).astype(np.float64)
        part_two = np.where(mmc < 2, 1.0,
                            1.0 / ((((19.0 - avg_dist) / 19.0) * 4.0) + 1.0))
        mmf = mmc.astype(np.float64)
        with np.errstate(divide="ignore"):
            part_three = np.where(mmc == 0, 1.0, 1.0 / (mmf * mmf))
        total = part_one * part_two * part_three * 100.0
        pam = self._pam_table[oc[:, self.PAM_START], oc[:, self.PAM_STOP - 1]]
        return total * pam

    def score_crispr(self, guide) -> float:
        assert self._enc is not None, "We don't have a valid bit encoding to work with"
        longs, _, _, _ = guide.ot_arrays()
        scores = self._ot_scores(guide)
        if not self.consider_on_target:
            mm = self._enc.mismatches(np.uint64(guide.long_encoding), longs)
            scores = scores[mm != 0]
        return (100.0 / (100.0 + fold_sum(scores.tolist()))) * 100.0

    def score_off_target(self, guide, ot) -> float:
        """Scalar wrapper (tests): one OffTargetHit record."""
        from ..targetio import GuideWithOffTargets, OffTargetHit  # noqa: F401
        tmp = GuideWithOffTargets(guide.contig, guide.start, guide.bases,
                                  guide.forward_strand, guide.sequence_context,
                                  guide.long_encoding)
        tmp.add_ot(OffTargetHit(ot.sequence, np.asarray(ot.coordinates, np.uint64),
                                ot.valid_coordinates))
        return float(self._ot_scores(tmp)[0])


class JostAndSantosCRISPRi(SingleGuideScoreModel):
    """Jost & Santos 2019 CRISPRi mismatch-activity model
    (JostAndSantosCRISPRi.scala:27-127, table :152-380)."""

    high_score_is_good = True

    def __init__(self):
        d = _load("jost_santos.json")
        # (position 1..19, OT base, comp(guide base)) -> mean activity;
        # identity = 1.0. Stored dense: [pos, ot code, guide code].
        self._table = np.full((19, 4, 4), np.nan)
        for gc in range(4):
            self._table[:, gc, gc] = 1.0
        mean = {}
        for pos, trans, m, _std, _count in d["entries"]:
            base_from = "T" if trans[1] == "U" else trans[1]
            base_to = "T" if trans[4] == "U" else trans[4]
            mean[(int(pos), base_from, base_to)] = float(m)
        for gc in range(4):
            for oc in range(4):
                if gc == oc:
                    continue
                for pos in range(1, 20):
                    key = (pos, _BASES[oc], _BASES[_COMP_CODE[gc]])
                    if key in mean:
                        self._table[pos - 1, oc, gc] = mean[key]
        self._mean = mean  # (position, OT base, comp(guide base)) -> mean
        self._enc = None
        self._pack = None

    def score_name(self) -> str:
        return "JostAndSantosCRISPRi"

    def score_description(self) -> str:
        return "CRISPRi score developed by Jost and Santos (BioRxiv, 2019)"

    def header_columns(self) -> List[str]:
        return ["JostCRISPRi_maxOT", "JostCRISPRi_specificityscore"]

    def valid_over_enzyme(self, pack: ParameterPack) -> bool:
        self._pack = pack
        return pack.enzyme_family == "cas9" and pack.total_scan_length in (
            CAS9_SCAN_LENGTH_20MER, CAS9_SCAN_LENGTH_19MER)

    def valid_over_target_sequence(self, pack, guide) -> bool:
        return pack.enzyme_family == "cas9"

    def bit_encoder(self, bit_encoding) -> None:
        self._enc = bit_encoding
        if self._pack is None:
            self._pack = bit_encoding.pack

    def _lo(self) -> int:
        """JostAndSantosCRISPRi.scala:92-127: for 20-mers, positions 1..19 of
        the sequence; for 19-mers, positions 0..18 (both keyed 1..19)."""
        L = self._pack.total_scan_length
        if L == CAS9_SCAN_LENGTH_20MER:
            return 1
        if L == CAS9_SCAN_LENGTH_19MER:
            return 0
        raise ValueError("Unable to match parameter pack")

    def score_guides(self, guides, bit_enc, pos_enc, pack) -> None:
        """Batched (see Doench2016CFDScore.score_guides): one flat table
        gather + row product, per-guide Python left-fold aggregates."""
        from .base import MISSING_ANNOTATION, flatten_guide_ots
        scorable = []
        for g in guides:
            if self.valid_over_target_sequence(pack, g):
                scorable.append(g)
            else:
                for col in self.header_columns():
                    g.named_annotations[col] = [MISSING_ANNOTATION]
        if not scorable:
            return
        L = self._pack.total_scan_length
        plo = self._lo()
        from .base import flatten_guide_ots_cached
        flat, offsets, glongs, gi = flatten_guide_ots_cached(scorable)

        from .otbatch import get_batch
        batch = get_batch(flat, gi, glongs, L,
                          np.asarray(sorted(pack.comparison_mask_positions()),
                                     np.int32))
        score_a, sel_a = batch.jost(self._table, plo)
        assert not np.isnan(score_a[sel_a.astype(bool)]).any(), \
            "Missing Jost&Santos table key"
        w_a = score_a * (flat >> np.uint64(48)).astype(np.float64)

        from .base import segment_fold
        sums, maxs, anys = segment_fold(score_a, w_a, sel_a, offsets)
        for g, total, mx, any_ in zip(scorable, sums.tolist(), maxs.tolist(),
                                      anys.tolist()):
            g.named_annotations["JostCRISPRi_maxOT"] = [
                java_double_to_string(mx if any_ else 0.0)]
            g.named_annotations["JostCRISPRi_specificityscore"] = [
                java_double_to_string(1.0 / (1.0 + total))]

    def score_guide(self, guide) -> List[List[str]]:
        L = self._pack.total_scan_length
        lo = self._lo()
        longs, _, _, _ = guide.ot_arrays()
        g = longs_to_codes(np.array([guide.long_encoding], np.uint64) & STRING_MASK, L)[0]
        oc = _ot_codes(longs, L)
        mm = self._enc.mismatches(longs, np.uint64(guide.long_encoding))
        sel = mm > 0

        vals = self._table[np.arange(19)[None, :], oc[:, lo:lo + 19], g[None, lo:lo + 19]]
        assert not np.isnan(vals[sel]).any(), "Missing Jost&Santos table key"
        score = np.multiply.reduce(vals, axis=1)
        counts = (longs >> np.uint64(48)).astype(np.float64)
        weighted = (score * counts)[sel]
        specificity = 1.0 / (1.0 + fold_sum(weighted.tolist()))
        max_score = float(score[sel].max()) if sel.any() else 0.0
        return [[java_double_to_string(max_score)],
                [java_double_to_string(specificity)]]

    def calc_score(self, target: str, off_target: str) -> float:
        """Scalar wrapper over the dense table (tests/goldens)."""
        L = self._pack.total_scan_length
        assert len(target) == L and len(off_target) == L
        lo = self._lo()
        g = strings_to_codes([target])[0]
        o = strings_to_codes([off_target])[0]
        vals = self._table[np.arange(19), o[lo:lo + 19], g[lo:lo + 19]]
        assert not np.isnan(vals).any(), "Missing Jost&Santos table key"
        return float(np.multiply.reduce(vals))
