"""On-target activity models: Doench 2014 and Moreno-Mateos 2015 (CRISPRscan).

Counterparts of the reference's scoring/Doench2014OnTarget.scala and
scoring/CRISPRscan.scala. Coefficient tables are the published model
parameters (doi:10.1038/nbt.3026; Moreno-Mateos 2015 Nature Methods),
extracted to JSON in scoring/data/.
"""

from __future__ import annotations

import json
import math
import os
from typing import List

from ..javafmt import java_double_to_string
from ..standards import CAS9_SCAN_LENGTH_20MER, ParameterPack
from .base import SingleGuideScoreModel, find_guide_sequence_within_context

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _load(name):
    with open(os.path.join(_DATA, name)) as fh:
        return json.load(fh)


class Doench2014OnTarget(SingleGuideScoreModel):
    """Logistic model over a 30-mer (4 bases context + 23 target + 3 context)
    (Doench2014OnTarget.scala:115-147)."""

    CONTEXT_IN_FRONT = 4
    CONTEXT_BEHIND = 3

    high_score_is_good = True

    def __init__(self):
        d = _load("doench2014.json")
        self._lookup = d["score_lookup"]
        self._gc_low = d["gc_low"]
        self._gc_high = d["gc_high"]
        self._intercept = d["intercept"]

    def score_name(self) -> str:
        return "Doench2014OnTarget"

    def score_description(self) -> str:
        return ("On target scoring metric described by John G Doench in the 2014 paper "
                "'Rational design of highly active sgRNAs for CRISPR-Cas9-mediated gene inactivation'")

    def header_columns(self) -> List[str]:
        return [self.score_name()]

    def valid_over_enzyme(self, pack: ParameterPack) -> bool:
        return pack.enzyme_family == "cas9" and pack.total_scan_length == CAS9_SCAN_LENGTH_20MER

    def valid_over_target_sequence(self, pack, guide) -> bool:
        # Doench2014OnTarget.scala:96-108
        if pack.enzyme_family != "cas9":
            return False
        if guide.sequence_context is None:
            return False
        guide_pos = find_guide_sequence_within_context(guide)
        enough_left = guide_pos >= 4
        enough_right = len(guide.sequence_context) - (guide_pos + len(guide.bases)) >= 3
        return enough_left and enough_right

    def score_guide(self, guide) -> List[List[str]]:
        guide_pos = find_guide_sequence_within_context(guide)
        seq = guide.sequence_context[guide_pos - self.CONTEXT_IN_FRONT:
                                     guide_pos + len(guide.bases) + self.CONTEXT_BEHIND]
        assert len(seq) == 30, "Sequence length is %d not 30" % len(seq)
        return [[java_double_to_string(self.calc_score(seq))]]

    def calc_score(self, guide_and_context: str) -> float:
        """Doench2014OnTarget.scala:115-147."""
        assert len(guide_and_context) == 30
        gc = sum(1 for b in guide_and_context[4:24] if b in "CG")
        gc_val = abs(gc - 10)
        score = self._intercept + gc_val * self._gc_low
        if gc > 10:
            gc_val = gc - 10
            score = self._intercept + gc_val * self._gc_high
        for index, base in enumerate(guide_and_context):
            score += self._lookup.get(base + str(index), 0.0)
            if index < len(guide_and_context) - 1:
                dinuc = base + guide_and_context[index + 1] + str(index)
                score += self._lookup.get(dinuc, 0.0)
        return 1.0 / (1.0 + math.exp(-score))


class CRISPRscan(SingleGuideScoreModel):
    """Moreno-Mateos 2015 linear model over a 35-mer context
    (CRISPRscan.scala:43-51, table :132-158)."""

    high_score_is_good = True

    def __init__(self):
        d = _load("crisprscan.json")
        self._intercept = d["intercept"]
        self._params = [(s, int(p), float(w)) for s, p, w in d["params"]]

    def score_name(self) -> str:
        return "Moreno-Mateos2015OnTarget"

    def score_description(self) -> str:
        return "On target scoring metric described by Moreno-Mateos et. al. 2015 in Nature Methods"

    def header_columns(self) -> List[str]:
        return [self.score_name()]

    def valid_over_enzyme(self, pack: ParameterPack) -> bool:
        return pack.enzyme_family == "cas9" and pack.total_scan_length == CAS9_SCAN_LENGTH_20MER

    def valid_over_target_sequence(self, pack, guide) -> bool:
        # CRISPRscan.scala:106-123 — needs 6bp context on each side
        if pack.enzyme_family != "cas9":
            return False
        if guide.sequence_context is None:
            return False
        guide_pos = find_guide_sequence_within_context(guide)
        return (guide_pos >= 6 and
                len(guide.sequence_context) - (guide_pos + len(guide.bases)) >= 6)

    def score_guide(self, guide) -> List[List[str]]:
        return [[java_double_to_string(self.calc_score(guide))]]

    def calc_score(self, guide) -> float:
        ctx = guide.sequence_context
        total = self._intercept
        for model_seq, position, weight in self._params:
            sub = ctx[position - 1: position - 1 + len(model_seq)]
            assert len(sub) == len(model_seq), \
                "Our comparison should have the same length: %s and %s" % (sub, model_seq)
            if sub.upper() == model_seq.upper():
                total += weight
        return 1.0 * total
