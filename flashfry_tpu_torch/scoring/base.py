"""Scoring framework: model interface + single-guide adapter.

Counterpart of the reference's scoring/ScoreModel.scala (trait :31-89,
SingleGuideScoreModel :93-133). Scores are attached to guides as
named_annotations (lists of strings per column) and rendered by targetio.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..bitcoding import BitEncoding
from ..positions import BitPosition
from ..standards import ParameterPack
from ..targetio import GuideWithOffTargets

MISSING_ANNOTATION = "NA"


def flatten_guide_ots(guides: Sequence[GuideWithOffTargets]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate many guides' columnar OT stores into one flat array.

    Returns (flat_longs uint64[N], offsets int64[G+1]) — guide i's OTs are
    flat_longs[offsets[i]:offsets[i+1]]. This is what lets the scoring models
    run their table gathers over ALL guides' off-targets at once instead of
    paying numpy fixed costs per guide (the reference loops guides one at a
    time, ScoreModel.scala:113-132; at 10^5 guides x few OTs each that
    per-call overhead dominates the actual math)."""
    arrs = [g.ot_arrays()[0] for g in guides]
    offsets = np.zeros(len(arrs) + 1, dtype=np.int64)
    np.cumsum(np.fromiter((a.shape[0] for a in arrs), np.int64, len(arrs)),
              out=offsets[1:])
    if not len(arrs) or not offsets[-1]:
        return np.zeros(0, np.uint64), offsets
    return np.concatenate(arrs).astype(np.uint64, copy=False), offsets


_flat_memo = None


def clear_flat_cache() -> None:
    """Release the flatten memo (and the OT score-batch memo riding on the
    same arrays): at library scale they pin ~1 GB of scoring intermediates
    that would otherwise outlive the score phase."""
    global _flat_memo
    _flat_memo = None
    from . import otbatch
    otbatch.clear_batch_cache()


def flatten_guide_ots_cached(guides: Sequence[GuideWithOffTargets]):
    """(flat, offsets, glongs, gi) for a guide list, memoized across the
    scoring models of one run.

    Every model's batched pass needs the same concatenation of all guides'
    OT arrays plus the per-OT guide index; at 100k guides x 18M OTs each
    build costs seconds of fresh-page allocations, and a five-metric score
    run repeats it five times. The memo key includes the guide OBJECT
    identities (first/last), their OT-array object identities and the
    total OT count, so re-scoring the same guides after their OT sets were
    refilled (set_ots_arrays installs a NEW array tuple) rebuilds, and a
    recycled-id collision would additionally need matching counts. The
    score command clears the memo when the run ends (clear_flat_cache)."""
    global _flat_memo
    if not guides:
        z = np.zeros(0, np.uint64)
        return z, np.zeros(1, np.int64), z, np.zeros(0, np.int64)
    total = sum(g.num_ots for g in guides)
    key = (len(guides), id(guides[0]), id(guides[-1]),
           id(guides[0]._arr), id(guides[-1]._arr),
           guides[0].num_ots, guides[-1].num_ots, total)
    if _flat_memo is not None and _flat_memo[0] == key:
        return _flat_memo[1]
    flat, offsets = flatten_guide_ots(guides)
    glongs = np.fromiter((g.long_encoding for g in guides),
                         np.uint64, len(guides))
    gi = np.repeat(np.arange(len(guides)), np.diff(offsets))
    _flat_memo = (key, (flat, offsets, glongs, gi))
    return _flat_memo[1]


def fold_sum(values) -> float:
    """Naive left-fold float sum — Scala List.sum semantics.

    NOT builtins.sum: since CPython 3.12, sum() over floats uses Neumaier
    compensated summation, which can differ from the JVM's sequential
    foldLeft in the last ulp and break byte-parity of formatted scores
    (Doench2016CFDScore.scala:79, CrisprMitEduOffTarget.scala:103)."""
    acc = 0.0
    for v in values:
        acc += v
    return acc


def segment_fold(vals: np.ndarray, weights: np.ndarray, mask: np.ndarray,
                 offsets: np.ndarray):
    """Masked per-segment LEFT-FOLD sum of weights + running max of vals.

    Returns (sums f64[G], maxs f64[G], any u8[G]). Strict left-to-right
    accumulation is the parity contract: the reference aggregates per-OT
    scores with Scala's List.sum (a sequential fold), and the formatted
    doubles depend on its last-ulp behavior — numpy's pairwise reductions
    would diverge. Uses the native OpenMP kernel when available
    (native/flashfry_native.cpp::ff_segment_fold_f64), else the identical
    Python fold."""
    from .. import native as _native
    r = _native.segment_fold(vals, weights, mask, offsets)
    if r is not None:
        return r
    n = offsets.shape[0] - 1
    sums = np.zeros(n, dtype=np.float64)
    maxs = np.zeros(n, dtype=np.float64)
    anys = np.zeros(n, dtype=np.uint8)
    vl, wl, ml = vals.tolist(), weights.tolist(), mask.tolist()
    off = offsets.tolist()
    for i in range(n):
        acc, mx, seen = 0.0, 0.0, False
        for j in range(off[i], off[i + 1]):
            if ml[j]:
                acc += wl[j]
                if not seen or vl[j] > mx:
                    mx = vl[j]
                seen = True
        sums[i], maxs[i], anys[i] = acc, mx, seen
    return sums, maxs, anys


class ScoreModel:
    """Interface for all scoring metrics (ScoreModel.scala:31-89)."""

    #: None for unranked models; True/False = RankedScore.highScoreIsGood
    high_score_is_good: Optional[bool] = None
    #: True for models implementing the reference's AggregateScore trait
    is_aggregate: bool = False
    #: attach per-OT score strings where the model supports them (only
    #: rendered under --includeOTs; run_score_module clears this uniformly
    #: when they cannot reach the output)
    attach_ot_scores: bool = True

    def score_name(self) -> str:
        raise NotImplementedError

    def score_description(self) -> str:
        raise NotImplementedError

    def header_columns(self) -> List[str]:
        raise NotImplementedError

    def score_guides(self, guides: Sequence[GuideWithOffTargets], bit_enc: BitEncoding,
                     pos_enc: BitPosition, pack: ParameterPack) -> None:
        raise NotImplementedError

    def valid_over_enzyme(self, pack: ParameterPack) -> bool:
        raise NotImplementedError

    def valid_over_target_sequence(self, pack: ParameterPack,
                                   guide: GuideWithOffTargets) -> bool:
        raise NotImplementedError

    def setup(self) -> None:
        pass

    def bit_encoder(self, bit_encoding: BitEncoding) -> None:
        pass

    def initialize_score_names(self, ranked_models) -> None:
        pass


class SingleGuideScoreModel(ScoreModel):
    """Adapter scoring one guide at a time (ScoreModel.scala:93-133)."""

    def score_guide(self, guide: GuideWithOffTargets) -> List[List[str]]:
        raise NotImplementedError

    def score_guides(self, guides, bit_enc, pos_enc, pack) -> None:
        for hit in guides:
            if self.valid_over_target_sequence(pack, hit):
                scores = self.score_guide(hit)
                cols = self.header_columns()
                assert len(scores) == len(cols)
                for col, vals in zip(cols, scores):
                    hit.named_annotations[col] = vals
            else:
                for col in self.header_columns():
                    hit.named_annotations[col] = [MISSING_ANNOTATION]


def find_guide_sequence_within_context(guide: GuideWithOffTargets) -> int:
    """Guide offset within its context (ScoreModel.scala:145-150)."""
    if guide.sequence_context is None:
        return -1
    return (len(guide.sequence_context) - len(guide.bases)) // 2
