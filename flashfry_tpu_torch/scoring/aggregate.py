"""Rank aggregation: per-metric ranks, median-of-ranks, tranches, Schulze.

Counterpart of scoring/AggregateRankedScore.scala and utils/SchizeRank.scala.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from ..utils import median
from .base import ScoreModel

INT_MIN = -(2 ** 31)
INT_MAX = 2 ** 31 - 1


class SchulzeRank:
    """Schulze widest-path voting (utils/SchizeRank.scala:12-74).

    votes: list of (rank_vector, payload). Produces rank_and_score list in
    descending widest-path row-sum order.
    """

    def __init__(self, votes: Sequence[Tuple[Sequence[int], object]]):
        import numpy as np
        n = len(votes)
        self.guide_count = n
        # prefs[i][j] = sum_t(votes[i][t] - votes[j][t]) zipped over the
        # SHORTER of the two vectors (Scala zip truncates —
        # SchizeRank.scala prefs construction), so use prefix sums up to
        # m = min(len_i, len_j): prefs[i][j] = P_i[m] - P_j[m]
        lens = np.array([len(v[0]) for v in votes], dtype=np.int64)
        maxlen = int(lens.max()) if n else 0
        pref = np.zeros((n, maxlen + 1), dtype=np.int64)
        for idx, v in enumerate(votes):
            pref[idx, 1:lens[idx] + 1] = np.cumsum(np.asarray(v[0], dtype=np.int64))
        m = np.minimum(lens[:, None], lens[None, :])
        rows = np.arange(n)
        prefs = pref[rows[:, None], m] - pref[rows[None, :], m]
        # int32 matches the reference exactly (SchizeRank.scala stores Int);
        # vote vectors are rank values, whose zip-truncated sums stay far
        # below 2^31 at any guide count the rank cap (1000 votes) admits
        output = np.where(prefs > prefs.T, prefs, 0).astype(np.int32)
        np.fill_diagonal(output, 0)
        # Schulze widest path, vectorized Floyd-Warshall over intermediate i.
        # Within one i-iteration the reference's sequential inner loops never
        # touch column i or row i (k==i and j==i are excluded), so the
        # simultaneous numpy update is exactly equivalent. All entries are
        # >= 0, so zeroing row i / col i / the diagonal of the CANDIDATE and
        # taking an in-place maximum leaves those entries untouched — one
        # scratch buffer instead of three fresh (n, n) temporaries per
        # iteration.
        cand = np.empty_like(output)
        for i in range(n):
            np.minimum(output[:, i][:, None], output[i, :][None, :], out=cand)
            cand[i, :] = 0
            cand[:, i] = 0
            np.fill_diagonal(cand, 0)
            np.maximum(output, cand, out=output)
        row_sums = output.sum(axis=1, dtype=np.int64)
        # stable descending sort by score (Scala sortWith is stable)
        order = np.argsort(-row_sums, kind="stable")
        # index_to_rns[k] = (original_index, score, rank=k) for the k-th best
        self.index_to_rns = {k: {"index": int(order[k]),
                                 "score": int(row_sums[order[k]]), "rank": k}
                             for k in range(n)}


def convert_to_score(values: List[str], failover: float) -> float:
    """AggregateRankedScore.scala:220-226: join multiple values with '-fail-'
    (which fails to parse) and fall back to the failover score."""
    try:
        return float("-fail-".join(values))
    except ValueError:
        return failover


def assign_rank(ranked, low_is_good: bool, rank_name: str) -> None:
    """Median-rank assignment over tie groups
    (AggregateRankedScore.scala:186-213). `ranked` is a list of
    (score, guide_record) already sorted best-first."""

    def better(a, b):
        return a[0] < b[0] if low_is_good else a[0] > b[0]

    current_rank = 1
    buffer = []

    def flush():
        nonlocal current_rank
        assigned = current_rank + math.floor(len(buffer) / 2)
        for _score, rec in buffer:
            rec.ranks[rank_name] = int(assigned)
            rec.guide.named_annotations[rank_name] = [str(int(assigned))]
        current_rank += len(buffer)
        buffer.clear()

    for score, rec in ranked:
        if buffer and better(buffer[-1], (score, rec)):
            flush()
        buffer.append((score, rec))
    flush()


class _RankedRecord:
    __slots__ = ("guide", "ranks", "_median")

    def __init__(self, guide):
        self.guide = guide
        self.ranks: Dict[str, int] = {}
        self._median = None

    @property
    def median_rank(self) -> float:
        if self._median is None:
            self._median = median([float(v) for v in self.ranks.values()])
        return self._median


class AggregateRankedScore(ScoreModel):
    """Combines ranked metrics via median rank + tranches + top-X ordering
    (AggregateRankedScore.scala:38-155)."""

    is_aggregate = True

    def __init__(self, tranche_count: int = 4):
        self.tranche_count = tranche_count
        self.score_names: List[ScoreModel] = []

    def score_name(self) -> str:
        return "AggregateRankedScore"

    def score_description(self) -> str:
        return ("Combines the rank order of scoring metrics using Schulze approach, "
                "a voting theory approach, into a single rank order for guides")

    def header_columns(self) -> List[str]:
        return [self.score_name() + "_medianRank",
                self.score_name() + "_tranche",
                self.score_name() + "_topX"]

    def valid_over_enzyme(self, pack) -> bool:
        return True

    def valid_over_target_sequence(self, pack, guide) -> bool:
        return True

    def initialize_score_names(self, ranked_models) -> None:
        self.score_names = list(ranked_models)

    def score_guides(self, guides, bit_enc, pos_enc, pack) -> None:
        records = [_RankedRecord(g) for g in guides]

        # per-metric rank assignment (AggregateRankedScore.scala:163-184)
        for model in self.score_names:
            high_good = model.high_score_is_good
            fail = INT_MIN if high_good else INT_MAX
            pre = [(convert_to_score(
                rec.guide.named_annotations.get(model.score_name(), [str(fail)]), fail), rec)
                for rec in records]
            ranked = sorted(pre, key=lambda t: t[0], reverse=high_good)
            assign_rank(ranked, low_is_good=not high_good,
                        rank_name="RANKED_" + model.score_name())

        # median-of-ranks, best (lowest) first; python sort is stable like
        # Scala's sortWith
        median_ranked = sorted(((rec.median_rank, rec) for rec in records),
                               key=lambda t: t[0])
        assign_rank(median_ranked, low_is_good=True,
                    rank_name=self.score_name() + "_medianRank")

        dividers = [(v + 1) / self.tranche_count for v in range(self.tranche_count)]
        n = len(median_ranked)
        for index, (_med, rec) in enumerate(median_ranked):
            med_rank = float(rec.guide.named_annotations[self.score_name() + "_medianRank"][0])
            frac = med_rank / float(n)
            greater = [d for d in dividers if frac <= d]
            tranche = dividers.index(greater[0]) + 1
            rec.guide.named_annotations[self.score_name() + "_tranche"] = [str(tranche)]

        # Schulze over the top quartile (capped at 1000). NOTE: the reference
        # looks up SchulzeRank results by list position, whose stored rank
        # always equals that position (SchizeRank.scala:69-72), so the emitted
        # _topX is the guide's 1-based position in median-rank order. We
        # compute the real Schulze ranking (kept for library users) but emit
        # the reference-compatible value.
        top_x = min(math.ceil(n / float(self.tranche_count)), 1000)
        top_guides = median_ranked[:int(top_x)]
        votes = [(list(rec.ranks.values()), rec) for _m, rec in top_guides]
        self.last_schulze = SchulzeRank(votes) if votes else None
        for index, (_m, rec) in enumerate(top_guides):
            rec.guide.named_annotations[self.score_name() + "_topX"] = [str(index + 1)]
