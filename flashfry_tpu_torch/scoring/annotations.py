"""Annotation 'scores': dangerous sequences, closest hit, BED overlap,
reciprocal off-targets.

Counterparts of scoring/DangerousSequences.scala, scoring/ClosestHit.scala,
scoring/BedAnnotation.scala and scoring/ReciprocalOffTargets.scala.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..javafmt import java_double_to_string
from ..positions import overlap
from ..standards import ParameterPack
from ..utils import gc_content
from .base import ScoreModel, SingleGuideScoreModel


class DangerousSequences(SingleGuideScoreModel):
    """GC extremes, PolyT, in-genome exact-match count
    (DangerousSequences.scala:49-68)."""

    def __init__(self):
        self._enc = None
        self.clean_output = False

    def score_name(self) -> str:
        return "dangerous"

    def score_description(self) -> str:
        return "flag sequences that will be hard to create, or could confound analysis"

    def header_columns(self) -> List[str]:
        return ["dangerous_GC", "dangerous_polyT", "dangerous_in_genome"]

    def valid_over_enzyme(self, pack) -> bool:
        return True

    def valid_over_target_sequence(self, pack, guide) -> bool:
        return True

    def bit_encoder(self, bit_encoding) -> None:
        self._enc = bit_encoding

    def score_guide(self, guide) -> List[List[str]]:
        problems = ["0", "0", "0"] if self.clean_output else ["NONE", "NONE", "NONE"]
        gc = gc_content(guide.bases)
        if self.clean_output:
            problems[0] = java_double_to_string(gc)
        elif gc < 0.25 or gc > 0.75:
            problems[0] = "GC_" + java_double_to_string(gc)

        r0, r1 = self._enc.pack.guide_range
        if "TTTT" in guide.bases[r0:r1]:
            problems[1] = "1" if self.clean_output else "PolyT"

        longs, _, _, _ = guide.ot_arrays()
        if longs.shape[0]:
            mm = self._enc.mismatches(longs, np.uint64(guide.long_encoding))
            counts = (longs >> np.uint64(48)).astype(np.int64)
            in_genome = int(counts[mm == 0].sum())
            if in_genome > 0:
                problems[2] = str(in_genome) if self.clean_output else "IN_GENOME=" + str(in_genome)
        return [[p] for p in problems]

    def score_guides(self, guides, bit_enc, pos_enc, pack) -> None:
        """Batched: one flat mismatch pass for the IN_GENOME counts; GC and
        PolyT stay per-guide string checks (cheap)."""
        from .base import flatten_guide_ots_cached
        if not len(guides):
            return
        flat, offsets, glongs, gi = flatten_guide_ots_cached(guides)
        mm = self._enc.mismatches_indexed(flat, glongs, gi)
        exact = (flat >> np.uint64(48)).astype(np.int64) * (mm == 0)
        in_genome = np.bincount(gi, weights=exact.astype(np.float64),
                                minlength=len(guides)).astype(np.int64).tolist()

        r0, r1 = self._enc.pack.guide_range
        clean = self.clean_output
        for i, g in enumerate(guides):
            problems = ["0", "0", "0"] if clean else ["NONE", "NONE", "NONE"]
            gc = gc_content(g.bases)
            if clean:
                problems[0] = java_double_to_string(gc)
            elif gc < 0.25 or gc > 0.75:
                problems[0] = "GC_" + java_double_to_string(gc)
            if "TTTT" in g.bases[r0:r1]:
                problems[1] = "1" if clean else "PolyT"
            if in_genome[i] > 0:
                problems[2] = (str(in_genome[i]) if clean
                               else "IN_GENOME=" + str(in_genome[i]))
            for col, p in zip(self.header_columns(), problems):
                g.named_annotations[col] = [p]


class ClosestHit(SingleGuideScoreModel):
    """Minimum-mismatch off-target summary (ClosestHit.scala:43-76)."""

    MAX_MM_STORED = 4

    def __init__(self):
        self._enc = None

    def score_name(self) -> str:
        return "closest"

    def score_description(self) -> str:
        return "recorded the minimum number of mismatches to the set of off-targets"

    def header_columns(self) -> List[str]:
        return ["basesDiffToClosestHit", "closestHitCount", "0-1-2-3-4_mismatch"]

    def valid_over_enzyme(self, pack) -> bool:
        return True

    def valid_over_target_sequence(self, pack, guide) -> bool:
        return True

    def bit_encoder(self, bit_encoding) -> None:
        self._enc = bit_encoding

    def score_guide(self, guide) -> List[List[str]]:
        longs, _, _, _ = guide.ot_arrays()
        mm = self._enc.mismatches(longs, np.uint64(guide.long_encoding))
        oc = (longs >> np.uint64(48)).astype(np.int64)
        in_range = mm <= self.MAX_MM_STORED
        ot_counts = np.bincount(mm[in_range],
                                weights=oc[in_range].astype(np.float64),
                                minlength=self.MAX_MM_STORED + 1).astype(np.int64)
        hist = ",".join(str(int(c)) for c in ot_counts[:self.MAX_MM_STORED + 1])
        # the reference's branch structure (ClosestHit.scala:61-66):
        # zero-mismatch hits never set `closest`, so the result is the
        # minimum positive mismatch count and the summed occurrence count of
        # every OT at exactly that distance
        pos = mm[mm > 0]
        if pos.shape[0] == 0:
            return [["UNK"], ["0"], [hist]]
        closest = int(pos.min())
        count = int(oc[mm == closest].sum())
        return [[str(closest)], [str(count)], [hist]]

    def score_guides(self, guides, bit_enc, pos_enc, pack) -> None:
        """Batched: one flat mismatch pass + a (G x 5) histogram bincount;
        the closest-positive-distance fold runs over small list slices."""
        from .base import flatten_guide_ots_cached
        if not len(guides):
            return
        K = self.MAX_MM_STORED
        flat, offsets, glongs, gi = flatten_guide_ots_cached(guides)
        mm = self._enc.mismatches_indexed(flat, glongs, gi)
        occ = (flat >> np.uint64(48)).astype(np.int64)
        in_range = mm <= K
        hists = np.bincount(
            (gi[in_range] * (K + 1) + mm[in_range]).astype(np.int64),
            weights=occ[in_range].astype(np.float64),
            minlength=len(guides) * (K + 1)).astype(np.int64)
        hists = hists.reshape(len(guides), K + 1).tolist()

        # closest positive distance per guide, fully vectorized (in place of a
        # per-guide Python fold):
        # segment-min via minimum.reduceat over the guide-grouped flat
        # order, then one bincount for the occurrence sum at that distance
        n_g = len(guides)
        NOPOS = 255
        # sentinel append keeps every offsets value a valid reduceat index
        # (offsets[i] == n for trailing empty segments) without perturbing
        # any non-empty segment's range; the sentinel can never lower a min
        mmp = np.append(np.where(mm > 0, mm.astype(np.int64), NOPOS), NOPOS)
        closest = np.minimum.reduceat(mmp, offsets[:-1])
        closest[offsets[:-1] == offsets[1:]] = NOPOS  # empty segments
        at_closest = mm == closest[gi]
        counts = np.bincount(gi[at_closest], weights=occ[at_closest].astype(np.float64),
                             minlength=n_g).astype(np.int64)

        closest_l = closest.tolist()
        counts_l = counts.tolist()
        cols = self.header_columns()
        for i, g in enumerate(guides):
            hist = ",".join(str(c) for c in hists[i])
            if closest_l[i] == NOPOS:
                vals = ["UNK", "0", hist]
            else:
                vals = [str(closest_l[i]), str(counts_l[i]), hist]
            for col, v in zip(cols, vals):
                g.named_annotations[col] = [v]


class BedAnnotation(ScoreModel):
    """BED-interval overlap annotation + optional position remapping
    (BedAnnotation.scala:67-173)."""

    OLD_CONTIG_TAG = "oldContig"

    def __init__(self):
        self.input_bed = ""
        self.genome_transform = ""
        self.input_bed_files: List[str] = []
        self.input_bed_names: List[str] = []
        self.is_remapping = False
        self.mapping_intervals = None  # dict: contig -> (newContig, offset, stop, name)

    def score_name(self) -> str:
        return "BedAnnotator"

    def score_description(self) -> str:
        return "Annotated with overlaps to bed file " + ",".join(self.input_bed_files)

    def header_columns(self) -> List[str]:
        if self.is_remapping:
            return self.input_bed_names + [self.OLD_CONTIG_TAG]
        return list(self.input_bed_names)

    def valid_over_enzyme(self, pack) -> bool:
        return True

    def valid_over_target_sequence(self, pack, guide) -> bool:
        return True

    def setup(self) -> None:
        # BedAnnotation.scala:128-149
        if not self.input_bed:
            raise ValueError("If you request bed annotation you must provide a valid BED file")
        for bed_file in self.input_bed.split(","):
            assert ":" in bed_file, ("Bedfile command line argument " + bed_file +
                                     " doesn't contain both a name and a file")
            name, path = bed_file.split(":", 1)
            assert os.path.exists(path), "The input bed file doesn't exist: " + path
            self.input_bed_names.append(name)
            self.input_bed_files.append(path)
        if self.genome_transform:
            self._parse_interval(self.genome_transform)
            self.is_remapping = True

    def _parse_interval(self, interval_file: str) -> None:
        mapping = {}
        with open(interval_file) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split("\t")
                assert len(parts) == 4, "The interval didn't parse into a four part interval"
                mapping[parts[3]] = (parts[0], int(parts[1]), int(parts[2]), parts[3])
        self.mapping_intervals = mapping

    def score_guides(self, guides, bit_enc, pos_enc, pack) -> None:
        if self.mapping_intervals is not None:
            # the reference loops guides once per interval entry; contig
            # remapping is idempotent per guide because the contig changes
            # after the first remap (BedAnnotation.scala:69-90)
            for _ in self.mapping_intervals:
                for guide in guides:
                    ref = guide.contig
                    if ref in self.mapping_intervals:
                        new_pos = self.mapping_intervals[ref]
                        guide.contig = new_pos[0]
                        guide.start = guide.start + new_pos[1]
                        guide.named_annotations.setdefault(self.OLD_CONTIG_TAG, []).append(ref)

        for path, name in zip(self.input_bed_files, self.input_bed_names):
            self._annotate_file(guides, path, name)

    def _annotate_file(self, guides, path: str, name: str) -> None:
        """One BED file against all guides via a per-contig sweep join
        (entries and guides sorted by start, a stop-keyed heap holds the
        active entries) — O((G+E) log E + matches) instead of the
        reference's O(E x G) double loop (BedAnnotation.scala:67-108),
        which is days of Python at 50k intervals x 100k guides.

        Semantics are unchanged: the overlap predicate
        (positions.overlap, PositionInformation.scala:32-37) reduces to
        entry.start < guide.end and guide.start < entry.stop in both of
        its branches, and each guide's annotations appear in BED FILE
        order exactly as the reference's entry-outer loop appends them."""
        import heapq
        entries = list(iterate_bed(path))
        if not entries or not guides:
            return
        ents_by_contig = {}
        for order, (contig, start, stop, ename) in enumerate(entries):
            ents_by_contig.setdefault(contig, []).append((start, stop, order))
        guides_by_contig = {}
        for i, g in enumerate(guides):
            guides_by_contig.setdefault(g.contig, []).append(i)

        matches: dict = {}
        for contig, gidxs in guides_by_contig.items():
            ents = ents_by_contig.get(contig)
            if not ents:
                continue
            ents.sort(key=lambda t: t[0])
            gidxs.sort(key=lambda i: guides[i].start)
            ep = 0
            active = []  # (stop, start, order) min-heap keyed by stop
            for i in gidxs:
                gstart = guides[i].start
                gend = gstart + len(guides[i].bases)
                while ep < len(ents) and ents[ep][0] < gend:
                    s, e, o = ents[ep]
                    heapq.heappush(active, (e, s, o))
                    ep += 1
                while active and active[0][0] <= gstart:
                    heapq.heappop(active)
                for e, s, o in active:
                    # a longer guide may have pushed entries a shorter,
                    # later-starting guide does not reach
                    if s < gend:
                        matches.setdefault(i, []).append(o)
        for i, orders in matches.items():
            lst = guides[i].named_annotations.setdefault(name, [])
            orders.sort()
            for o in orders:
                lst.append(entries[o][3])


def iterate_bed(path: str):
    """Minimal BED reader (utils/BedFileUtils.scala:27-76): tab-separated
    contig/start/stop/name, '#' comments skipped."""
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            yield parts[0], int(parts[1]), int(parts[2]), parts[3]


class ReciprocalOffTargets(ScoreModel):
    """Guide-vs-guide closeness flags (ReciprocalOffTargets.scala:54-62)."""

    def __init__(self):
        self.max_mismatch = 1

    def score_name(self) -> str:
        return "ReciprocalOffTargets"

    def score_description(self) -> str:
        return "Will guides within this design target one-anothers sites? "

    def header_columns(self) -> List[str]:
        return ["ReciprocalOffTargets"]

    def valid_over_enzyme(self, pack) -> bool:
        return True

    def valid_over_target_sequence(self, pack, guide) -> bool:
        return True

    def score_guides(self, guides, bit_enc, pos_enc, pack) -> None:
        """Exactly the reference's ordered double loop
        (ReciprocalOffTargets.scala:54-62) — for every ordered pair
        (g1, g2), if 0 < mismatches <= max append g2.bases to g1 — but
        computed as a multi-index candidate join instead of G^2 scalar
        calls (a pure-Python loop does not finish at 100k guides):

          1. dedup guides by their MASKED sequence (mm == 0 iff equal after
             the enzyme comparison mask, so matching is a property of the
             masked-unique id; each instance keeps its own bases string);
          2. pigeonhole: split the active (non-PAM) positions into
             max_mismatch+1 segments — any pair within max_mismatch agrees
             exactly on >= 1 segment — and group unique ids by each
             segment's exact content, generating candidates only within
             groups;
          3. verify candidates with ONE vectorized mismatches() call;
          4. per unique id, assemble the partner instance list once
             (sorted by original guide index, the reference's append
             order) and share it across that id's instances.

        Work is O(G * segments) hashing + candidate verification sized by
        true near-duplicate structure + output-sized assembly — seconds at
        100k guides (tests/test_annotations_modules.py)."""
        n = len(guides)
        if n < 2:
            return
        from ..bitcoding import STRING_MASK
        k = int(self.max_mismatch)
        name = self.score_name()
        longs = np.fromiter((g.long_encoding for g in guides),
                            dtype=np.uint64, count=n)
        masked = longs & STRING_MASK & bit_enc.comparison_mask

        uniq, inv = np.unique(masked, return_inverse=True)
        U = uniq.shape[0]
        # instances of each unique id, ascending guide index (np.unique's
        # inverse preserves it via the stable argsort below)
        order = np.argsort(inv, kind="stable")
        grp_start = np.searchsorted(inv[order], np.arange(U))
        grp_end = np.searchsorted(inv[order], np.arange(U), side="right")

        act = pack.comparison_mask_positions()
        L = pack.total_scan_length
        n_seg = min(k + 1, max(len(act), 1))
        seg_pos = np.array_split(np.asarray(act, dtype=np.int64), n_seg)

        if k >= len(act):
            # every differing-masked pair matches trivially; only hit at
            # absurd flag values, where U is the realistic bound anyway
            a_idx, b_idx = np.nonzero(~np.eye(U, dtype=bool))
        else:
            cand = []
            for seg in seg_pos:
                key = np.zeros(U, dtype=np.uint64)
                for p in seg:
                    shift = np.uint64(2 * (L - 1 - int(p)))
                    key = (key << np.uint64(2)) | ((uniq >> shift) & np.uint64(3))
                korder = np.argsort(key, kind="stable")
                ks = key[korder]
                run_break = np.nonzero(np.append(ks[1:] != ks[:-1], True))[0] + 1
                lo = 0
                for hi in run_break:
                    m = hi - lo
                    if m > 1:
                        members = korder[lo:hi]
                        cand.append((np.repeat(members, m), np.tile(members, m)))
                    lo = hi
            if not cand:
                return
            a_idx = np.concatenate([c[0] for c in cand])
            b_idx = np.concatenate([c[1] for c in cand])
            keep = a_idx != b_idx
            a_idx, b_idx = a_idx[keep], b_idx[keep]
            if a_idx.size == 0:
                return
            pair_code = np.unique(a_idx.astype(np.uint64) * np.uint64(U)
                                  + b_idx.astype(np.uint64))
            a_idx = (pair_code // np.uint64(U)).astype(np.int64)
            b_idx = (pair_code % np.uint64(U)).astype(np.int64)

        mm = np.asarray(bit_enc.mismatches(uniq[a_idx], uniq[b_idx]))
        hit = (mm.astype(np.int64) <= k) & (mm.astype(np.int64) > 0)
        a_idx, b_idx = a_idx[hit], b_idx[hit]
        if a_idx.size == 0:
            return

        bases = [g.bases for g in guides]
        # partner instance lists per unique id a: concat b-instances, sorted
        # by original index = the reference's guide-list append order
        asort = np.argsort(a_idx, kind="stable")
        a_sorted, b_sorted = a_idx[asort], b_idx[asort]
        bounds = np.nonzero(np.append(a_sorted[1:] != a_sorted[:-1], True))[0] + 1
        lo = 0
        for hi in bounds:
            a = int(a_sorted[lo])
            partner_inst = np.sort(np.concatenate(
                [order[grp_start[b]:grp_end[b]] for b in b_sorted[lo:hi]]))
            matched = [bases[j] for j in partner_inst]
            for i in order[grp_start[a]:grp_end[a]]:
                guides[i].named_annotations.setdefault(name, []).extend(matched)
            lo = hi
