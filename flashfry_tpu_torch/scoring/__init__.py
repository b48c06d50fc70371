"""Scoring metric registry + the `score` command.

Counterpart of modules/ScoreResults.scala (registry :159-226, run :90-154).
"""

from __future__ import annotations

import logging
import time
from typing import List

logger = logging.getLogger("flashfry_tpu_torch.score")


def get_registered_scoring_metric(name: str, bit_encoder, input_bed: str,
                                  pack, shortest_guide_energy: int,
                                  genome_transform: str,
                                  count_on_target_in_score: bool,
                                  numeric_output: bool,
                                  max_reciprocal_mismatch: int):
    """ScoreResults.scala:159-226."""
    from .aggregate import AggregateRankedScore
    from .annotations import (BedAnnotation, ClosestHit, DangerousSequences,
                              ReciprocalOffTargets)
    from .off_target import (CrisprMitEduOffTarget, Doench2016CFDScore,
                             JostAndSantosCRISPRi)
    from .on_target import CRISPRscan, Doench2014OnTarget

    key = name.lower()
    if key == "hsu2013":
        m = CrisprMitEduOffTarget()
        m.bit_encoder(bit_encoder)
        m.consider_on_target = count_on_target_in_score
        return m
    if key == "doench2014ontarget":
        return Doench2014OnTarget()
    if key == "doench2016cfd":
        return Doench2016CFDScore()
    if key == "moreno2015":
        return CRISPRscan()
    if key == "bedannotator":
        m = BedAnnotation()
        m.input_bed = input_bed
        m.genome_transform = genome_transform
        return m
    if key == "dangerous":
        m = DangerousSequences()
        if numeric_output:
            m.clean_output = True
        return m
    if key == "minot":
        return ClosestHit()
    if key == "reciprocalofftargets":
        m = ReciprocalOffTargets()
        m.max_mismatch = max_reciprocal_mismatch
        return m
    if key == "rank":
        return AggregateRankedScore()
    if key == "jostandsantos":
        return JostAndSantosCRISPRi()
    if key == "folding":
        from .rnafold import RNAFold4j
        m = RNAFold4j()
        if shortest_guide_energy >= 0:
            m.smallest_guide = shortest_guide_energy
        else:
            m.smallest_guide = abs(pack.guide_range[0] - pack.guide_range[1])
        return m
    raise ValueError("Unknown scoring metric: " + name)


def run_score_module(args, device) -> dict:
    """The `score` CLI command (ScoreResults.scala:90-154). The off-target
    models run on args.backend (otbatch.BACKENDS), the device backend's
    descriptor pass on `device`. Returns a report of phase seconds and
    counts."""
    from ..bitcoding import BitEncoding
    from ..database import load_database
    from ..targetio import parse_input, write_output
    from . import otbatch

    otbatch.set_backend(args.backend, device)
    report = {"backend": args.backend,
              "device": str(device) if args.backend == "device" else "host"}
    t = time.perf_counter()
    db = load_database(args.database)
    pack = db.pack
    bit_enc = BitEncoding(pack)
    pos_enc = db.bit_position()

    max_mm = args.maxMismatch if args.maxMismatch is not None else 2 ** 31 - 1

    logger.info("Loading CRISPR objects (filtering out overflow guides)..")
    parsed = parse_input(args.input, bit_enc, pos_enc, max_mm,
                         filter_out_overflowed=True)
    guides = parsed.guides
    report.update(parse_s=time.perf_counter() - t, guides=len(guides),
                  off_targets=sum(g.num_ots for g in guides), model_s={})

    input_bed = ",".join(args.inputAnnotationBed) if args.inputAnnotationBed else ""
    genome_transform = ",".join(args.transformPositions) if args.transformPositions else ""

    models: List = []
    for metric_name in args.scoringMetrics.split(","):
        model = get_registered_scoring_metric(
            metric_name, bit_enc, input_bed, pack,
            args.shortestGuideEnergy, genome_transform,
            args.countOnTargetInScore, args.numericOutput,
            args.maxReciprocalMismatch)
        if model.valid_over_enzyme(pack):
            logger.info("adding score: %s", model.score_name())
            model.bit_encoder(bit_enc)
            model.setup()
            if not args.includeOTs:
                # per-OT score strings only render under --includeOTs; skip
                # building millions of them when they cannot reach the output
                model.attach_ot_scores = False
            models.append(model)
        else:
            logger.error("DROPPING SCORING METHOD: %s; it's not valid over this enzyme",
                         model.score_name())

    ranked = [m for m in models if m.high_score_is_good is not None]
    for m in models:
        if m.is_aggregate:
            m.initialize_score_names(ranked)

    logger.info("Scoring all guides...")
    try:
        for model in models:
            logger.info("Scoring with model %s", model.score_name())
            t = time.perf_counter()
            model.score_guides(guides, bit_enc, pos_enc, pack)
            report["model_s"][model.score_name()] = time.perf_counter() - t
    finally:
        from .base import clear_flat_cache
        clear_flat_cache()  # ~1 GB of memoized intermediates at 100k guides

    # ResultsAggregator re-sorts by start before output (ScoreResults.scala:137)
    guides = sorted(guides, key=lambda g: g.start)

    logger.info("Writing annotated guides to the output file...")
    t = time.perf_counter()
    write_output(args.output, guides, bit_enc, pos_enc, models,
                 write_ots=args.includeOTs, write_positions=True)
    report["write_s"] = time.perf_counter() - t
    logger.info("score report: %s", report)
    return report
