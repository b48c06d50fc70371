"""Command-line interface of the PyTorch port: index / discover / score.

`python -m flashfry_tpu_torch discover` takes flashfry_tpu's discover flags
(reference flag names and defaults), scans on `--device` (default cuda; a
missing card is an error, never a silent CPU run) or with `--backend numpy`
on the host, and writes byte-identical output. `index` is a copy of
flashfry_tpu's host-only index command. `score` takes flashfry_tpu's score
flags plus `--backend {device,native,numpy}` and `--device {cuda,cpu}`: the
device backend (the default) runs the off-target descriptor pass on
`--device`, the other two score on the host, and all three write
byte-identical output. FLASHFRY_TPU_SCORE_BACKEND, set to one of the three
names, is the default of `--backend`. Multi-process discover and the
random / extract commands are not ported yet.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional

from .database import load_database
from .device import DEVICES, resolve_device
from .discovery import find_target_sites
from .engine import BACKENDS, ScanStats, discover
from .ops.scan import DeviceScanner
from .scoring.otbatch import BACKENDS as SCORE_BACKENDS
from .targetio import write_output
from .utils import iterate_fasta

logger = logging.getLogger("flashfry_tpu_torch")


def _add_index(sub):
    p = sub.add_parser("index", help="Generate a binary representation of the genome that can be used for off-target searches")
    p.add_argument("--reference", "-reference", required=True)
    p.add_argument("--database", "-database", required=True)
    p.add_argument("--tmpLocation", "-tmpLocation", required=False, default=None,
                   help="unused (kept for CLI parity with the reference)")
    p.add_argument("--enzyme", "-enzyme", default="spCas9ngg")
    p.add_argument("--binSize", "-binSize", type=int, default=7)
    p.add_argument("--format", default="native", choices=["native", "flashfry"],
                   help="on-disk format: columnar npz (default) or the "
                        "reference's BGZF block format")
    return p


def _add_discover(sub):
    p = sub.add_parser("discover", help="Discover off-targets for the specified sequences within the genome of interest")
    p.add_argument("--fasta", "-fasta", required=True)
    p.add_argument("--database", "-database", required=True)
    p.add_argument("--output", "-output", required=True)
    p.add_argument("--positionOutput", "-positionOutput", action="store_true")
    p.add_argument("--forceLinear", "-forceLinear", action="store_true")
    p.add_argument("--maxMismatch", "-maxMismatch", type=int, default=4)
    p.add_argument("--flankingSequence", "-flankingSequence", type=int, default=6)
    p.add_argument("--maximumOffTargets", "-maximumOffTargets", type=int, default=2000)
    p.add_argument("--minGC", "-minGC", type=float, default=0.0)
    p.add_argument("--maxGC", "-maxGC", type=float, default=1.0)
    p.add_argument("--backend", default="torch", choices=BACKENDS,
                   help="scan backend: torch on --device (default), or the "
                        "numpy host scan")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="device of the torch scan (default cuda)")
    # multi-process discover is not ported: parsed so the flags are
    # recognised, then rejected
    p.add_argument("--coordinator", default=None, help="not yet ported")
    p.add_argument("--numProcesses", type=int, default=None, help="not yet ported")
    p.add_argument("--processId", type=int, default=None, help="not yet ported")
    return p


def score_backend_default() -> str:
    """--backend's default for score: FLASHFRY_TPU_SCORE_BACKEND when it
    names a backend, `device` when it is unset or `auto`."""
    name = os.environ.get("FLASHFRY_TPU_SCORE_BACKEND", "auto")
    if name == "auto":
        return "device"
    if name not in SCORE_BACKENDS:
        raise SystemExit("FLASHFRY_TPU_SCORE_BACKEND=%s: expected auto or one "
                         "of %s" % (name, ", ".join(SCORE_BACKENDS)))
    return name


def _add_score(sub):
    p = sub.add_parser("score", help="Score candidate guides with the specified scoring metrics")
    p.add_argument("--input", "-input", required=True)
    p.add_argument("--output", "-output", required=True)
    p.add_argument("--database", "-database", required=True)
    p.add_argument("--scoringMetrics", "-scoringMetrics", required=True)
    p.add_argument("--maxMismatch", "-maxMismatch", type=int, default=None,
                   help="only consider off-targets within this mismatch distance (default: unlimited)")
    p.add_argument("--includeOTs", "-includeOTs", action="store_true")
    p.add_argument("--numericOutput", "-numericOutput", action="store_true")
    p.add_argument("--inputAnnotationBed", "-inputAnnotationBed", action="append", default=[])
    p.add_argument("--transformPositions", "-transformPositions", action="append", default=[])
    p.add_argument("--countOnTargetInScore", "-countOnTargetInScore", action="store_true")
    p.add_argument("--maxReciprocalMismatch", "-maxReciprocalMismatch", type=int, default=1)
    p.add_argument("--shortestGuideEnergy", "-shortestGuideEnergy", type=int, default=-1)
    p.add_argument("--backend", default=score_backend_default(),
                   choices=SCORE_BACKENDS,
                   help="off-target scoring backend: the descriptor pass on "
                        "--device (default), the native host library, or "
                        "numpy; FLASHFRY_TPU_SCORE_BACKEND sets the default")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="device of the descriptor pass (default cuda)")
    return p


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="flashfry-tpu-torch",
        description="CRISPR target characterization on a GPU (PyTorch port)")
    sub = ap.add_subparsers(dest="command", required=True)
    _add_index(sub)
    _add_discover(sub)
    _add_score(sub)
    return ap


def cmd_index(args) -> None:
    from .database import build_database, save_database
    from .standards import name_to_parameter_pack
    pack = name_to_parameter_pack(args.enzyme)
    logger.info("Discovering target sites in the input genome file...")
    db = build_database(args.reference, pack, bin_width=args.binSize)
    logger.info("Creating the final database file (%d targets)...", db.num_targets)
    if args.format == "flashfry":
        from .ffformat import export_flashfry_database
        export_flashfry_database(db, args.database)
    else:
        save_database(db, args.database)


def cmd_discover(args) -> dict:
    """Run discover; returns a report of phase seconds and counts (also
    logged)."""
    if (args.coordinator is not None or args.numProcesses is not None
            or args.processId is not None):
        raise SystemExit("--coordinator/--numProcesses/--processId: "
                         "multi-process discover is not yet ported")
    if not (0.0 <= args.minGC <= 1.0 and 0.0 <= args.maxGC <= 1.0):
        raise SystemExit("--minGC and --maxGC must lie in [0, 1]")
    device = None
    if args.backend != "numpy":
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit("flashfry_tpu_torch: %s" % e)

    report = {"backend": args.backend,
              "device": str(device) if device is not None else "host"}
    t = time.perf_counter()
    db = load_database(args.database)
    report["load_s"] = time.perf_counter() - t

    logger.info("Reading the input fasta and scanning for candidate guides...")
    t = time.perf_counter()
    gsites = find_target_sites(iterate_fasta(args.fasta), db.pack,
                               flanking_sequence=args.flankingSequence,
                               capture_context=True)
    report["guide_sites_s"] = time.perf_counter() - t

    scanner = None
    if device is not None:
        t = time.perf_counter()
        scanner = DeviceScanner(db, device)
        report["upload_expand_s"] = time.perf_counter() - t

    logger.info("Scanning %d candidate guides against the genome database...",
                len(gsites))
    stats = ScanStats()
    guides = discover(db, gsites,
                      max_mismatch=args.maxMismatch,
                      maximum_off_targets=args.maximumOffTargets,
                      min_gc=args.minGC, max_gc=args.maxGC,
                      force_linear=args.forceLinear,
                      backend=args.backend,
                      stats=stats, device=device or "cpu",
                      scanner=scanner)
    logger.info("Performed a total of %s guide to target comparisons in %.3fs",
                format(stats.all_comparisons, ","), stats.scan_seconds)
    t = time.perf_counter()
    write_output(args.output, guides, db.bit_encoding(), db.bit_position(),
                 models=(), write_ots=True,
                 write_positions=args.positionOutput)
    report.update(
        write_s=time.perf_counter() - t,
        counter_s=stats.counter_seconds,
        collect_s=stats.collect_seconds,
        scan_s=stats.scan_seconds - stats.counter_seconds - stats.collect_seconds,
        guides=len(guides),
        overflowed_guides=sum(1 for g in guides if g.full),
        all_comparisons=stats.all_comparisons,
        dense_comparisons=stats.dense_comparisons)
    logger.info("discover report: %s", report)
    return report


def cmd_score(args) -> dict:
    """Run score; returns a report of phase seconds and counts (also
    logged)."""
    device = "cpu"  # the host backends run nothing on a device
    if args.backend == "device":
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit("flashfry_tpu_torch: %s" % e)
    from .scoring import run_score_module
    return run_score_module(args, device)


def run(argv=None) -> Optional[dict]:
    """Parse argv and run the command; returns discover's or score's
    report."""
    args = build_parser().parse_args(argv)
    t0 = time.time()
    report = {"index": cmd_index, "discover": cmd_discover,
              "score": cmd_score}[args.command](args)
    logger.info("Total runtime %.2fs", time.time() - t0)
    return report


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s - %(message)s")
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
