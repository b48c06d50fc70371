"""Command-line interface of the PyTorch port: index / discover / score /
random / extract.

`python -m flashfry_tpu_torch discover` takes flashfry_tpu's discover flags
(reference flag names and defaults), scans on `--device` (default cuda; a
missing card is an error, never a silent CPU run) or with `--backend numpy`
on the host, and writes byte-identical output. `index` is a copy of
flashfry_tpu's host-only index command. `score` takes flashfry_tpu's score
flags plus `--backend {device,native,numpy}` and `--device {cuda,cpu}`: the
device backend (the default) runs the off-target descriptor pass on
`--device`, the other two score on the host, and all three write
byte-identical output. FLASHFRY_TPU_SCORE_BACKEND, set to one of the three
names, is the default of `--backend`. `random` and `extract` are copies of
flashfry_tpu's host-only commands.

discover on several processes: run the same command once per process with
`--coordinator HOST:PORT --numProcesses N --processId I` (parallel/
multihost.py). The processes join a gloo group served by process 0 at
HOST:PORT, each scans its share of the database's shards on its own
`--device` and all of them gather every hit; only process 0 writes
`--output`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time
from typing import Optional

from .database import load_database
from .device import DEVICES, resolve_device
from .discovery import find_target_sites
from .engine import BACKENDS, ScanStats, default_scanner, discover
from .ops.scan import DeviceScanner
from .ops.scan_kernel import stage1
from .scoring.otbatch import BACKENDS as SCORE_BACKENDS
from .targetio import write_output
from .trace import count, current, recording, span
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
    # several processes: the same command once per process; the database
    # is sharded over every process's devices and process 0 writes
    p.add_argument("--coordinator", default=None,
                   help="multi-process: host:port of process 0's gloo group")
    p.add_argument("--numProcesses", type=int, default=None,
                   help="multi-process: total number of processes")
    p.add_argument("--processId", type=int, default=None,
                   help="multi-process: this process's id (0-based)")
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


def _add_random(sub):
    p = sub.add_parser("random", help="Generate a random set of CRISPR targets")
    p.add_argument("--outputFile", "-outputFile", required=True)
    p.add_argument("--enzyme", "-enzyme", default="")
    p.add_argument("--namePrefix", "-namePrefix", default="random")
    p.add_argument("--onlyUnidirectional", "-onlyUnidirectional", action="store_true")
    p.add_argument("--randomCount", "-randomCount", type=int, required=True)
    p.add_argument("--sequenceContextLeft", "-sequenceContextLeft", type=int, default=0)
    p.add_argument("--sequenceContextRight", "-sequenceContextRight", type=int, default=0)
    p.add_argument("--patterned", "-patterned", default="")
    p.add_argument("--duplicatesAllowed", "-duplicatesAllowed", action="store_true")
    p.add_argument("--maxSuccessiveDesignFailures", "-maxSuccessiveDesignFailures", type=int, default=50)
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the random draws: the same seed writes the same file")
    return p


def _add_extract(sub):
    p = sub.add_parser("extract", help="Dump targets from the database to a FASTA")
    # reference flag name is -binaryOTFile/--binaryOTFile
    # (modules/DumpDatabase.scala:33-35); --database kept as an alias.
    p.add_argument("--binaryOTFile", "-binaryOTFile", "--database", "-database",
                   dest="database", required=True)
    p.add_argument("--outputFile", "-outputFile", required=True)
    p.add_argument("--minInGenome", "-minInGenome", type=int, default=0)
    p.add_argument("--maxInGenome", "-maxInGenome", type=int, default=2 ** 31 - 1)
    p.add_argument("--subsampleProportion", "-subsampleProportion", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=None)
    return p


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="flashfry-tpu-torch",
        description="CRISPR target characterization on a GPU (PyTorch port)")
    sub = ap.add_subparsers(dest="command", required=True)
    _add_index(sub)
    _add_discover(sub)
    _add_score(sub)
    _add_random(sub)
    _add_extract(sub)
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
    """Run discover inside the recorder that `run` opens; returns a report
    of phase seconds and counts (also logged as JSON). With --coordinator
    every process scans and returns its report; only process 0 writes
    --output.

    The phase seconds are the call's spans (trace.py): `spans` holds every
    span's seconds by name and `counts` the counters; the top-level keys
    are load_s, guide_sites_s, upload_expand_s (the plane_build span: the
    scanner's construction, absent with --backend numpy), counter_s,
    collect_s, scan_s (the scan span less counter and collect) and write_s."""
    multi = args.coordinator is not None
    with contextlib.ExitStack() as group:
        with span("cli.prepare"):
            if multi:
                # the numpy oracle has no multi-process form: honouring
                # --backend numpy here would hand the user something else
                if args.backend == "numpy":
                    raise SystemExit("--coordinator (multi-host) requires the "
                                     "device scan; --backend numpy is "
                                     "single-process only")
                if args.numProcesses is None or args.processId is None:
                    raise SystemExit("--coordinator requires --numProcesses "
                                     "and --processId")
            elif args.numProcesses is not None or args.processId is not None:
                raise SystemExit("--numProcesses and --processId require "
                                 "--coordinator")
            if not (0.0 <= args.minGC <= 1.0 and 0.0 <= args.maxGC <= 1.0):
                raise SystemExit("--minGC and --maxGC must lie in [0, 1]")
            device = None
            if args.backend != "numpy":
                try:
                    device = resolve_device(args.device)
                except RuntimeError as e:
                    raise SystemExit("flashfry_tpu_torch: %s" % e)
            if multi:
                from .parallel import multihost
                group.enter_context(multihost.process_group(
                    args.coordinator, args.numProcesses, args.processId))
        report = _discover(args, device, multi)
        if multi:
            with span("release"):  # leaving the process group
                group.close()
    return report


def _discover(args, device, multi: bool) -> dict:
    rec = current()
    report = _discover_traced(args, device, multi, rec.spans)
    with span("report"):
        report.update(spans=dict(rec.spans), counts=dict(rec.counts))
        logger.info("discover report: %s", json.dumps(report))
    return report


def _discover_traced(args, device, multi: bool, spans: dict) -> dict:
    report = {"backend": args.backend,
              "device": str(device) if device is not None else "host"}
    with span("load"):
        db = load_database(args.database)
    report["load_s"] = spans["load"]

    logger.info("Reading the input fasta and scanning for candidate guides...")
    with span("guide_sites"):
        gsites = find_target_sites(iterate_fasta(args.fasta), db.pack,
                                   flanking_sequence=args.flankingSequence,
                                   capture_context=True)
    report["guide_sites_s"] = spans["guide_sites"]

    scanner = None
    report.update(scan_mode="host", slabs=0, shards=[0, 0], shard_n=0,
                  process=0, gathered_bytes=0, gather_calls=0)
    if device is not None:
        with span("plane_build"):
            if multi:
                from .parallel import multihost
                scanner = multihost.MultiHostScanner(
                    db, mesh=multihost.make_global_mesh(device))
                report.update(scan_mode="multihost", process=args.processId)
            else:
                scanner = default_scanner(db, device)
        report["upload_expand_s"] = spans["plane_build"]
        if isinstance(scanner, DeviceScanner):
            report.update(scan_mode=scanner.mode, slabs=scanner.slabs,
                          shards=[1, 1], shard_n=db.num_targets)
        else:
            report.update(slabs=1, shards=[scanner.D, scanner.Gx],
                          shard_n=scanner.shard_n)
            if not multi:
                report["scan_mode"] = "sharded"

    logger.info("Scanning %d candidate guides against the genome database...",
                len(gsites))
    stats = ScanStats()
    launches = stage1.launches
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
    with span("write"):
        if not multi or args.processId == 0:
            write_output(args.output, guides, db.bit_encoding(), db.bit_position(),
                         models=(), write_ots=True,
                         write_positions=args.positionOutput)
            count("write.bytes", os.path.getsize(args.output))
            count("write.rows", len(guides))
    if multi:
        report.update(gathered_bytes=scanner.dcn_allgather_bytes,
                      gather_calls=scanner.dcn_allgather_calls)
    counter_s, collect_s = spans.get("counter", 0.0), spans.get("collect", 0.0)
    report.update(
        write_s=spans["write"],
        stage1_launches=stage1.launches - launches,
        counter_s=counter_s,
        collect_s=collect_s,
        scan_s=spans.get("scan", 0.0) - counter_s - collect_s,
        guides=len(guides),
        overflowed_guides=sum(1 for g in guides if g.full),
        all_comparisons=stats.all_comparisons,
        dense_comparisons=stats.dense_comparisons)
    # the call's memory maps, planes and guides are freed here, in the call
    with span("release"):
        del scanner, guides, gsites, db
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


def cmd_random(args) -> None:
    from .random_guides import generate_random_fasta
    generate_random_fasta(args)


def cmd_extract(args) -> None:
    from .extract import dump_database
    dump_database(args)


def run(argv=None) -> Optional[dict]:
    """Parse argv and run the command; returns discover's or score's
    report.

    The call runs inside one recorder (trace.py), from the parse to the
    closing log line. discover's report then carries every span (`spans`),
    the spans' seconds at top level (`top_spans`), the counters (`counts`,
    with those read when the recorder closes, which discover's own log
    line lacks) and `call_seconds`, the recorder's seconds from open to
    close."""
    with recording() as rec:
        with span("cli.parse"):
            args = build_parser().parse_args(argv)
        t0 = time.perf_counter()
        report = {"index": cmd_index, "discover": cmd_discover,
                  "score": cmd_score, "random": cmd_random,
                  "extract": cmd_extract}[args.command](args)
        with span("report"):
            logger.info("Total runtime %.2fs", time.perf_counter() - t0)
    if args.command == "discover":
        report.update(spans=dict(rec.spans), counts=dict(rec.counts),
                      top_spans=dict(rec.top), call_seconds=rec.seconds)
    return report


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s - %(message)s")
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
