"""The check's control: the reference in the program's place, with one
guarantee broken, has to come out not correct.

The configurations state no precision; they state exact output. The
control breaks its per-guide target order: it writes every row of every
job with the plain reference, but takes each guide's targets in the order
of their first genomic site instead of FlashFry's order (ordering bin,
then sequence), and applies the overflow cap in that order. It is the
step a faster scan would tempt: hits emitted as the genome is walked.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 1

runs the cell's set-up, window and check once per seed with the control
in the program's place, and prints one JSON line per seed with `correct`
and the numbers compared. The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
from typing import List, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.reference import HEADER, ReferenceGenome, job_sites, row  # noqa: E402
from benchmark.sites import ASCII_CODES, enzyme_of  # noqa: E402


def codes_of_fasta(text: bytes) -> Tuple[List[str], List[np.ndarray]]:
    """A FASTA's record names and uint8 codes."""
    names, seqs = [], []
    for block in text.split(b">")[1:]:
        head, _, body = block.partition(b"\n")
        names.append(head.decode().strip())
        seqs.append(ASCII_CODES[np.frombuffer(body.replace(b"\n", b""), np.uint8)])
    return names, seqs


def control_discover(genome, config, device, order: str = "position"):
    """A stand-in for `cli.run(["discover", ...])` that writes the
    reference's rows with the targets in `order`."""
    enzyme = enzyme_of(config)
    ref = ReferenceGenome(genome, enzyme, device, int(config["max_positions_per_target"]))

    def discover(argv):
        opt = dict(zip(argv[1::2], argv[2::2]))
        with open(opt["--fasta"], "rb") as fh:
            names, records = codes_of_fasta(fh.read())
        sites = job_sites(records, enzyme, int(opt["--flankingSequence"]))
        max_mm = int(opt["--maxMismatch"])
        found = ref.hits_many(np.stack([s.codes for s in sites]), max_mm) if sites else []
        with open(opt["--output"], "w") as fh:
            fh.write(HEADER)
            for s, f in zip(sites, found):
                fh.write(row(s, names, ref, max_mm, int(opt["--maximumOffTargets"]),
                             order, f))
        return {"guides": len(sites)}

    return discover


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run the check's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = harness.load_benchmark(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(bench, args.workload, seed, args.seconds, False,
                                  device=args.device, root=ROOT,
                                  make_discover=control_discover)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "compared": result["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
