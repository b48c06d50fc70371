"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the CUDA cards the cell asks
for. The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 breakdown, and last
the numbers compared with their limits); the last lines of standard error
are those numbers beside their limits. It exits non-zero and prints no
result when there are too few cards, when the port cannot be imported,
or when JAX or the JAX package was loaded by the time the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)  # import this folder's modules as `benchmark.<name>` only
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "flashfry_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    bench = harness.load_benchmark(ROOT)
    cell, _, _ = harness.cell_files(bench, args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print("benchmark: %s needs %d CUDA card(s), this machine has %d"
              % (args.workload, cell["chips"],
                 torch.cuda.device_count() if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", root=ROOT,
                              t_start=T_START)
    found = forbidden_modules()
    if found:
        print("benchmark: the run loaded %s" % ", ".join(found), file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print("%s %s limit %s" % (name, c["value"], c["limit"]), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
