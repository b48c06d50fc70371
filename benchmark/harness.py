"""One run of one cell: set-up, the measured window, the check, the metrics.

Set-up (`setup_s`): the genome from the seed (genome.py), written as a
FASTA and indexed by the port's own `index` command; the job pool
(traffic.py); the warm-up jobs, which build or load the port's kernels,
warm every shape the traffic uses and leave the program's device memory
in the allocator's cache. The window: a closed loop of one client that
runs `flashfry_tpu_torch.cli.run(["discover", ...])` in this process on
one job after another, each a new input, until `seconds` have passed; the
last job runs to its end, and the window ends with it. As each job
returns, its output is read back and the check keeps what it needs of it
(check.keep). After the window: the device's peak memory, then the check
(check.py) against the plain reference, then the metrics, each read by
its file `metrics/<name>.py`.

Everything a run writes lies in one temporary directory under TMPDIR,
removed at the end: the genome's FASTA (removed once indexed), the
database, and one job's FASTA and output at a time (each output is read
back and removed as its job returns). The port's kernels build into its
own `flashfry_tpu_torch/_build/` inside the checkout.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import numpy as np
import torch

from .check import LIMITS, check_jobs, keep
from .devtrace import WINDOW, reduce_profile, top
from .genome import CONTIG, synthesize_genome, write_fasta
from .readers import Context
from .reference import ReferenceGenome
from .sites import enzyme_of, strand_sites
from .traffic import make_jobs, pool_size

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --seed streams: the genome, the jobs, the check's sample
GENOME, JOBS, SAMPLE = 0, 1, 2

Discover = Callable[[List[str]], Optional[dict]]


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_files(bench: dict, workload: str, root: str = ROOT):
    """(cell, config, traffic) of a workload of BENCHMARK.json, each read
    from its file."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit("unknown workload %r; BENCHMARK.json has: %s"
                         % (workload, ", ".join(cells)))
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                     cell["traffic"] + ".json"))
    return cell, config, traffic


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: end-to-end without trace,
    per-layer with it, each where its `workloads` (if any) name the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def load_reader(name: str, root: str = ROOT):
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def discover_argv(config: dict, fasta: str, db: str, out: str,
                  device: str) -> List[str]:
    d = config["discover"]
    return ["discover", "--fasta", fasta, "--database", db, "--output", out,
            "--maxMismatch", str(d["maxMismatch"]),
            "--flankingSequence", str(d["flankingSequence"]),
            "--maximumOffTargets", str(d["maximumOffTargets"]),
            "--positionOutput", "--device", device]


def program_discover(genome, config, device) -> Discover:
    """The system under test: the port's CLI, in process."""
    from flashfry_tpu_torch import cli
    return cli.run


def _take(path: str) -> Optional[bytes]:
    """A job's output, read back as the client gets it, and the file
    removed: the next job writes the same path, and the bytes need not
    reach the disk."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        return None
    os.unlink(path)
    return data


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", root: str = ROOT,
             make_discover=program_discover,
             t_start: Optional[float] = None) -> dict:
    """One run; returns the result line's object. make_discover(genome,
    config, device) gives the callable the window drives (the program, or
    in tests and the control something in its place)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, config, traffic = cell_files(bench, workload, root)
    enzyme = enzyme_of(config)
    dev = torch.device(device)
    d = config["discover"]
    max_mm = int(d["maxMismatch"])
    cap, flank = int(d["maximumOffTargets"]), int(d["flankingSequence"])
    from flashfry_tpu_torch import cli

    with tempfile.TemporaryDirectory(prefix="ffbench-") as work:
        genome = synthesize_genome(float(config["genome_mbp"]),
                                   np.random.default_rng([seed, GENOME]))
        fasta = os.path.join(work, "genome.fa")
        db = os.path.join(work, "genome.db")
        write_fasta(fasta, CONTIG, genome)
        cli.run(["index", "--reference", fasta, "--database", db,
                 "--enzyme", config["enzyme"]["name"],
                 "--binSize", str(config["bin_width"])])
        os.unlink(fasta)
        rng = np.random.default_rng([seed, JOBS])
        sites = strand_sites(torch.from_numpy(genome.view(np.uint8)).to(dev), enzyme)
        warm = make_jobs(traffic, genome, sites, enzyme, rng,
                         int(traffic["warmup_jobs"]), "w")
        pool = make_jobs(traffic, genome, sites, enzyme, rng,
                         pool_size(traffic, seconds), "j")
        del sites
        discover = make_discover(genome, config, dev)
        job_fa = os.path.join(work, "job.fa")
        out = os.path.join(work, "job.tsv")

        def argv(job):
            with open(job_fa, "wb") as fh:
                fh.write(job.fasta)
            return discover_argv(config, job_fa, db, out, device)

        if dev.type == "cuda":
            torch.cuda.empty_cache()    # set-up's own tensors, before the warm-up
        for job in warm:
            discover(argv(job))
            _take(out)
        os.sync()  # the index and the warm-up's writes reach the disk before the window
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start

        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        sample = np.random.default_rng([seed, SAMPLE])
        kept, reports, job_s = [], {}, []
        keep_s = 0.0
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW) if trace else contextlib.nullcontext():
            k = 0
            while True:
                if k == len(pool):
                    raise RuntimeError(
                        "the pool's %d jobs ran out before %.1f s: the mix's "
                        "max_jobs_per_s is too low for this program"
                        % (len(pool), seconds))
                job = pool[k]
                k += 1
                args = argv(job)
                t = time.perf_counter()
                report, raised = None, False
                try:
                    with (torch.profiler.record_function(job.name) if trace
                          else contextlib.nullcontext()):
                        report = discover(args)
                except (Exception, SystemExit):
                    say("job %s raised:\n%s" % (job.name, traceback.format_exc()))
                    raised = True
                job_s.append(time.perf_counter() - t)
                t = time.perf_counter()
                kept.append(keep(job, None if raised else _take(out), raised,
                                 traffic, sample))
                keep_s += time.perf_counter() - t
                reports[job.name] = report
                if time.perf_counter() - t0 >= seconds:
                    break
        window_s = time.perf_counter() - t0
        device_block = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                        "kind": (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else dev.type),
                        "count": int(cell["chips"]),
                        "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(dev))
                                              if dev.type == "cuda" else 0)}
        dtrace = None
        if prof is not None:
            prof.stop()
            dtrace = reduce_profile(prof, os.path.join(work, "trace.json"), reports)
            del prof
        del discover
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t = time.perf_counter()
        ref = ReferenceGenome(genome, enzyme, dev, int(config["max_positions_per_target"]))
        compared, info = check_jobs(kept, genome, enzyme, ref, max_mm, cap, flank)
        n_targets = ref.n_targets()
        del ref
        check_s = time.perf_counter() - t

    returned = [r for r in reports.values() if r is not None]
    ctx = Context(config=config, traffic=traffic, enzyme=enzyme, setup_s=setup_s,
                  window_s=window_s, job_s=job_s, reports=returned,
                  device_kind=device_block["kind"], trace=dtrace,
                  n_targets=n_targets, site_counts=info["site_counts"])
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = load_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = sum(1 for k in kept if k.raised)
    correct = bool(kept) and all(compared[k] <= LIMITS[k] for k in LIMITS)
    result = {"correct": correct, "attempted": len(kept), "failed": failed,
              "metrics": metrics, "device": device_block}
    if dtrace is not None:
        device_block.update(busy_s=dtrace.busy_s, window_s=window_s)
        result["breakdown"] = {"device_ops": top(dtrace.kernel_s),
                               "idle_gaps": top(dtrace.idle_s)}
    result["compared"] = {k: {"value": compared[k], "limit": LIMITS[k]} for k in LIMITS}
    say("checked %d jobs, %d rows, %d rows sampled in %.1f s; %d targets; "
        "the window kept the check's rows in %.3f s"
        % (info["jobs_checked"], info["rows_checked"], info["rows_sampled"],
           check_s, n_targets, keep_s))
    say("job walls (s): " + " ".join("%.3f" % x for x in job_s))
    phases = sorted({k for r in returned for k in r if k.endswith("_s")})
    if returned:
        unreported = [w - sum(r.get(k, 0.0) for k in phases)
                      for w, r in zip(job_s, reports.values()) if r is not None]
        say("phase means (s): " + " ".join(
            "%s=%.4f" % (k, sum(r.get(k, 0.0) for r in returned) / len(returned))
            for k in phases) + " unreported=%.4f harness=%.3f"
            % (sum(unreported) / len(unreported), keep_s))
    for i in sorted(range(len(kept)), key=lambda i: -job_s[i])[:3]:
        r = reports[kept[i].job.name] or {}
        say("slow job %s %.3f s: %s" % (kept[i].job.name, job_s[i], " ".join(
            "%s=%.3f" % (k, r[k]) for k in sorted(r) if k.endswith("_s"))))
    return result
