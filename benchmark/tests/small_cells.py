"""A small copy of the benchmark's files for CPU runs: the real
BENCHMARK.json, metrics and mixes, with the genomes cut to `genome_mbp`
and the site mixes' jobs to `sites` guide sites. With `parked`, the copy
also lists the library cells whose files the benchmark keeps for a later
cell (PERF.md, Open questions), so that tests keep their mix and the
Cas12a configuration sound."""

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


PARKED_CONFIGS = [{"name": "cas12a_400mbp", "source": "a parked cell",
                   "file": "benchmark/configs/cas12a_400mbp.json",
                   "reduced": ["genome_mbp"], "why": "a parked cell"}]
PARKED_CELLS = [{"name": "%s.library" % c, "config": c, "traffic": "library",
                 "chips": 1, "why": "a parked cell"}
                for c in ("spcas9ngg_400mbp", "cas12a_400mbp")]


def small_root(tmp, genome_mbp=1.0, sites=500, check_rows=10_000, parked=False):
    root = str(tmp)
    os.makedirs(os.path.join(root, "benchmark", "configs"), exist_ok=True)
    shutil.copytree(os.path.join(REPO, "benchmark", "metrics"),
                    os.path.join(root, "benchmark", "metrics"))
    shutil.copytree(os.path.join(REPO, "benchmark", "traffic"),
                    os.path.join(root, "benchmark", "traffic"))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    if parked:
        bench["configs"] += PARKED_CONFIGS
        bench["workloads"] += PARKED_CELLS
    for name in os.listdir(os.path.join(REPO, "benchmark", "configs")):
        path = os.path.join("benchmark", "configs", name)
        cfg = json.load(open(os.path.join(REPO, path)))
        cfg["genome_mbp"] = genome_mbp
        json.dump(cfg, open(os.path.join(root, path), "w"))
    for name in os.listdir(os.path.join(root, "benchmark", "traffic")):
        path = os.path.join(root, "benchmark", "traffic", name)
        t = json.load(open(path))
        t["max_jobs_per_s"] = 200
        t["check_rows_per_job"] = check_rows
        if t["kind"] == "sites":
            t["sites_per_job"] = sites
        json.dump(t, open(path, "w"))
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root, bench
