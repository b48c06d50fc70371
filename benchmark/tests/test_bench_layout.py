"""BENCHMARK.json, its files found by name, and what the benchmark imports."""

import ast
import hashlib
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import harness
from small_cells import REPO, small_root

BENCH_DIR = os.path.join(REPO, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "flashfry_tpu", "bench", "tools", "chip_smoke"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# the plain reference and what it imports
REFERENCE_MODULES = ("reference", "sites", "genome", "check")


def bench():
    return json.load(open(os.path.join(REPO, "BENCHMARK.json")))


def test_keys_names_and_units():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    metrics = b["end_to_end"] + b["per_layer"]
    names = [x["name"] for x in b["configs"] + b["workloads"] + metrics]
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        e = [m["name"] for m in harness.cell_metrics(b, w["name"], False)]
        p = harness.cell_metrics(b, w["name"], True)
        assert "setup_s" in e and len(e) >= 2 and p
        for m in p:  # a per-layer metric's cell reports what it moves
            assert m["moves"] in e
    rs = b["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_configs_mixes_and_metrics_load_by_name():
    b = bench()
    for w in b["workloads"]:
        cell, config, traffic = harness.cell_files(b, w["name"])
        assert config["name"] == w["config"] and traffic["kind"] in ("sites", "regions")
        for key in config["reduced"]:
            assert key in [c for c in b["configs"] if c["name"] == w["config"]][0]["reduced"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_config_mix_and_metric_are_files_only(tmp_path):
    """A later PR adds a cell with a configuration, a mix and a per-layer
    metric of its own as new files and BENCHMARK.json entries; no file of
    the benchmark changes, and a run of the new cell reports the metric."""
    root, b = small_root(tmp_path, genome_mbp=0.5, sites=120)
    before = _digests(os.path.join(root, "benchmark"))
    cfg = json.load(open(os.path.join(root, "benchmark/configs/spcas9ngg_400mbp.json")))
    cfg["name"] = "spcas9ngg_small"
    cfg["discover"]["maxMismatch"] = 3
    json.dump(cfg, open(os.path.join(root, "benchmark/configs/spcas9ngg_small.json"), "w"))
    mix = json.load(open(os.path.join(root, "benchmark/traffic/library.json")))
    mix.update(sites_per_job=50)
    json.dump(mix, open(os.path.join(root, "benchmark/traffic/small_library.json"), "w"))
    with open(os.path.join(root, "benchmark/metrics/overflow_share.small.py"), "w") as fh:
        fh.write("def read(ctx):\n"
                 "    g = sum(r['guides'] for r in ctx.reports)\n"
                 "    return 100.0 * sum(r['overflowed_guides'] for r in ctx.reports) / g\n")
    b["configs"].append({"name": "spcas9ngg_small", "source": "a test",
                         "file": "benchmark/configs/spcas9ngg_small.json",
                         "reduced": ["genome_mbp"], "why": "a test"})
    b["workloads"].append({"name": "spcas9ngg_small.small_library", "config": "spcas9ngg_small",
                           "traffic": "small_library", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "job_s":
            m["workloads"].append("spcas9ngg_small.small_library")
    b["per_layer"].append({"name": "overflow_share.small", "unit": "%", "better": "lower",
                           "source": "program_counter", "layer": "collect",
                           "moves": "job_s",
                           "workloads": ["spcas9ngg_small.small_library"]})
    json.dump(b, open(os.path.join(root, "BENCHMARK.json"), "w"))
    b = harness.load_benchmark(root)
    result = harness.run_cell(b, "spcas9ngg_small.small_library", 5, 0.5, True,
                              device="cpu", root=root)
    assert result["correct"]
    assert "overflow_share.small" in result["metrics"]
    after = _digests(os.path.join(root, "benchmark"))
    assert {k: v for k, v in after.items() if k in before} == before


def _modules():
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "benchmark." + (node.module or "")
            elif node.module:
                yield node.module
            for a in node.names:
                if node.module in (None, "benchmark") or node.level:
                    yield "benchmark." + a.name


def test_no_module_imports_jax_or_the_jax_package():
    seen = 0
    for path in _modules():
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            seen += 1
    assert seen and "flashfry_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    todo, closure = ["benchmark." + m for m in REFERENCE_MODULES], set()
    while todo:
        mod = todo.pop()
        if mod in closure:
            continue
        closure.add(mod)
        path = os.path.join(REPO, *mod.split(".")) + ".py"
        for name in _imports(path):
            assert name.split(".")[0] != "flashfry_tpu_torch", (mod, name)
            if name.startswith("benchmark.") and os.path.exists(
                    os.path.join(REPO, *name.split(".")) + ".py"):
                todo.append(name)
    code = ("import sys; import benchmark.check, benchmark.reference; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('flashfry_tpu_torch', 'flashfry_tpu', 'jax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("workload", ["spcas9ngg_400mbp.locus"])
def test_run_refuses_without_a_card(workload, tmp_path):
    """run.py exits non-zero and prints no result where there is no card,
    and in a directory that holds only BENCHMARK.json and benchmark/."""
    code = "import torch; torch.cuda.is_available = lambda: False; " \
           "import runpy, sys; sys.argv = %r; runpy.run_path('benchmark/run.py', " \
           "run_name='__main__')" % (["benchmark/run.py", "--workload", workload,
                                      "--seed", "1", "--seconds", "1", "--trace", "0"],)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    alone = tmp_path / "alone"
    alone.mkdir()
    import shutil
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), alone)
    shutil.copytree(BENCH_DIR, alone / "benchmark")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=alone, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
