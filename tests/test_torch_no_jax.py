"""The PyTorch port runs where neither JAX nor the JAX package is.

A child process installs a meta-path hook that refuses every import of
`jax`, `jaxlib`, the JAX package `flashfry_tpu` (exactly that top-level
name; `flashfry_tpu_torch` is the port), `bench` and `tools`, then imports
the port, its CLI, its experiment tool and chip_smoke.py, builds a database
with the port's own host modules and runs a small discover and score through
the port's CLI and the tool (X1 and X4 included) on the CPU.

A static check walks every module of the port and chip_smoke.py: none may
import those packages, nor name `flashfry_tpu` in what it hands a child
process.
"""

import ast
import os
import re
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flashfry_tpu", "bench", "tools")

CHILD = textwrap.dedent("""
    import importlib.abc, os, sys, tempfile

    BLOCKED = %r

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked in this process: " + name)
            return None

    sys.meta_path.insert(0, Block())

    import chip_smoke
    import flashfry_tpu_torch
    import flashfry_tpu_torch.__main__
    from flashfry_tpu_torch import cli, device, engine
    from flashfry_tpu_torch.ops import _build, scan, scan_kernel, stage1_variants
    from flashfry_tpu_torch.scoring import (aggregate, annotations, base, off_target,
                                            on_target, otbatch, rnafold)
    from flashfry_tpu_torch.scoring import device as scoring_device
    from flashfry_tpu_torch.tools import experiment_stage1

    import numpy as np
    from flashfry_tpu_torch.database import build_database_from_sites, save_database
    from flashfry_tpu_torch.discovery import find_target_sites
    from flashfry_tpu_torch.standards import Cas9NGGParameterPack

    rng = np.random.default_rng(1)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=30000))
    db = build_database_from_sites(
        find_target_sites(iter([("chrT", genome)]), Cas9NGGParameterPack), 7)
    with tempfile.TemporaryDirectory() as d:
        save_database(db, os.path.join(d, "db"))
        with open(os.path.join(d, "g.fa"), "w") as fh:
            fh.write(">g\\n" + genome[500:900] + "\\n")
        report = cli.run(["discover", "--fasta", os.path.join(d, "g.fa"),
                          "--database", os.path.join(d, "db"),
                          "--output", os.path.join(d, "out"),
                          "--positionOutput", "--device", "cpu"])
        assert report["guides"] > 0 and os.path.getsize(os.path.join(d, "out"))
        assert cli.run(["discover", "--fasta", os.path.join(d, "g.fa"),
                        "--database", os.path.join(d, "db"),
                        "--output", os.path.join(d, "out_np"),
                        "--backend", "numpy"])["guides"] == report["guides"]
        scored = [cli.run(["score", "--input", os.path.join(d, "out"),
                           "--database", os.path.join(d, "db"),
                           "--output", os.path.join(d, "scored_" + b),
                           "--scoringMetrics", "doench2016cfd,hsu2013,"
                           "jostandsantos,minot,dangerous,folding,rank",
                           "--backend", b, "--device", "cpu"])
                  for b in ("device", "numpy")]
        assert scored[0]["off_targets"] > 0 and scored[0]["device"] == "cpu"
        with open(os.path.join(d, "scored_device"), "rb") as a, \
                open(os.path.join(d, "scored_numpy"), "rb") as b:
            assert a.read() == b.read()
    experiment_stage1.run(device="cpu", chunk=4096, G=64, reps=1)
    experiment_stage1.run(device="cpu", chunk=4096, G=256, reps=1,
                          variants_spec="1,bf,g2bf")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NO_JAX_OK")
""" % (BLOCKED,))


def test_port_and_chip_smoke_import_and_run_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(os.path.join(ROOT, "flashfry_tpu_torch")):
        paths += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(paths)


NAMES_JAX_PACKAGE = re.compile(r"(?<![\w.])flashfry_tpu(?![\w])")
CHILD_CALLS = {"run", "Popen", "call", "check_call", "check_output", "system",
               "execv", "execve", "execvp", "execl", "spawnv", "popen"}


def import_faults(tree):
    """Absolute imports of a blocked package, as 'line: name'."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and isinstance(node.func, (ast.Name, ast.Attribute))
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        out += ["%d: %s" % (node.lineno, n) for n in names
                if n.split(".")[0] in BLOCKED]
    return out


def child_faults(tree):
    """Strings naming flashfry_tpu in the arguments of a call that starts a
    child process, directly or through a module-level name."""
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            text = " ".join(str(c.value) for c in ast.walk(node.value)
                            if isinstance(c, ast.Constant))
            for t in node.targets:
                if isinstance(t, ast.Name):
                    consts[t.id] = text
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in CHILD_CALLS):
            continue
        for sub in ast.walk(node):
            text = (str(sub.value) if isinstance(sub, ast.Constant)
                    else consts.get(sub.id, "") if isinstance(sub, ast.Name) else "")
            if NAMES_JAX_PACKAGE.search(text):
                out.append("%d: %r" % (sub.lineno, text[:80]))
    return out


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_module_imports_nothing_of_the_jax_package(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    assert import_faults(tree) == []
    assert child_faults(tree) == []


def test_static_check_catches_what_it_guards():
    bad = ast.parse(textwrap.dedent("""
        import bench
        import flashfry_tpu.cli as c
        from tools import experiment_stage1
        from flashfry_tpu.database import load_database
        import jax.numpy as jnp
        importlib.import_module("flashfry_tpu.engine")
        REF = "import flashfry_tpu.cli as c; c.main()"
        subprocess.run([sys.executable, "-c", REF])
        subprocess.run([sys.executable, "-m", "flashfry_tpu", "discover"])
    """))
    assert len(import_faults(bad)) == 6
    assert len(child_faults(bad)) == 2
    good = ast.parse(textwrap.dedent("""
        from . import native
        from .database import load_database
        import flashfry_tpu_torch.cli
        subprocess.run([sys.executable, "-m", "flashfry_tpu_torch", "discover"])
        logger = logging.getLogger("flashfry_tpu")
    """))
    assert import_faults(good) == [] and child_faults(good) == []
