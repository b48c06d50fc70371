"""The PyTorch port runs where JAX is not installed.

A child process installs a meta-path hook that refuses every `jax` and
`jaxlib` import, then imports the port, its CLI, its experiment tool and
chip_smoke.py, and runs a small discover through the port's CLI and the
tool, on the CPU.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import importlib.abc, os, sys, tempfile

    class BlockJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError("jax is blocked in this process: " + name)
            return None

    sys.meta_path.insert(0, BlockJax())

    import chip_smoke
    import flashfry_tpu_torch
    import flashfry_tpu_torch.__main__
    from flashfry_tpu_torch import cli, device, engine
    from flashfry_tpu_torch.ops import _build, scan, scan_kernel, stage1_variants
    from flashfry_tpu_torch.tools import experiment_stage1

    import numpy as np
    from flashfry_tpu.database import build_database_from_sites, save_database
    from flashfry_tpu.discovery import find_target_sites
    from flashfry_tpu.standards import Cas9NGGParameterPack

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
                          "--device", "cpu"])
        assert report["guides"] > 0 and os.path.getsize(os.path.join(d, "out"))
    experiment_stage1.run(device="cpu", chunk=4096, G=64, reps=1)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    assert not loaded, loaded
    print("NO_JAX_OK")
""")


def test_port_and_chip_smoke_import_and_run_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
