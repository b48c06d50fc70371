"""On a CUDA card: one short run of every cell through benchmark/run.py.

    python -m pytest benchmark/tests/test_bench_gpu.py -q
"""

import json
import os
import subprocess
import sys

import pytest

from small_cells import REPO


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in json.load(
    open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]])
def test_short_run_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                           "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
