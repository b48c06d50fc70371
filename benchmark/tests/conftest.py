"""Tests of the benchmark (benchmark/). They run on the CPU; a test that
needs a CUDA card is marked `gpu` and skips without one:

    python -m pytest benchmark/tests -q
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: tests that need a CUDA card (skip without one)")
