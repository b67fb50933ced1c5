"""Tests of the benchmark.  They run on the CPU at tiny sizes; a test that
needs the card is marked ``cuda`` and skips inside itself without one.

    python -m pytest portbench/tests -q
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
