"""Each cell of the benchmark on the card, a short window each: the run
ends with one result line and ``correct`` true.  Needs an NVIDIA GPU
(``cuda`` marker); skips without one.

    python -m pytest portbench/tests/test_pb_card.py -q
"""

import json
import subprocess
import sys

import pytest
import torch

from portbench.core.registry import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", str(2 ** 31 + 101), "--seconds", "3",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
