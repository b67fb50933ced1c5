"""The result line, and the runs that must print none."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.core import bench
from portbench.core.registry import PACKAGE, ROOT
from portbench.tests import tiny


def test_result_has_the_contract_keys(tmp_path):
    out = tiny.run(tiny.cell(tmp_path, "gfe_tiny.score_tiny"))
    assert list(out)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    assert isinstance(out["correct"], bool)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"volumes_per_s", "request_p95_ms",
                                   "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == {"logit_abs", "pet_rel"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_no_card_means_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = bench.main(["--workload", "gfe_mamba.score_b4", "--seed", "1",
                     "--seconds", "1", "--trace", "0"], 0.0)
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_alone_fails(tmp_path):
    """In a folder holding only BENCHMARK.json and the benchmark's files
    the run exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "gfe_mamba.score_b4", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_p95_is_nearest_rank():
    assert bench.p95(list(range(1, 101))) == 95
    assert bench.p95([3.0]) == 3.0


def test_judge_needs_every_number_under_its_limit(tmp_path):
    c = tiny.cell(tmp_path, "gfe_tiny.score_tiny")
    c.limits = {"a": 1.0, "b": 2.0}
    assert bench.judge(c, {"a": 0.5, "b": 1.0})[0]
    assert bench.judge(c, {"a": 0.5, "b": 1.0, "c": 9.0})[0]
    assert not bench.judge(c, {"a": 1.5, "b": 1.0})[0]
    assert not bench.judge(c, {"a": float("nan"), "b": 1.0})[0]
    assert not bench.judge(c, {"a": 0.0})[0]
    c.limits = {}
    assert not bench.judge(c, {"a": 0.0})[0]
