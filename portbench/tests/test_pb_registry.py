"""The harness finds every piece by name, and a configuration, a mix and
a metric added as files and entries run without a change to code."""

import json

import pytest

from portbench.core.registry import PACKAGE, ROOT, Cell
from portbench.tests import tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(name):
    c = Cell(name)
    assert c.config["name"] == c.workload["config"]
    assert (PACKAGE / "traffic" / f"{c.workload['traffic']}.json").exists()
    assert c.driver().Driver
    assert set(c.limits), f"{name} has no correctness limits"
    assert c.end_to_end() and c.per_layer()
    assert any(m["name"] == "setup_s" for m in c.end_to_end())
    moves = {m["moves"] for m in c.per_layer()}
    assert moves <= {m["name"] for m in c.end_to_end()}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_metric_has_a_reader(metric):
    assert callable(Cell(BENCH["workloads"][0]["name"]).reader(metric))


@pytest.mark.parametrize("entry", ["configs", "workloads"])
def test_files_named_in_the_benchmark_exist(entry):
    for item in BENCH[entry]:
        if entry == "configs":
            assert (ROOT / item["file"]).exists()
            assert item["file"] == f"portbench/configs/{item['name']}.json"
        else:
            assert (PACKAGE / "traffic" / f"{item['traffic']}.json").exists()


def test_added_files_run_without_code_changes(tmp_path):
    """A fixture configuration, mix and metric, entered in the benchmark
    and added as files only, run as a cell and are read by name."""
    c = tiny.cell(tmp_path, "unet_tiny.seg_tiny")
    assert c.config["name"] == "unet_tiny"
    assert c.traffic["entry"] == "seg_train"
    assert "items.fixture" in [m["name"] for m in c.per_layer()]
    out = tiny.run(c)
    assert out["attempted"] >= 1 and "step_ms" in out["metrics"]

    class Fake:
        items = out["attempted"]
    assert c.reader("items.fixture")(Fake()) == float(out["attempted"])
