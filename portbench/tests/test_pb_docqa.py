"""The ``docqa`` cells' pieces on the CPU: a tiny Jamba cell (every kind
of layer) entered beside the real one and run as a cell, its greedy
answers against the reference, the per-layer readers on hand-built
traces, and the work counted for Jamba2-Mini."""

import json
import shutil
import time

import pytest

from portbench import jamba_work
from portbench.core import bench
from portbench.core.registry import PACKAGE, ROOT, Cell
from portbench.tests.test_pb_program_spans import FakeRun, FakeTrace, _op
from portbench.tests.tiny import FIXTURES

REAL = "jamba2_mini.docqa_b1"
TINY = "jamba_tiny.docqa_tiny"


def tiny_cell(tmp) -> Cell:
    """The fixture cell with the real cell's limits and metrics, in a copy
    of the benchmark's folders."""
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(PACKAGE / sub, tmp / sub, dirs_exist_ok=True)
        if (FIXTURES / sub).exists():
            shutil.copytree(FIXTURES / sub, tmp / sub, dirs_exist_ok=True)
    shutil.copy(PACKAGE / "limits" / f"{REAL}.json",
                tmp / "limits" / f"{TINY}.json")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "jamba_tiny", "source": "fixture",
                         "file": "portbench/tests/fixtures/configs/"
                                 "jamba_tiny.json",
                         "reduced": [], "why": "a CPU test"})
    b["workloads"].append({"name": TINY, "config": "jamba_tiny",
                           "traffic": "docqa_tiny", "chips": 1,
                           "why": "a CPU test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(TINY)
    return Cell(TINY, bench=b, package=tmp)


def test_greedy_answers_against_the_reference(tmp_path):
    """In float32 the logits each request chose its tokens from lie on
    the reference's, run layer by layer on the program's tokens; the fp8
    control lies far off."""
    c = tiny_cell(tmp_path)
    d = c.driver().Driver(c, 2 ** 31 + 3, "cpu")
    d.setup()
    for i in range(3):
        assert not d.item(i)
    d.release()
    gaps = d.check()
    assert gaps["logits_rel_max"] < 1e-5, gaps
    assert gaps["far_share"] == 0.0
    control = d.control("fp8")
    assert control["logits_rel_median"] > 100 * gaps["logits_rel_max"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs(tmp_path, trace):
    c = tiny_cell(tmp_path)
    out = bench.run_cell(c, 2 ** 31 + 77, 0.5, trace, time.perf_counter(),
                         device="cpu")
    assert out["correct"] and out["attempted"] >= 1 and not out["failed"]
    if trace:
        # the CPU's trace holds no device operation for the decode
        # readers to take
        assert {"mfu.docqa", "device_idle.docqa"} <= set(out["metrics"])
    else:
        assert {"request_p95_ms", "step_ms", "setup_s"} <= \
            set(out["metrics"])


def test_readers_take_the_prefill_experts_and_each_decode_span():
    """``moe_roofline.docqa`` counts the device time launched under
    ``gfe.moe.experts`` inside ``gfe.prefill`` only; the decode readers
    take the operations launched under ``gfe.decode`` and those linked to
    no launch (a graph replay's kernels), in runs of device time between
    other operations (a request's steps): ``decode_idle_ms.docqa`` the
    idle inside each request's
    stretch of them over the number of steps, ``decode_roofline.docqa``
    the steps' least time over their device time; a scoring run reads
    None."""
    host = [(0, 100, "gfe.prefill"), (10, 20, "gfe.moe.experts"),
            (30, 40, "gfe.moe.experts"), (200, 210, "gfe.moe.experts"),
            (200, 201, "gfe.decode"), (201, 202, "gfe.decode"),
            (400, 450, "gfe.prefill"), (450, 451, "gfe.decode")]
    device = [_op(11, 15, 12), _op(15, 19, 31), _op(50, 60, 50),
              _op(205, 225, 200.5), _op(230, 255), _op(420, 450, 410),
              _op(455, 475, 450.5)]
    run = FakeRun(FakeTrace(host, device), items=1,
                  traffic={"entry": "docqa", "lengths": [4467],
                           "new_tokens": 32})
    run.config = json.loads((PACKAGE / "configs" / "jamba2_mini.json")
                            .read_text())
    run.peak_flops, run.peak_bytes_per_s = 989e12, 3.35e12
    cell = Cell(REAL)
    from portbench.metrics.docqa import least_s, window_work
    least = least_s(run, "experts", "prefill")
    assert cell.reader("moe_roofline.docqa")(run) == pytest.approx(
        100 * least / 8e-3)
    # idle: 5 ms of [205, 255] and none of [455, 475], over 3 steps
    assert cell.reader("decode_idle_ms.docqa")(run) == pytest.approx(5 / 3)
    decode = sum(w.least_s(989e12, 3.35e12) for w in window_work(run)
                 if w.phase == "decode")
    assert decode == pytest.approx(31 * 6.32e9 / 3.35e12, rel=0.01)
    assert cell.reader("decode_roofline.docqa")(run) == pytest.approx(
        100 * decode / 65e-3)
    for metric in ("moe_roofline.docqa", "decode_idle_ms.docqa",
                   "decode_roofline.docqa"):
        assert cell.reader(metric)(FakeRun(
            FakeTrace(host, device), items=1,
            traffic={"entry": "score"})) is None


def test_work_of_the_docqa_cell():
    """Jamba2-Mini's routed work by hand: 5.78 GFLOP a prompt token
    outside attention and the head (7 Mamba layers 1.47, 4 dense MLPs
    1.41, 4 MoE layers at 2 of 16 experts 2.82, attention's projections
    0.08), 88.75 TFLOP a 15,024-token prefill with the causal attention;
    a decode step reads ~6.3 GB, the MoE layers 2 experts each."""
    cfg = json.loads((PACKAGE / "configs" / "jamba2_mini.json").read_text())
    ops = jamba_work.jamba_ops(cfg, 15024, 32)
    pre = [w for w in ops if w.phase == "prefill"]
    dec = [w for w in ops if w.phase == "decode"]
    per_token = sum(w.flops for w in pre if w.part != "head"
                    and not w.name.endswith("attend")) / 15024
    assert per_token == pytest.approx(5.7844e9, rel=1e-4)
    assert sum(w.flops for w in pre) == pytest.approx(88.7546e12, rel=1e-4)
    assert len(dec) == 31 * len([w for w in pre if w.part != "scan"])
    assert 6.3e9 < sum(w.nbytes for w in dec) / 31 < 6.4e9
    assert all(w.nbytes >= 2 * 3 * 4096 * 14336 * 2
               for w in dec if w.part == "experts")
    scan = [w for w in pre if w.part == "scan"]
    assert len(scan) == 7
    assert scan[0].nbytes == pytest.approx(0.987e9, rel=1e-3)
