"""The readers of the program's spans (``metrics/program_spans.py`` and the
six metrics over it) on hand-built traces, and on a real CPU trace of a
tiny segmentation step."""

import tempfile

import pytest
import torch
from torch.autograd.profiler import record_function

from portbench.core.registry import Cell
from portbench.core.trace import Profiler, union

MS = 1_000_000                       # ns
WINDOW = 7                           # the window's thread
TRAIN = {"entry": "stage1", "train": True}
SCORE = {"entry": "score"}
TRAIN_METRICS = ("host_syncs.train", "forward_idle_ms.train",
                 "backward_idle_ms.train", "update_idle_ms.train",
                 "backward_device_ms.train")


class FakeTrace:
    """What the readers read of :class:`portbench.core.trace.Trace`."""

    def __init__(self, host, device, w0=0, w1=1000):
        self.host = sorted((s * MS, e * MS, n) for s, e, n in host)
        self.device = [(s * MS, e * MS, n, None if t is None else t * MS,
                        tid) for s, e, n, t, tid in device]
        self.merged = union([(s, e) for s, e, *_ in self.device])
        self.w0, self.w1 = w0 * MS, w1 * MS


class FakeRun:
    def __init__(self, trace, items, traffic=TRAIN):
        self.trace, self.items, self.traffic = trace, items, traffic


def read(metric, run):
    cell = "gfe_mamba.score_b4" if metric.endswith(".score") \
        else "gfe_mamba.stage1_b1"
    return Cell(cell).reader(metric)(run)


def _op(s, e, launch=None, tid=WINDOW):
    return (s, e, "kernel", launch, tid)


def test_idle_inside_merged_spans():
    """Overlapping spans count once; the device's busy cover comes off."""
    host = [(0, 40, "gfe.forward"), (30, 60, "gfe.forward"),
            (100, 120, "gfe.forward"), (0, 200, "gfe.step"),
            (0, 200, "aten::mm")]
    device = [_op(10, 20), _op(15, 18), _op(50, 110)]
    run = FakeRun(FakeTrace(host, device), items=2)
    # [0, 60]: 60 - 10 - 10 busy; [100, 120]: 20 - 10 busy
    assert read("forward_idle_ms.train", run) == pytest.approx(25.0)
    assert read("update_idle_ms.train", run) is None


def test_idle_spans_are_clipped_to_the_window():
    host = [(0, 100, "gfe.backward"), (0, 100, "gfe.step")]
    run = FakeRun(FakeTrace(host, [_op(50, 70)], w0=40, w1=90), items=1)
    assert read("backward_idle_ms.train", run) == pytest.approx(30.0)


def test_classifier_idle_per_request():
    host = [(0, 30, "gfe.classifier"), (50, 80, "gfe.classifier")]
    device = [_op(0, 10), _op(60, 90)]
    run = FakeRun(FakeTrace(host, device), items=2, traffic=SCORE)
    assert read("classifier_idle_ms.score", run) == pytest.approx(15.0)


def test_a_backward_launch_from_another_thread_counts():
    """Launches inside ``gfe.backward`` count whatever their thread; one
    before it on the window's thread and one after do not."""
    host = [(100, 200, "gfe.backward"), (0, 300, "gfe.step")]
    device = [_op(120, 130, launch=110, tid=99),      # autograd's thread
              _op(130, 150, launch=150, tid=WINDOW),
              _op(200, 260, launch=90, tid=WINDOW),   # before
              _op(260, 290, launch=210, tid=99),      # after
              _op(290, 295, launch=None)]             # no launch seen
    run = FakeRun(FakeTrace(host, device), items=2)
    assert read("backward_device_ms.train", run) == pytest.approx(15.0)


def test_sync_count_per_step():
    host = [(i * 100, i * 100 + 90, "gfe.step") for i in range(2)]
    host += [(i * 100 + j, i * 100 + j + 1, f"gfe.sync.s{j}")
             for i in range(2) for j in range(6)]
    host += [(995, 1005, "gfe.sync.late"), (1001, 1002, "gfe.sync.out")]
    run = FakeRun(FakeTrace(host, []), items=2)
    assert read("host_syncs.train", run) == pytest.approx(6.5)
    host = host[:-2]
    assert read("host_syncs.train", FakeRun(FakeTrace(host, []), 2)) == 6.0


@pytest.mark.parametrize("metric", TRAIN_METRICS +
                         ("classifier_idle_ms.score",))
def test_none_outside_the_cells_and_without_spans(metric):
    """A cell of the other kind reads None, and so does a program that
    opens no ``gfe.`` span (the parent of this change)."""
    spans = [(0, 50, n) for n in ("gfe.step", "gfe.forward", "gfe.backward",
                                  "gfe.update", "gfe.sync.loss",
                                  "gfe.classifier")]
    device = [_op(0, 10, launch=5)]
    other = SCORE if metric in TRAIN_METRICS else TRAIN
    assert read(metric, FakeRun(FakeTrace(spans, device), 1, other)) is None
    mine = TRAIN if metric in TRAIN_METRICS else SCORE
    bare = FakeTrace([(0, 50, "pb.item"), (1, 2, "aten::mm")], device)
    assert read(metric, FakeRun(bare, 1, mine)) is None
    assert read(metric, FakeRun(FakeTrace(spans, device), 1, mine)) \
        is not None


def test_a_real_cpu_trace_of_a_segmentation_step():
    """The program's spans reach ``Trace.host``: one sync per step, and
    with no device every phase is idle for as long as it is open."""
    from gfe_mamba_torch.models.unet3d import get_model
    from gfe_mamba_torch.segmentation.trainer import UNetTrainer

    model = get_model(dict(name="UNet3D", f_maps=8, num_levels=2,
                           num_groups=2), seed=4)
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = UNetTrainer(model, {"loss": {"name": "BCEDiceLoss"},
                                      "eval_metric": {"name":
                                                      "DiceCoefficient"}},
                              ckpt, device="cpu")
        trainer.init_state(seed=4)
        g = torch.Generator().manual_seed(5)
        raw = torch.randn(1, 8, 8, 8, 1, generator=g)
        label = (torch.rand(1, 8, 8, 8, 1, generator=g) > 0.5).float()
        trainer.train_step(raw, label)
        prof = Profiler()
        prof.start()
        with record_function("pb.window"):
            for _ in range(3):
                trainer.train_step(raw, label)
        trace = prof.stop()
    run = FakeRun(trace, items=3, traffic={"entry": "seg_train",
                                           "train": True})
    assert read("host_syncs.train", run) == 1.0
    assert read("backward_device_ms.train", run) == 0.0
    steps = [e - s for s, e, n in trace.host if n == "gfe.step"]
    phases = sum(read(f"{p}_idle_ms.train", run)
                 for p in ("forward", "backward", "update"))
    assert len(steps) == 3
    assert 0.9 * sum(steps) / 3 / 1e6 < phases <= sum(steps) / 3 / 1e6
