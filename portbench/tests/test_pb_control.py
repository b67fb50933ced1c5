"""``correct`` must come out false for the control and for each fault
the cell can have, at a size a test run holds, on the CPU, under the
real cells' limits.

The control is the reference computed one precision below the
configuration's (fp8 below bfloat16, TF32 below float32) in the
program's place.  The faults are planted in the program underneath a
whole run (set-up, window, check): a step that leaves the state
unchanged, half of the batch left out with the mean taken over the rest
(the one training cell at batch 2), and an answer altered where it is
produced (scoring).  One chip has no exchange between chips to leave
out.  The fault runs compute in float32, where the program and the
reference agree to rounding, so that only the fault can fail them."""

import pytest
import torch

from portbench.core import bench
from portbench.tests import tiny

CONTROLS = [("gfe_tiny.score_tiny", "fp8"), ("unet_tiny.seg_tiny", "tf32"),
            ("gfe_tiny.stage2_tiny", "fp8"), ("gfe_tiny.stage1_tiny", "fp8")]


def f32(c):
    if "dtype" in c.config and "generator" in c.config:
        c.config["dtype"] = "float32"
    for stage in ("stage1", "stage2"):
        if stage in c.config:
            c.config[stage]["mixed_precision"] = "none"
    return c


@pytest.mark.parametrize("name,precision", CONTROLS)
def test_control_is_not_correct(tmp_path, name, precision):
    c = tiny.cell(tmp_path, name)
    assert c.limits, f"no limits for {name}"
    d = c.driver().Driver(c, 2 ** 31 + 21, "cpu")
    d.setup()
    for i in range(2):
        d.item(i)
    d.release()
    ok, checks = bench.judge(c, d.control(precision))
    assert not ok, checks


@pytest.mark.parametrize("name", [n for n, _ in CONTROLS])
def test_sound_run_is_correct(tmp_path, name):
    out = tiny.run(f32(tiny.cell(tmp_path, name)))
    assert out["correct"], out["checks"]


def no_step(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)


@pytest.mark.parametrize("name", ["unet_tiny.seg_tiny",
                                  "gfe_tiny.stage2_tiny",
                                  "gfe_tiny.stage1_tiny"])
def test_state_left_unchanged(tmp_path, monkeypatch, name):
    c = f32(tiny.cell(tmp_path, name))
    no_step(monkeypatch)
    out = tiny.run(c)
    assert not out["correct"], out["checks"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch(tmp_path, monkeypatch):
    from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
    original = ClassifyTrainer.train_step

    def half(self, mri, x_cat, x_num, labels):
        n = mri.shape[0] // 2
        return original(self, mri[:n], x_cat[:n], x_num[:n], labels[:n])
    monkeypatch.setattr(ClassifyTrainer, "train_step", half)
    out = tiny.run(f32(tiny.cell(tmp_path, "gfe_tiny.stage2_tiny")))
    assert not out["correct"], out["checks"]


def test_answer_altered(tmp_path, monkeypatch):
    from gfe_mamba_torch.models.pipeline import GFEMamba
    original = GFEMamba.forward

    def altered(self, *args, **kwargs):
        logits, pet = original(self, *args, **kwargs)
        return logits + 0.5, pet
    monkeypatch.setattr(GFEMamba, "forward", altered)
    out = tiny.run(f32(tiny.cell(tmp_path, "gfe_tiny.score_tiny")))
    assert not out["correct"], out["checks"]


def test_generated_volume_altered(tmp_path, monkeypatch):
    from gfe_mamba_torch.models.pipeline import GFEMamba
    original = GFEMamba.forward

    def altered(self, *args, **kwargs):
        logits, pet = original(self, *args, **kwargs)
        return logits, pet * 1.05
    monkeypatch.setattr(GFEMamba, "forward", altered)
    out = tiny.run(f32(tiny.cell(tmp_path, "gfe_tiny.score_tiny")))
    assert not out["correct"], out["checks"]
