"""Each reference against gfe_mamba_torch on the CPU at a tiny size, in
float32: the same weights and inputs give the same outputs, losses,
gradients and updates to rounding.  The test imports both; the
reference imports nothing of the program."""

import torch

from portbench.tests import tiny


def driver(tmp_path, name, **config):
    c = tiny.cell(tmp_path, name)
    for key, value in config.items():
        section, _, field = key.partition("__")
        if field:
            c.config[section][field] = value
        else:
            c.config[section] = value
    d = c.driver().Driver(c, 2 ** 31 + 3, "cpu")
    d.setup()
    return d


def test_scoring_forward(tmp_path):
    d = driver(tmp_path, "gfe_tiny.score_tiny", dtype="float32")
    for i in range(3):
        d.item(i)
    d.release()
    gaps = d.check()
    assert gaps["logit_abs"] < 1e-4, gaps
    assert gaps["pet_rel"] < 1e-5, gaps


def test_segmentation_steps(tmp_path):
    d = driver(tmp_path, "unet_tiny.seg_tiny")
    d.release()
    gaps = d.check()
    assert max(gaps.values()) < 1e-4, gaps


def test_stage2_steps(tmp_path):
    """The program's step in float32 (mixed precision off) and the
    reference's, dropout masks included."""
    d = driver(tmp_path, "gfe_tiny.stage2_tiny",
               stage2__mixed_precision="none")
    d.release()
    gaps = d.check()
    assert max(gaps.values()) < 1e-4, gaps


def test_rounding_passes_gradients():
    from portbench.reference.precision import Rounding
    t = torch.tensor([1.0 + 2 ** -12, 3.0], requires_grad=True)
    for name in ("tf32", "fp8"):
        y = Rounding(name)(t)
        y.sum().backward()
        assert torch.equal(t.grad, torch.ones(2))
        t.grad = None
    assert Rounding("tf32")(t)[0].item() == 1.0
