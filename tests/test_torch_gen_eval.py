"""The port's Stage-1 evaluation and volume viewer
(``gfe_mamba_torch/cli/generation_evaluation.py``, ``cli/view_nii.py``)
against the JAX tools (``tools/generation_evaluation.py``,
``tools/view_nii.py``) on the CPU.

generation_evaluation: a tiny synthetic tree, JAX's generator weights
written by JAX's ``save_params_npz`` and read by both tools; each batch's
MSE within 1e-5 of JAX's (relative) and its PSNR within the shift that
such an MSE change makes (10 / ln 10 * 1e-5 dB: both tools take the
range from the same target), the printed line of the same form with
the same means to those tolerances, and every PNG grid within one grey
level of JAX's.

view_nii: the printed lines and the grid equal the JAX tool's, with and
without ``--normalize``.
"""

import argparse
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models.unet3d import ResidualMidUNet3DViT
from gfe_mamba_tpu.training.checkpoint import save_params_npz
from gfe_mamba_torch.cli import generation_evaluation, view_nii
from gfe_mamba_torch.data.png import read_png
from gfe_mamba_torch.data.synthetic import make_mri2pet_tree
from tools import generation_evaluation as jax_generation_evaluation
from tools import view_nii as jax_view_nii

torch.set_num_threads(2)

SHAPE = (16, 16, 8)
TINY = {"f_maps": (4, 8), "fold_factor": 2, "vit_patch_size": 4,
        "vit_dim": 16, "vit_depth": 1, "vit_heads": 2, "vit_mlp_dim": 32}


def _config(tmp_path) -> str:
    evald = make_mri2pet_tree(str(tmp_path / "eval"), n_subjects=4,
                              shape=SHAPE, seed=3)
    text = (f"eval_path: {evald}\neval_bc: 2\nimg_sz: [16, 16, 8]\n"
            f"f_maps: [4, 8]\n" + "".join(
                f"{k}: {v}\n" for k, v in TINY.items() if k != "f_maps"))
    path = tmp_path / "gan.yaml"
    path.write_text(text)
    return str(path)


def _jax_checkpoint(path: str) -> str:
    generator = ResidualMidUNet3DViT(1, 1, is_segmentation=False, **TINY)
    variables = generator.init(jax.random.key(7),
                               jnp.zeros((2,) + SHAPE + (1,)))
    save_params_npz(path, variables["params"])
    return path


def _grid(path) -> np.ndarray:
    return np.asarray(read_png(str(path))[0][..., 0], np.int32)


def test_generation_evaluation_equals_jax(tmp_path, monkeypatch, capsys):
    config = _config(tmp_path)
    ckpt = _jax_checkpoint(str(tmp_path / "g.npz"))

    panels, psnrs = [], []
    real_psnr, real_save = (jax_generation_evaluation.psnr,
                            jax_generation_evaluation.save_volume_grid)

    def psnr(a, b):
        psnrs.append(float(real_psnr(a, b)))
        return psnrs[-1]

    def save(panel, path):
        panels.append(np.asarray(panel))
        real_save(panel, path)

    monkeypatch.setattr(jax_generation_evaluation, "psnr", psnr)
    monkeypatch.setattr(jax_generation_evaluation, "save_volume_grid", save)
    jax_generation_evaluation.main(argparse.Namespace(
        config_path=config, ckpt=ckpt, num_batches=20,
        out_dir=str(tmp_path / "jax")))
    want_line = capsys.readouterr().out.strip().splitlines()[-1]

    got = generation_evaluation.main(generation_evaluation.parse_args(
        ["--config_path", config, "--ckpt", ckpt, "--out_dir",
         str(tmp_path / "port"), "--device", "cpu"]))
    got_line = capsys.readouterr().out.strip().splitlines()[-1]

    assert len(got["psnr"]) == len(psnrs) == 2
    w = SHAPE[0]
    want_mse = [float(np.mean((p[:, 2 * w:] - p[:, w:2 * w]) ** 2))
                for p in panels]
    np.testing.assert_allclose(got["mse"], want_mse, rtol=1e-5)
    np.testing.assert_allclose(got["psnr"], psnrs, rtol=0,
                               atol=10 / np.log(10) * 1e-5)
    form = re.compile(r"^batches=(\d+) PSNR=(-?\d+\.\d{3}) "
                      r"MSE=(\d+\.\d{6})$")
    got_m, want_m = form.match(got_line), form.match(want_line)
    assert got_m and want_m, (got_line, want_line)
    assert got_m[1] == want_m[1]
    assert abs(float(got_m[2]) - float(want_m[2])) <= 1e-3
    np.testing.assert_allclose(float(got_m[3]), float(want_m[3]), rtol=1e-5)
    for i in (1, 2):
        a, b = _grid(tmp_path / "port" / f"{i}.png"), \
            _grid(tmp_path / "jax" / f"{i}.png")
        assert a.shape == b.shape == (SHAPE[0] * 3, 8 * SHAPE[1])
        assert np.abs(a - b).max() <= 1


def test_generation_evaluation_takes_the_card_unless_asked(tmp_path):
    """Without ``--device`` the tool takes the card, and raises with none
    (this machine), as the other CLIs do."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    config = _config(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generation_evaluation.main(generation_evaluation.parse_args(
            ["--config_path", config, "--ckpt", "unused.npz"]))


@pytest.mark.parametrize("normalize", [False, True])
def test_view_nii_equals_jax(tmp_path, capsys, normalize):
    tree = make_mri2pet_tree(str(tmp_path / "t"), n_subjects=1,
                             shape=(12, 10, 11), seed=4)
    volume = os.path.join(tree, "subject_000", "pet.nii.gz")
    flags = ["--normalize"] if normalize else []
    jax_view_nii.main(argparse.Namespace(
        volume=volume, out=str(tmp_path / "jax.png"), normalize=normalize))
    want = capsys.readouterr().out.splitlines()
    out = view_nii.main(view_nii.parse_args(
        [volume, "--out", str(tmp_path / "port.png")] + flags))
    got = capsys.readouterr().out.splitlines()
    assert out == str(tmp_path / "port.png")
    assert got[0] == want[0] and len(got) == len(want) == 2
    a, b = _grid(tmp_path / "port.png"), _grid(tmp_path / "jax.png")
    assert a.shape == b.shape == (12 * 2, 8 * 10)
    np.testing.assert_array_equal(a, b)
