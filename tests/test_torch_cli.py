"""The port's three entry points on the CPU at tiny widths
(``--device cpu``): Stage 1 -> Stage 2 -> evaluation end to end with the
files each writes, the tableless Stage 2, a kill-and-restart of the
Stage-1 CLI that resumes at the right epoch, and the options a single
process refuses.
"""

import argparse
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gfe_mamba_torch.cli import classify_mamba, main_gan_vit, test_mamba
from gfe_mamba_torch.data.synthetic import (make_classify_tree,
                                            make_mri2pet_tree)
from gfe_mamba_torch.models.pipeline import build_generator
from gfe_mamba_torch.training.checkpoint import load_params_npz

# one thread: the evaluation CLI's metrics are held bitwise against the
# Stage-2 validation's (with two, the CPU's f32 reductions differ in the
# last bits now and then)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (16, 16, 8)
TINY = """img_sz: [16, 16, 8]
f_maps: [4, 8]
fold_factor: 2
vit_patch_size: 4
vit_dim: 16
vit_depth: 1
vit_heads: 2
vit_mlp_dim: 32
num_workers: 0
mixed_precision: none
log_every: 1
seed: 0
"""


def _gan_config(tmp_path, num_epochs, **extra) -> str:
    train = make_mri2pet_tree(str(tmp_path / "gtrain"), n_subjects=2,
                              shape=SHAPE)
    evald = make_mri2pet_tree(str(tmp_path / "geval"), n_subjects=1,
                              shape=SHAPE, seed=1)
    text = TINY + (f"train_path: {train}\neval_path: {evald}\ntrain_bc: 1\n"
                   f"eval_bc: 1\nnum_epochs: {num_epochs}\nval_inter: 1\n"
                   f"save_inter: 1\nproject_dir: {tmp_path / 'weights'}\n"
                   f"autoresume_interval: 100\n")
    text += "".join(f"{k}: {v}\n" for k, v in extra.items())
    path = tmp_path / "gan.yaml"
    path.write_text(text)
    return str(path)


def _classify_config(tmp_path, name, gan_ckpt, table=True, **extra) -> str:
    """4 train and 2 eval items joined to one CSV."""
    root = tmp_path / "cls"
    if not root.exists():
        vol_dir, _ = make_classify_tree(str(root), n_items=6, shape=SHAPE)
        os.makedirs(root / "eval")
        for f in sorted(os.listdir(vol_dir))[4:]:
            shutil.move(os.path.join(vol_dir, f), root / "eval")
    text = TINY + (f"train_path: {root / 'volumes'}\n"
                   f"eval_path: {root / 'eval'}\n"
                   f"table_path: '{root / 'table.csv' if table else ''}'\n"
                   f"train_bc: 2\neval_bc: 2\nnum_epochs: 1\nval_inter: 1\n"
                   f"save_inter: 1\ngan_ckpt: {gan_ckpt}\ndim: 16\n"
                   f"depth: 1\nheads: 2\nseq_length: 2\n"
                   f"project_dir: {tmp_path / 'weights' / 'classifier'}\n")
    text += "".join(f"{k}: {v}\n" for k, v in extra.items())
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _args(path):
    return argparse.Namespace(config_path=path, device="cpu")


def test_stage1_stage2_evaluation_end_to_end(tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.chdir(tmp_path)
    s1 = main_gan_vit.main(_args(_gan_config(tmp_path, 2)))
    run1 = s1["exp_dir"]
    for rel in ("gan.yaml", "train_loss.txt", "model_save/model.npz",
                "model_save/state", "results_save/1/1.png",
                "results_save/2/1.png"):
        assert os.path.isfile(os.path.join(run1, rel)), rel
    auto = tmp_path / "weights" / "autoresume_main_gan_vit"
    assert sorted(os.listdir(auto)) == ["auto_0", "auto_1"]
    assert len(s1["step_ms"]) == 4
    end_state = {k: v.clone()
                 for k, v in s1["trainer"].generator.state_dict().items()}

    npz = os.path.join(run1, "model_save", "model.npz")
    s2 = classify_mamba.main(_args(_classify_config(tmp_path, "cls.yaml",
                                                    npz)))
    for key, value in s2["trainer"].model.generator.state_dict().items():
        assert torch.equal(value, end_state[key]), key
    run2 = s2["exp_dir"]
    for rel in ("model_best/best_model.npz", "model_best/best_ft_model.npz",
                "model_current/model_current.npz",
                "model_current/ft_model_current.npz",
                "table_preprocessor.json", "val_data/epoch_1_data.npz"):
        assert os.path.isfile(os.path.join(run2, rel)), rel
    assert "Epoch 1: Acc:" in open(os.path.join(run2,
                                                "train_loss.txt")).read()

    capsys.readouterr()
    cfg = _classify_config(tmp_path, "test.yaml", npz,
                           pth_dir=os.path.join(run2, "model_current"),
                           use_best="false")
    s3 = test_mamba.main(_args(cfg))
    printed = capsys.readouterr().out
    model2 = s2["trainer"].model
    for part in ("combiner", "classifier"):
        for key, value in getattr(s3["model"], part).state_dict().items():
            assert torch.equal(value, getattr(model2, part).state_dict()[key])
    val = s2["validation"]
    assert s3["metrics"] == val["metrics"]
    assert s3["val_loss"] == val["val_loss"]
    m = val["metrics"]
    for line in (f"Acc: {m['accuracy'] * 100: .4f}",
                 f"Recall: {m['recall']: .4f}", f"F1: {m['f1']:.4f}",
                 f"Pre: {m['precision']:.4f}", f"MCC: {m['mcc']:.4f}",
                 f"Val_loss: {val['val_loss']: .4f}"):
        assert line in printed, (line, printed)
    assert os.path.isfile(tmp_path / "debug.txt")


def test_stage2_tableless_and_flax_init(tmp_path, monkeypatch):
    """``table_path: ''``: zero-width table inputs; ``cls_init: flax``
    draws the model again before the Stage-1 weights load.  Stage 1 runs
    with ``is_debug`` (its files in the working directory)."""
    monkeypatch.chdir(tmp_path)
    s1 = main_gan_vit.main(_args(_gan_config(tmp_path, 1, is_debug="true")))
    npz = os.path.join(s1["exp_dir"], "model_save", "model.npz")
    s2 = classify_mamba.main(_args(_classify_config(
        tmp_path, "cls.yaml", npz, table=False, cls_init="flax")))
    model = s2["trainer"].model
    assert model.classifier.categorical_embeds is None
    assert model.classifier.numerical_embedder is None
    # a zero bias after two Adam steps of lr 1e-4 (the torch law draws it
    # from U(-1/4, 1/4) at width 16)
    assert float(model.classifier.to_logits[1].bias.detach().abs().max()) \
        < 1e-3
    loaded = model.generator.state_dict()
    ref = build_generator(device="cpu", img_size=SHAPE, f_maps=(4, 8),
                          fold_factor=2, vit_patch_size=4, vit_dim=16,
                          vit_depth=1, vit_heads=2, vit_mlp_dim=32)
    load_params_npz(npz, ref)
    for key, value in ref.state_dict().items():
        assert torch.equal(loaded[key], value), key


def test_cli_refuses_what_one_process_cannot_do(tmp_path, monkeypatch):
    cfg = _gan_config(tmp_path, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        main_gan_vit.main(argparse.Namespace(config_path=cfg, device=None))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="WORLD_SIZE"):
        main_gan_vit.main(_args(cfg))
    monkeypatch.delenv("WORLD_SIZE")
    with open(cfg, "a") as f:
        f.write("async_ckpt: true\n")
    with pytest.raises(NotImplementedError, match="async_ckpt"):
        main_gan_vit.main(_args(cfg))


def test_stage1_cli_kill_and_restart_resumes_at_right_epoch(tmp_path):
    cfg = _gan_config(tmp_path, 3)
    cmd = [sys.executable, "-u", "-m", "gfe_mamba_torch.cli.main_gan_vit",
           "--config_path", cfg, "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env,
                         cwd=str(tmp_path))
    lines, deadline = [], time.time() + 120
    try:
        while time.time() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("epoch 2 step"):
                os.kill(p.pid, signal.SIGKILL)
                break
        assert any(l.startswith("epoch 2 step") for l in lines), \
            "".join(lines)
    finally:
        p.kill()
        p.wait(timeout=30)

    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[autoresume] restored step 2, resuming at epoch 2" \
        in out.stdout, out.stdout
    assert not any(l.startswith("epoch 1 step")
                   for l in out.stdout.splitlines()), out.stdout
    assert "epoch 3 step 1" in out.stdout, out.stdout
    runs = sorted(os.listdir(tmp_path / "weights"))
    assert "autoresume_main_gan_vit" in runs
    assert np.load(os.path.join(tmp_path, "weights", [
        r for r in runs if r.startswith("exp_")][-1], "model_save",
        "model.npz")).files
