"""The port's entry points on the CPU at tiny widths (``--device cpu``):
Stage 1 -> Stage 2 -> evaluation end to end with the files each writes,
Stage 2 and evaluation with the Jamba and transformer mixers, the
tableless Stage 2, a kill-and-restart of the Stage-1 CLI that resumes at
the right epoch, the options a single process refuses, and the
table-only ``ft_table`` against the JAX script on the same CSV.
"""

import argparse
import importlib.util
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gfe_mamba_torch.cli import (classify_mamba, ft_table, main_gan_vit,
                                 test_mamba)
from gfe_mamba_torch.data.synthetic import (make_classify_tree,
                                            make_mri2pet_tree)
from gfe_mamba_torch.data.table import prepare_table, read_csv
from gfe_mamba_torch.models.dropout import Dropout
from gfe_mamba_torch.models.pipeline import build_generator
from gfe_mamba_torch.training.checkpoint import (load_params_npz,
                                                 save_params_npz)

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
    """No card without ``--device cpu``; a multi-process launch whose
    process group cannot form raises rather than training alone;
    ``async_ckpt: true`` (once refused) now writes its step directory."""
    monkeypatch.chdir(tmp_path)
    cfg = _gan_config(tmp_path, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        main_gan_vit.main(argparse.Namespace(config_path=cfg, device=None))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="RANK is not set"):
        main_gan_vit.main(_args(cfg))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        main_gan_vit.main(_args(cfg))
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    with open(cfg, "a") as f:
        f.write("async_ckpt: true\nautoresume: false\n")
    s1 = main_gan_vit.main(_args(cfg))
    assert os.path.isfile(os.path.join(s1["exp_dir"], "model_save",
                                       "step_00000001", "arrays.npz"))


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


@pytest.mark.parametrize("mixer", ["jamba", "transformer"])
def test_stage2_and_evaluation_other_mixers(tmp_path, monkeypatch, mixer):
    """``mixer`` from the YAML, with the config's ``attn_dropout`` and
    ``ff_dropout`` in the classifier (drawn in Stage 2's steps); the
    evaluation CLI on the saved npz gives Stage 2's last validation.
    Jamba at depth 3 has its attention layer (8 heads)."""
    monkeypatch.chdir(tmp_path)
    npz = str(tmp_path / "generator.npz")
    save_params_npz(npz, build_generator(
        device="cpu", img_size=SHAPE, f_maps=(4, 8), fold_factor=2,
        vit_patch_size=4, vit_dim=16, vit_depth=1, vit_heads=2,
        vit_mlp_dim=32))
    extra = dict(mixer=f"'{mixer}'", attn_dropout=0.2, ff_dropout=0.3)
    if mixer == "jamba":
        extra.update(depth=3, heads=8)
    s2 = classify_mamba.main(_args(_classify_config(tmp_path, "cls.yaml",
                                                    npz, **extra)))
    model = s2["trainer"].model
    rates = sorted({m.p for m in model.classifier.modules()
                    if isinstance(m, Dropout)})
    if mixer == "jamba":
        attn = model.classifier.transformer.layers[4].self_attn
        assert attn.attn_drop.p == 0.2
        assert rates == [0.1, 0.2]      # 0.1: the final feed-forward
    else:
        assert rates == [0.1, 0.2, 0.3]
    cfg = _classify_config(tmp_path, "test.yaml", npz,
                           pth_dir=os.path.join(s2["exp_dir"],
                                                "model_current"),
                           use_best="false", **extra)
    s3 = test_mamba.main(_args(cfg))
    for part in ("combiner", "classifier"):
        for key, value in getattr(s3["model"], part).state_dict().items():
            assert torch.equal(value, getattr(model, part).state_dict()[key])
    assert s3["metrics"] == s2["validation"]["metrics"]
    assert s3["val_loss"] == s2["validation"]["val_loss"]


def _ft_csv(path) -> str:
    """40 rows, 3 without a label; ROWNUM (a numeric column) names each
    row in the standardized inputs."""
    rng = np.random.RandomState(7)
    lines = ["PTID,EXAMDATE,LABEL,ROWNUM,AGE,MMSE,PTGENDER,PTMARRY"]
    for i in range(40):
        label = "" if i in (5, 17, 30) else str(rng.randint(0, 2))
        lines.append(f"{i:03d}_S_{i},2006-03-01,{label},{i},"
                     f"{rng.uniform(60, 90):.3f},{rng.randint(20, 31)},"
                     f"{rng.choice(['Male', 'Female'])},"
                     f"{rng.choice(['Married', 'Widowed'])}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_ft_table_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """The same CSV through ``ft_table.py`` and the port's
    ``cli/ft_table.py``: the same test rows, the same training batches in
    every epoch, and printed lines of the same form at the same
    epochs."""
    csv = _ft_csv(tmp_path / "table.csv")
    argv = ["--table_path", csv, "--epochs", "3", "--dim", "8", "--depth",
            "1", "--heads", "2", "--batch", "4", "--log_every", "2",
            "--seed", "3"]
    spec = importlib.util.spec_from_file_location(
        "jax_ft_table", os.path.join(REPO, "ft_table.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    seen, jnp = [], script.jnp

    class RecordingJnp:
        """``jnp`` with every ``asarray`` argument recorded."""

        def __getattr__(self, name):
            return getattr(jnp, name)

        def asarray(self, a, *args, **kw):
            seen.append(np.array(a))
            return jnp.asarray(a, *args, **kw)

    monkeypatch.setattr(script, "jnp", RecordingJnp())
    parser = argparse.ArgumentParser()
    for name, kind in (("table_path", str), ("epochs", int), ("dim", int),
                       ("depth", int), ("heads", int), ("batch", int),
                       ("split", float), ("lr", float), ("seed", int),
                       ("log_every", int)):
        parser.add_argument(f"--{name}", type=kind,
                            default=dict(split=0.8, lr=1e-4).get(name))
    capsys.readouterr()
    script.main(parser.parse_args(argv))
    jax_lines = capsys.readouterr().out.strip().splitlines()

    port = ft_table.main(ft_table.parse_args(argv + ["--device", "cpu"]))
    port_lines = capsys.readouterr().out.strip().splitlines()
    assert port_lines == port["lines"]

    # rows back from the recorded numeric inputs through ROWNUM
    prep = prepare_table(ft_table.labelled_rows(read_csv(csv)))
    pre = prep["preprocessor"]
    col = pre.num_columns.index("ROWNUM")
    ncont = prep["num_cont"]

    def rows(conti):
        return np.rint(conti[:, col] * pre.num_std["ROWNUM"]
                       + pre.num_mean["ROWNUM"]).astype(int)

    conti = [a for a in seen if a.ndim == 2 and a.shape[1] == ncont
             and a.dtype == np.float32][1:]           # [0]: the init's
    row_id = np.asarray(ft_table.labelled_rows(read_csv(csv))
                        .data["ROWNUM"])
    n_batches = len(port["batches"][0])
    assert n_batches == int(37 * 0.8) // 4
    want = iter(conti)
    for epoch, batches in enumerate(port["batches"]):
        for idx in batches:
            np.testing.assert_array_equal(rows(next(want)), row_id[idx])
        if (epoch + 1) % 2 == 0 or epoch == 2:
            np.testing.assert_array_equal(rows(next(want)),
                                          row_id[port["test_rows"]])
    assert next(want, None) is None

    form = re.compile(r"^epoch (\d+): loss=\d+\.\d{4} acc=\d\.\d{4} "
                      r"f1=\d\.\d{4} mcc=-?\d\.\d{4}$")
    assert [form.match(l).group(1) for l in jax_lines] == ["2", "3"]
    assert [form.match(l).group(1) for l in port_lines] == ["2", "3"]
