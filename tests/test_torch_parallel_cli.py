"""The port's two training CLIs under ``torchrun`` with two CPU ranks
(gloo), on tiny synthetic trees, against one process over the same
global batches; ``async_ckpt: true`` and auto-resume through the async
manager; and the multi-process dry run at four processes.

Dropout is on where the JAX CLIs put it (the ViT's and the final
feed-forward's, at their 0.1): every rank draws the global batch's masks and
keeps its own rows, so they are the one process's.  Tolerance of the saved
weights against the one-process run, after Adam steps at lr 1e-4: Adam moves an
entry by about lr x sign(g) per step, and a gradient within rounding of 0 may
take either sign on the two sides, so every entry is within 2 lr per step, and
all but 1% of each tensor's entries within 1e-6 x max(1, |p|). A rank that
averaged nothing, each on its own rows, would move most entries differently.
The cross-attention's key bias is held to the first bound only: the softmax
cancels it, so its gradient is zero in exact arithmetic and rounding noise on
both sides, which Adam scales to about lr.  Every ``torchrun`` has a timeout
that kills its process group.
"""

import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from gfe_mamba_torch.cli import classify_mamba, main_gan_vit
from gfe_mamba_torch.data.synthetic import (make_classify_tree,
                                            make_mri2pet_tree)
from gfe_mamba_torch.models.pipeline import build_generator
from gfe_mamba_torch.training.checkpoint import save_params_npz

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (16, 16, 8)
LR = 1e-4
TINY = dict(img_sz=[16, 16, 8], f_maps=[4, 8], fold_factor=2,
            vit_patch_size=4, vit_dim=16, vit_depth=1, vit_heads=2,
            vit_mlp_dim=32, num_workers=0, mixed_precision="none",
            log_every=1, seed=0, val_inter=1, save_inter=1, async_ckpt=True)


def _write(path, cf) -> str:
    def scalar(v):
        if isinstance(v, str):
            return f"'{v}'"
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, list):
            return "[" + ", ".join(str(x) for x in v) + "]"
        return repr(v)
    path.write_text("".join(f"{k}: {scalar(v)}\n" for k, v in cf.items()))
    return str(path)


def _start(args, cwd):
    """``python -m <args>`` in its own process group, on the CPU."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", *args], cwd=cwd,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _finish(proc, timeout=150) -> str:
    """The process's output once it exits 0; past ``timeout`` its whole
    process group is killed."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out
    return out


def _torchrun(module, cfg, cwd):
    """``torchrun --nproc_per_node 2 -m <module>`` with ``--device cpu``
    (started; :func:`_finish` collects it)."""
    return _start(["torch.distributed.run", "--standalone",
                   "--nproc_per_node", "2", "-m", module, "--config_path",
                   cfg, "--device", "cpu"], cwd)


@pytest.fixture(scope="module", autouse=True)
def dryrun():
    """The dry run at four processes, running beside this file's tests."""
    proc = _start(["gfe_mamba_torch.parallel.dryrun", "--procs", "4",
                   "--device", "cpu", "--timeout", "150"], REPO)
    yield proc
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


def _only_run(project_dir) -> str:
    runs = [r for r in os.listdir(project_dir) if r.startswith("exp_")]
    assert len(runs) == 1, runs
    return os.path.join(project_dir, runs[0])


def _assert_npz_close(got_path, want_path, steps):
    got, want = np.load(got_path), np.load(want_path)
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        diff = np.abs(got[key] - want[key])
        assert diff.max() <= 2.0001 * LR * steps, key
        if key.endswith("k_proj/bias"):
            continue            # its gradient is rounding noise (below)
        loose = diff > 1e-6 * np.maximum(1.0, np.abs(want[key]))
        assert loose.mean() <= 0.01, (key, loose.mean())


def test_stage1_cli_two_ranks_equals_one_process_and_resumes(tmp_path):
    train = make_mri2pet_tree(str(tmp_path / "train"), n_subjects=2,
                              shape=SHAPE)
    evald = make_mri2pet_tree(str(tmp_path / "eval"), n_subjects=1,
                              shape=SHAPE, seed=1)
    cf = dict(TINY, train_path=train, eval_path=evald, train_bc=2,
              eval_bc=1, num_epochs=2, warmup_epochs=1,
              autoresume_interval=100)
    ranks = dict(cf, project_dir=str(tmp_path / "ranks"))
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    proc = _torchrun("gfe_mamba_torch.cli.main_gan_vit",
                     _write(tmp_path / "ranks.yaml", ranks), str(cwd))
    one = dict(cf, project_dir=str(tmp_path / "one"))
    s1 = main_gan_vit.main(main_gan_vit.parse_args(
        "", "", ["--config_path", _write(tmp_path / "one.yaml", one),
                 "--device", "cpu"]))
    out = _finish(proc)
    # rank 0 alone prints, logs and writes
    assert out.count("epoch 2 step 0:") == 1, out
    assert os.listdir(cwd) == []
    assert sorted(os.listdir(tmp_path / "ranks")) == [
        "autoresume_main_gan_vit", _only_run(tmp_path / "ranks")
        .rsplit("/", 1)[-1]]
    run = _only_run(tmp_path / "ranks")
    assert sorted(os.listdir(os.path.join(run, "model_save"))) == [
        "index.json", "model.npz", "step_00000001", "step_00000002"]
    _assert_npz_close(os.path.join(run, "model_save", "model.npz"),
                      os.path.join(s1["exp_dir"], "model_save", "model.npz"),
                      steps=2)
    auto = sorted(os.listdir(tmp_path / "ranks" / "autoresume_main_gan_vit"))
    assert auto == ["index.json", "step_00000001", "step_00000002"]

    # a third epoch: both ranks restore step 2 from the async manager
    out = _finish(_torchrun("gfe_mamba_torch.cli.main_gan_vit",
                            _write(tmp_path / "ranks.yaml",
                                   dict(ranks, num_epochs=3)), str(cwd)))
    assert "[autoresume] restored step 2, resuming at epoch 3" in out, out
    assert "epoch 1 step" not in out and "epoch 3 step 0:" in out, out


def test_stage2_cli_two_ranks_equals_one_process(tmp_path):
    root = tmp_path / "cls"
    vol_dir, csv = make_classify_tree(str(root), n_items=6, shape=SHAPE)
    os.makedirs(root / "eval")
    for f in sorted(os.listdir(vol_dir))[4:]:
        shutil.move(os.path.join(vol_dir, f), root / "eval")
    npz = str(tmp_path / "generator.npz")
    save_params_npz(npz, build_generator(
        device="cpu", img_size=SHAPE, f_maps=(4, 8), fold_factor=2,
        vit_patch_size=4, vit_dim=16, vit_depth=1, vit_heads=2,
        vit_mlp_dim=32))
    cf = dict(TINY, train_path=vol_dir, eval_path=str(root / "eval"),
              table_path=csv, train_bc=2, eval_bc=2, num_epochs=1,
              gan_ckpt=npz, dim=16, depth=1, heads=2, seq_length=2,
              attn_dropout=0.0, ff_dropout=0.0)
    ranks = dict(cf, project_dir=str(tmp_path / "ranks"))
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    proc = _torchrun("gfe_mamba_torch.cli.classify_mamba",
                     _write(tmp_path / "ranks.yaml", ranks), str(cwd))
    one = dict(cf, project_dir=str(tmp_path / "one"))
    s2 = classify_mamba.main(classify_mamba.parse_args(
        "", "", ["--config_path", _write(tmp_path / "one.yaml", one),
                 "--device", "cpu"]))
    out = _finish(proc)
    assert out.count("Epoch 1: Acc:") == 1 and \
        out.count("Saved model") == 1, out
    assert os.listdir(cwd) == []
    run = _only_run(tmp_path / "ranks")
    for name in ("model_current.npz", "ft_model_current.npz"):
        _assert_npz_close(os.path.join(run, "model_current", name),
                          os.path.join(s2["exp_dir"], "model_current",
                                       name), steps=2)
    # the async manager's step holds what the npz files hold, in JAX keys
    step = np.load(os.path.join(run, "model_save", "step_00000001",
                                "arrays.npz"))
    for part, name in (("combiner", "model_current.npz"),
                       ("classifier", "ft_model_current.npz")):
        saved = np.load(os.path.join(run, "model_current", name))
        for key in saved.files:
            np.testing.assert_array_equal(step[f"{part}/{key}"], saved[key])


def test_dryrun_at_four_processes(dryrun):
    out = _finish(dryrun, timeout=200)
    assert "mesh={'data': 2, 'model': 2} stage 2" in out
    assert "warm-up gate off and on" in out
    assert "dryrun(4): ok" in out
