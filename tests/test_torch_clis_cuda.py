"""The entry points a user runs and the parallel layer, on the card at the
canonical widths (160x160x96, f_maps 64/128/256, dim 512, depth 6, bf16)
over synthetic trees in a temporary directory.  Every test needs an
NVIDIA GPU (``cuda`` marker) and skips without one; the file imports
torch and the port only::

    python -m pytest --noconftest -m cuda tests/test_torch_clis_cuda.py -q

The Stage-1 -> Stage-2 -> evaluation run (``phase12``) takes the
process's own TF32 settings, as a user's run has them, so that
``torchrun``'s fresh processes write the same weights bit for bit.
"""

import argparse
import contextlib
import copy
import io
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gfe_mamba_torch import testing
from gfe_mamba_torch.ops.cuda import conv3d as k1
from gfe_mamba_torch.ops.cuda import selective_scan as k2
from gfe_mamba_torch.testing import CANONICAL, CANONICAL_IMG, yaml_text

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = CANONICAL_IMG
# a fresh process's TF32 settings, read before any test changes them
PROCESS_TF32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _config(root, name, cf):
    """``cf`` as ``<root>/<name>.yaml``; the CLIs' argument namespace."""
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(yaml_text(cf))
    return argparse.Namespace(config_path=path, device="cuda")


def _run_dir(project_dir):
    """The one ``exp_*`` run directory a CLI wrote under ``project_dir``."""
    runs = [r for r in os.listdir(project_dir) if r.startswith("exp_")]
    assert len(runs) == 1, (project_dir, runs)
    return os.path.join(project_dir, runs[0])


def _state(module):
    return {k: v.detach().cpu().clone()
            for k, v in module.state_dict().items()}


def _states_equal(a, b):
    return a.keys() == b.keys() and all(
        torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def _adam_equal(a, b):
    """Two ``torch.optim.Adam`` state dicts, every tensor bitwise."""
    sa, sb = a["state"], b["state"]
    return sa.keys() == sb.keys() and all(
        sa[i].keys() == sb[i].keys()
        and all(torch.equal(torch.as_tensor(sa[i][k]).cpu(),
                            torch.as_tensor(sb[i][k]).cpu())
                for k in sa[i]) for i in sa)


def _stage2_then_evaluation(root, configs, tag):
    """``classify_mamba`` on ``configs['cls']``, then ``test_mamba`` on its
    ``model_current`` npz with ``configs['test']``: what
    :func:`_check_evaluation` compares."""
    from gfe_mamba_torch.cli import classify_mamba, test_mamba

    s2 = classify_mamba.main(_config(root, f"{tag}_cls", configs["cls"]))
    model = s2["trainer"].model
    out = dict(generator=_state(model.generator),
               parts={p: _state(getattr(model, p))
                      for p in ("combiner", "classifier")},
               validation=s2["validation"])
    del s2, model
    torch.cuda.empty_cache()
    configs["test"]["pth_dir"] = os.path.join(
        _run_dir(configs["cls"]["project_dir"]), "model_current")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        s3 = test_mamba.main(_config(root, f"{tag}_test", configs["test"]))
    out["printed"] = printed.getvalue().strip().splitlines()
    out["evaluated"] = {p: _state(getattr(s3["model"], p))
                        for p in out["parts"]}
    del s3
    torch.cuda.empty_cache()
    return out


def _check_evaluation(run, g_end):
    """Stage 2's generator is Stage 1's last state bitwise; ``test_mamba``'s
    combiner and classifier are what Stage 2 saved, bitwise, and its
    printed metrics those of ``ClassifyTrainer.eval_step`` over the same
    batches (Stage 2's last validation, same weights)."""
    assert _states_equal(run["generator"], g_end)
    for p, state in run["parts"].items():
        assert _states_equal(run["evaluated"][p], state), p
    val = run["validation"]
    m = val["metrics"]
    assert run["printed"] == [
        f"Acc: {m['accuracy'] * 100: .4f}", f"Recall: {m['recall']: .4f}",
        f"F1: {m['f1']:.4f}", f"Pre: {m['precision']:.4f}",
        f"MCC: {m['mcc']:.4f}", f"Val_loss: {val['val_loss']: .4f}"]


@pytest.fixture(scope="module")
def phase12(tmp_path_factory):
    """The three entry points through their ``main`` over synthetic trees
    (2 MRI/PET subjects; 4 train and 2 eval classify items on one CSV,
    1 epoch, bf16, configs from ``configs/*.yaml``): ``main_gan_vit``
    (batch 1, 2 steps, remat, auto-resume on), ``classify_mamba`` on its
    ``model.npz`` (batch 2), ``test_mamba`` on the saved npz.  Returns the
    trees, the configs and what the checks read: Stage 1's end state,
    its newest auto-resume snapshot, a step taken after loading that
    snapshot, the evaluation run and the launches of K1-K4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from gfe_mamba_torch.cli import main_gan_vit
    from gfe_mamba_torch.config import load_config
    from gfe_mamba_torch.data.synthetic import (make_classify_tree,
                                                make_mri2pet_tree)

    root = str(tmp_path_factory.mktemp("clis"))
    pairs = make_mri2pet_tree(os.path.join(root, "pairs"), 2, IMG)
    vol_dir, csv_path = make_classify_tree(os.path.join(root, "cls"), 6, IMG)
    eval_dir = os.path.join(root, "cls", "eval")
    os.makedirs(eval_dir)
    for name in sorted(os.listdir(vol_dir))[4:]:
        shutil.move(os.path.join(vol_dir, name), eval_dir)
    run = dict(num_epochs=1, val_inter=1, save_inter=1, is_debug=False,
               autoresume=True, log_every=1, f_maps=list(CANONICAL["f_maps"]),
               mixed_precision="bf16", img_sz=list(IMG))
    configs = {}
    for name, source, extra in (
            ("gan", "main_gan_vit_config.yaml", dict(
                train_path=pairs, eval_path=pairs, train_bc=1, eval_bc=1,
                project_dir=os.path.join(root, "w"))),
            ("cls", "classify_mamba_config.yaml", dict(
                train_path=vol_dir, eval_path=eval_dir, table_path=csv_path,
                train_bc=2, eval_bc=2, dim=CANONICAL["dim"],
                depth=CANONICAL["depth"],
                project_dir=os.path.join(root, "w", "classifier"))),
            ("test", "classify_mamba_config_test.yaml", dict(
                train_path=vol_dir, eval_path=eval_dir, table_path=csv_path,
                eval_bc=2, dim=CANONICAL["dim"], depth=CANONICAL["depth"],
                use_best=False, project_dir=os.path.join(root, "w", "test")))):
        cf = dict(load_config(os.path.join(REPO, "configs", source)))
        cf.update(run, **extra)
        configs[name] = cf

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = PROCESS_TF32
    try:
        torch.cuda.synchronize()
        k1.launches = k1.dw_launches = k2.launches = k2.bwd_launches = 0
        s1 = main_gan_vit.main(_config(root, "gan", configs["gan"]))
        trainer = s1["trainer"]
        out = dict(root=root, configs=configs, csv=csv_path,
                   g_end=_state(trainer.generator),
                   d_end=_state(trainer.discriminator),
                   g_opt_end=copy.deepcopy(trainer.g_opt.state_dict()),
                   d_opt_end=copy.deepcopy(trainer.d_opt.state_dict()),
                   steps=len(s1["step_ms"]),
                   restored=s1["auto"].restore_latest(map_location="cpu"))
        # what a restarted run does with the snapshot: load, then a step
        # (on a copy: Adam's load keeps the snapshot's step tensors)
        trainer.load_state_dict(copy.deepcopy(out["restored"][1]["gan"]))
        gen = torch.Generator(device="cuda").manual_seed(12)
        out["step_after_load"] = trainer.train_step(
            *(torch.randn(1, *IMG, 1, generator=gen, device="cuda")
              for _ in range(2)), 0.0)
        del s1, trainer
        torch.cuda.empty_cache()
        npz = os.path.join(_run_dir(os.path.join(root, "w")), "model_save",
                           "model.npz")
        configs["cls"]["gan_ckpt"] = configs["test"]["gan_ckpt"] = npz
        out["evaluation"] = _stage2_then_evaluation(root, configs, "cli")
        torch.cuda.synchronize()
        out["launches"] = dict(K1=k1.launches, K2=k2.launches,
                               K3=k1.dw_launches, K4=k2.bwd_launches)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    return out


def test_stage1_stage2_and_evaluation_clis(cuda, phase12):
    """The weights each CLI hands on are bitwise the giver's and
    ``test_mamba`` prints ``eval_step``'s metrics
    (:func:`_check_evaluation`); ``AutoResume.restore_latest`` gives
    Stage 1's last snapshot (step, epoch, both players and both Adams
    bitwise), and the trainer loaded from it takes a finite step; K1,
    K2, K3 and K4 each launch."""
    step, payload = phase12["restored"]
    gan = payload["gan"]
    assert step == phase12["steps"] and payload["epoch"] == 1
    assert _states_equal(gan["generator"], phase12["g_end"])
    assert _states_equal(gan["discriminator"], phase12["d_end"])
    assert _adam_equal(gan["g_opt"], phase12["g_opt_end"])
    assert _adam_equal(gan["d_opt"], phase12["d_opt_end"])
    logs = phase12["step_after_load"]
    assert not logs["skipped"]
    assert all(math.isfinite(v) for v in logs.values())
    _check_evaluation(phase12["evaluation"], phase12["g_end"])
    assert all(n > 0 for n in phase12["launches"].values()), \
        phase12["launches"]


def test_jamba_head_and_ft_table_clis(cuda, phase12):
    """``classify_mamba`` with ``mixer: 'jamba'`` on the tree and Stage-1
    npz of ``phase12``, ``test_mamba`` on its checkpoint (the checks of
    :func:`_check_evaluation`; K2 and K4 each launch), then ``ft_table``
    for 2 epochs on the synthetic CSV (batch 2) on the card, whose lines
    have the JAX script's form."""
    from gfe_mamba_torch.cli import ft_table

    root = phase12["root"]
    configs = {name: dict(phase12["configs"][name], mixer="jamba",
                          project_dir=os.path.join(root, "w",
                                                   f"jamba_{name}"))
               for name in ("cls", "test")}
    torch.cuda.synchronize()
    k2.launches = k2.bwd_launches = 0
    _check_evaluation(_stage2_then_evaluation(root, configs, "jamba"),
                      phase12["g_end"])
    assert k2.launches > 0 and k2.bwd_launches > 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = ft_table.main(ft_table.parse_args(
            ["--table_path", phase12["csv"], "--epochs", "2", "--batch",
             "2", "--log_every", "1", "--device", "cuda"]))
    form = re.compile(r"^epoch (\d+): loss=\d+\.\d{4} acc=\d\.\d{4} "
                      r"f1=\d\.\d{4} mcc=-?\d\.\d{4}$")
    lines = out.getvalue().strip().splitlines()
    assert [getattr(form.match(line), "group", lambda _: None)(1)
            for line in lines] == ["1", "2"], lines
    assert next(run["model"].parameters()).device.type == "cuda"


def _adam_start(run, player, name, lr):
    """The weights Adam's first step started from, read back from the
    step's result: p + lr m / (|m| + 1e-9) (its update is lr m_hat /
    (sqrt(v_hat) + 1e-8), with m_hat = 10 m and sqrt(v_hat) = |10 m|)."""
    m = run["moments"][player][name].float()
    return run["params"][player][name].float() + lr * m / (m.abs() + 1e-9)


def _compare_dp(dp, one, lrs):
    """Rank 0's step against one process stepping the global batch from
    the same weights, both bf16 on the card.  What differs is the batch
    the card's GEMMs and K3 sum over and the order of the f32 gradient
    sums, so: the logged losses within 1e-2 relative; Adam's first
    moments within 5e-2 of their norm over each player's whole set of
    tensors (a missing gradient average reads 0.5 or more); every
    parameter within 2 lr of the reference's; and the weights each run's
    update started from (:func:`_adam_start`) within 1e-3 lr + 2 f32
    ulps of p, which a skipped, sign-flipped or rescaled update fails."""
    for key, want in one["logs"][0].items():
        got = dp["logs"][0][key]
        assert not (key == "skipped" and got != want), key
        assert abs(got - want) <= 1e-2 * max(abs(want), 1e-6), \
            (key, got, want)
    for player, moments in one["moments"].items():
        got = dp["moments"][player]
        diff = sum(float((got[k].float() - v.float()).square().sum())
                   for k, v in moments.items())
        norm = sum(float(v.float().square().sum()) for v in moments.values())
        assert math.sqrt(diff / max(norm, 1e-30)) <= 5e-2, player
    for player, state in one["params"].items():
        lr, eps = lrs[player], torch.finfo(torch.float32).eps
        err = max(float((dp["params"][player][k].float() - v.float())
                        .abs().max()) for k, v in state.items()
                  if v.is_floating_point())
        start = max(float(((_adam_start(dp, player, k, lr)
                            - _adam_start(one, player, k, lr)).abs()
                           - 2 * eps * state[k].float().abs()).max())
                    for k in one["moments"][player])
        assert err <= 2.0001 * lr and start <= 1e-3 * lr, (player, err,
                                                           start)


def test_two_ranks_step_as_one_process(cuda, tmp_path):
    """Two gloo ranks on the one card at the canonical width, each at
    batch 1 (``parallel/dryrun.py::launch``, ``testing.dp_steps``): one
    Stage-2 step (Mamba head) and one Stage-1 step (adv_on 1), dropout
    off.  Each rank launches K1, K2, K4 (Stage 2) and K1, K3 (Stage 1),
    each rank's mixer output is f32, both ranks' parameters are bitwise
    equal, and rank 0 holds to this process stepping the global batch of
    2 from the same weights (:func:`_compare_dp`)."""
    from gfe_mamba_torch.parallel.dryrun import launch

    rs = np.random.RandomState(14)
    jobs = [
        dict(name="stage2", stage=2, build=dict(img_size=IMG, seed=0,
                                                cross_ff_dropout=0.0,
                                                **CANONICAL),
             trainer={}, keys=("mri", "x_cat", "x_num", "labels"),
             keep_rank=0, batches=[dict(
                 mri=rs.randn(2, *IMG, 1).astype(np.float32),
                 x_cat=rs.randint(0, 6, (2, 8)),
                 x_num=rs.randn(2, 40).astype(np.float32),
                 labels=np.asarray([1.0, 0.0], np.float32))]),
        dict(name="stage1", stage=1, build=dict(
            img_size=IMG, seed=0, vit_dropout=0.0, vit_emb_dropout=0.0),
             disc=(3, 32), fake_3d_ratio=0.25, trainer={},
             keys=("mri", "pet"), extra=(1.0,), keep_rank=0,
             batches=[dict(mri=rs.randn(2, *IMG, 1).astype(np.float32),
                           pet=rs.randn(2, *IMG, 1).astype(np.float32))])]
    torch.cuda.empty_cache()
    launch(testing.dp_steps, 2, (str(tmp_path), dict(device="cuda:0",
                                                     jobs=jobs)),
           device="cuda:0", backend="gloo", timeout_s=600)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    want = {"stage2": ("K1", "K2", "K4"), "stage1": ("K1", "K3")}
    lrs = {"model": 1e-4, "generator": 1e-4, "discriminator": 5e-4}
    for job in jobs:
        name = job["name"]
        for rank in ranks:
            assert all(rank[name]["launches"][k] > 0 for k in want[name])
            if name == "stage2":
                assert rank[name]["mixer_dtypes"] == {"torch.float32"}
        assert ranks[0][name]["digests"] == ranks[1][name]["digests"]
        one = testing.run_job({k: v for k, v in job.items()
                               if k != "keep_rank"}, None, cuda)
        _compare_dp(ranks[0][name], one, lrs)
        del one
        torch.cuda.empty_cache()


def _python(args, cwd):
    """``python <args>`` in ``cwd`` with the repository on the path."""
    return subprocess.Popen([sys.executable, *args], cwd=cwd,
                            env=dict(os.environ, PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def test_dry_run_on_the_card(cuda):
    """``python -m gfe_mamba_torch.parallel.dryrun`` at 2 processes on the
    card over gloo with a model axis of 2, so its tensor- and
    expert-parallel projections run on CUDA tensors; widths 8/16/32 (K1
    takes multiples of 8)."""
    proc = _python(["-m", "gfe_mamba_torch.parallel.dryrun", "--procs", "2",
                    "--model", "2", "--device", "cuda:0", "--backend",
                    "gloo", "--f_maps", "8,16,32", "--timeout", "300"], REPO)
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-6000:]
    assert "dryrun(2): ok" in out and out.count(" ok\n") >= 2, out[-6000:]


def test_torchrun_clis_write_the_same_weights(cuda, phase12):
    """``torchrun --nproc_per_node 1`` (NCCL at world 1) of the Stage-1
    and Stage-2 CLIs on the configs of ``phase12`` with ``async_ckpt:
    true``: their npz files are bitwise ``phase12``'s, and ``AutoResume``
    over the async manager's snapshots restores Stage 1's last state."""
    from gfe_mamba_torch.training.resilience import AutoResume

    root = phase12["root"]
    w14 = os.path.join(root, "w14")
    configs = dict(
        gan=dict(phase12["configs"]["gan"], async_ckpt=True,
                 project_dir=w14),
        cls=dict(phase12["configs"]["cls"], async_ckpt=True,
                 project_dir=os.path.join(w14, "classifier")))
    procs = {}
    for name, module in (("gan", "main_gan_vit"), ("cls", "classify_mamba")):
        path = os.path.join(root, f"torchrun_{name}.yaml")
        with open(path, "w") as f:
            f.write(yaml_text(configs[name]))
        procs[module] = _python(
            ["-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", f"gfe_mamba_torch.cli.{module}",
             "--config_path", path], root)
    for module, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, (module, out[-6000:])
    pairs = [("model_save/model.npz", os.path.join(root, "w"), w14)] + [
        (f"model_current/{f}", phase12["configs"]["cls"]["project_dir"],
         configs["cls"]["project_dir"])
        for f in ("model_current.npz", "ft_model_current.npz")]
    for rel, plain, ranked in pairs:
        a = np.load(os.path.join(_run_dir(plain), rel))
        b = np.load(os.path.join(_run_dir(ranked), rel))
        assert sorted(a.files) == sorted(b.files), rel
        differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
        assert not differ, (rel, differ[:5])
    step, payload = AutoResume(os.path.join(w14, "autoresume_main_gan_vit"),
                               async_save=True).restore_latest()
    assert payload is not None and payload["epoch"] == 1, step
    assert _states_equal(payload["gan"]["generator"], phase12["g_end"])
