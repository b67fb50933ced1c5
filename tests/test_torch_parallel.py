"""The port's parallel layer against the JAX package's, in one process
on the CPU: the loader's per-process shards, ``local_batch_slice``, the
mesh layout and its errors, what takes the place of
``form_global_array``, the tensor-/expert-parallel sharding rule on the
tiny Jamba pipeline, ``AsyncCheckpointManager`` (retention, index,
restore, and a snapshot that later in-place writes do not reach),
auto-resume through it, ``StepTimer`` and the profiler trace.  Each
comparison is exact: these are index, layout and bookkeeping results."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.data.loader import DataLoader as JaxLoader
from gfe_mamba_tpu.parallel import multihost as jax_multihost
from gfe_mamba_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gfe_mamba_tpu.parallel.sharding import \
    infer_param_shardings as jax_infer
from gfe_mamba_tpu.training.checkpoint import \
    AsyncCheckpointManager as JaxManager
from gfe_mamba_tpu.utils import profiling as jax_profiling
from gfe_mamba_torch.data.loader import DataLoader
from gfe_mamba_torch.models.pipeline import build_gfe_mamba
from gfe_mamba_torch.parallel import multihost
from gfe_mamba_torch.parallel.dryrun import TINY_PIPELINE
from gfe_mamba_torch.parallel.mesh import make_mesh
from gfe_mamba_torch.parallel.sharding import infer_param_shardings
from gfe_mamba_torch.training.checkpoint import AsyncCheckpointManager
from gfe_mamba_torch.training.resilience import AutoResume
from gfe_mamba_torch.utils import profiling


class IndexDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.asarray(i), "x": np.full((3,), float(i))}


def _batches(loader):
    return [b["idx"].tolist() for b in loader]


@pytest.mark.parametrize("n,per,nproc,seed", [(64, 4, 2, 7), (50, 3, 3, 1),
                                              (9, 2, 4, 0)])
def test_process_shards_match_the_jax_loader(n, per, nproc, seed):
    for pid in range(nproc):
        kw = dict(shuffle=True, seed=seed, prefetch=0,
                  process_shard=(pid, nproc))
        port, ref = DataLoader(IndexDataset(n), per, **kw), \
            JaxLoader(IndexDataset(n), per, **kw)
        assert len(port) == len(ref) == n // (per * nproc)
        for _ in range(2):                       # two epochs
            assert _batches(port) == _batches(ref)


def test_process_shard_errors_and_batch_slice_match_jax():
    for kw in (dict(process_shard=(2, 2)), dict(process_shard=(-1, 2)),
               dict(process_shard=(0, 2), drop_last=False)):
        with pytest.raises(ValueError) as port_err:
            DataLoader(IndexDataset(8), 2, **kw)
        with pytest.raises(ValueError) as jax_err:
            JaxLoader(IndexDataset(8), 2, **kw)
        assert type(port_err.value) is type(jax_err.value)
    for args in ((8, 0, 2), (8, 1, 2), (12, 2, 3), (6, 0, 1)):
        assert multihost.local_batch_slice(*args) == \
            jax_multihost.local_batch_slice(*args)
    for args in ((9, 0, 2), (5, 1, 3)):
        with pytest.raises(ValueError, match="not divisible"):
            multihost.local_batch_slice(*args)
        with pytest.raises(ValueError, match="not divisible"):
            jax_multihost.local_batch_slice(*args)
    # one process: the whole batch
    assert multihost.local_batch_slice(5) == slice(0, 5)
    assert multihost.process_count() == 1 and multihost.is_main_process()


@pytest.mark.parametrize("axes", [{"data": -1, "model": 2}, {"data": 8},
                                  None, {"data": 2, "model": -1}])
def test_make_mesh_matches_jax(axes):
    devices = jax.devices()[:8]
    ref = jax_make_mesh(axes, devices)
    mesh = make_mesh(axes, ranks=range(8))
    assert mesh.shape == dict(ref.shape)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    np.testing.assert_array_equal(mesh.grid, ids - ids.min())
    assert mesh.rank is None and mesh.data_group is None


@pytest.mark.parametrize("axes", [{"data": 3}, {"data": 3, "model": 2}])
def test_make_mesh_errors_match_jax(axes):
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(axes, jax.devices()[:8])
    with pytest.raises(ValueError) as port_err:
        make_mesh(axes, ranks=range(8))
    assert str(port_err.value) == str(jax_err.value)


def test_dryrun_takes_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without ``--device`` the dry run wants one card per rank and raises
    when there is none, before it starts a process."""
    from gfe_mamba_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "launch", lambda *a, **k: pytest.fail(
        "ranks started without a card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--procs", "2"])


def test_rank_rows_take_the_place_of_form_global_array():
    """JAX assembles each process's rows into one global array; in the
    port each rank keeps its rows.  The data ranks' rows, in data order,
    are JAX's global batch, and each rank's are its ``local_batch_slice``
    (the model ranks of one data index hold the same rows)."""
    batch = {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             "y": np.arange(8)}
    jax_mesh = jax_make_mesh({"data": 4, "model": 2}, jax.devices()[:8])
    want = jax_multihost.form_global_array(batch, jax_mesh)
    mesh = make_mesh({"data": 4, "model": 2}, ranks=range(8))
    parts = []
    for rank in range(8):
        mesh.rank = rank
        local = {k: v[mesh.local_rows(8)] for k, v in batch.items()}
        assert mesh.local_rows(8) == jax_multihost.local_batch_slice(
            8, mesh.data_index, 4)
        if mesh.model_index == 0:
            parts.append(local)
        else:
            np.testing.assert_array_equal(local["x"], parts[-1]["x"])
    for key in batch:
        np.testing.assert_array_equal(
            np.concatenate([p[key] for p in parts]), np.asarray(want[key]))


def test_sharding_rule_matches_jax_on_the_tiny_jamba_pipeline():
    """Model axis 2, threshold 128: the port parameters split, and the
    flax path and dim of each split, are JAX's; a model axis of 1
    splits nothing."""
    model = build_gfe_mamba(img_size=(16, 16, 8), device="cpu",
                            **TINY_PIPELINE)
    from gfe_mamba_tpu.models.pipeline import build_gfe_mamba as jax_build
    jax_model = jax_build(**{k: v for k, v in TINY_PIPELINE.items()
                             if k != "cross_ff_dropout"})
    params = jax.eval_shape(jax_model.init, jax.random.key(0),
                            jnp.zeros((2, 16, 16, 8, 1)),
                            jnp.zeros((2, 3), jnp.int32), jnp.zeros((2, 4)))
    mesh = jax_make_mesh({"data": 4, "model": 2}, jax.devices()[:8])
    specs = jax_infer(params, mesh, threshold=128)
    want = set()
    for (path, _), sharding in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_leaves(specs)):
        spec = tuple(sharding.spec)
        if spec:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            want.add((key.removeprefix("params/"), spec.index("model")))
    got = infer_param_shardings(model, 2, threshold=128, layer_order="cge")
    assert {(s.flax_path, s.flax_dim) for s in got.values()} == want
    assert len(want) == 12
    for name, split in got.items():
        shape = tuple(model.get_parameter(name).shape)
        flax_dims = shape[::-1] if len(shape) == 2 else shape
        assert shape[split.dim] == flax_dims[split.flax_dim]
    assert infer_param_shardings(model, 1, threshold=128,
                                 layer_order="cge") == {}


def _saves(manager, arrays, wait_each):
    metrics = {1: 0.5, 2: 0.9, 3: 0.4, 4: 0.6, 5: 0.7, 6: None, 7: 0.1}
    for step, acc in metrics.items():
        manager.save(step, {"w": arrays(np.full((4,), float(step))),
                            "step": step}, metric=acc)
        if wait_each:
            manager.wait()
    manager.wait()
    manager._gc()


@pytest.mark.parametrize("keep,best", [(2, 1), (3, 0), (1, 2)])
def test_async_manager_retention_and_index_match_jax(tmp_path, keep, best):
    """JAX's manager waits after each save: its prune lists the directory
    twice, and a step that orbax commits in between is deleted (a race
    the port's single listing does not have); the port runs the same
    saves without waiting."""
    ref = JaxManager(str(tmp_path / "jax"), max_to_keep=keep,
                     keep_best=best)
    _saves(ref, jnp.asarray, wait_each=True)
    port = AsyncCheckpointManager(str(tmp_path / "port"),
                                  max_to_keep=keep, keep_best=best)
    _saves(port, torch.from_numpy, wait_each=False)
    assert port.steps() == ref.steps()
    assert port.best_step() == ref.best_step()
    assert port.latest_step() == ref.latest_step()
    index = [json.load(open(tmp_path / d / "index.json"))
             for d in ("jax", "port")]
    assert index[0] == index[1]
    for step in port.steps():
        tree = port.restore(step)
        assert tree["step"] == step
        assert torch.equal(tree["w"], torch.full((4,), float(step)))
    ref.close()
    port.close()
    again = AsyncCheckpointManager(str(tmp_path / "port"),
                                   max_to_keep=keep, keep_best=best)
    assert again.best_step() == ref.best_step()
    again.close()


def test_async_save_is_a_snapshot(tmp_path):
    """``save`` copies to the host before it returns: writing to the
    parameters right after (as Adam does in place) leaves the saved step
    as it was.  Types, dtypes and integer keys come back."""
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    tree = {"model": {"w": w, "h": w.to(torch.bfloat16)},
            "opt": {"state": {0: {"step": torch.tensor(3.0)}},
                    "param_groups": [{"lr": 1e-4, "betas": (0.9, 0.999),
                                      "params": [0]}]},
            "rng": torch.Generator().manual_seed(5).get_state(),
            "np": np.ones(2, np.int64), "epoch": 4, "name": "x",
            "none": None}
    manager = AsyncCheckpointManager(str(tmp_path), max_to_keep=2)
    manager.save(1, tree)
    w.add_(100.0)
    tree["model"]["h"].mul_(0)
    back = manager.restore(1)
    assert torch.equal(back["model"]["w"],
                       torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert back["model"]["h"].dtype == torch.bfloat16
    assert torch.equal(back["model"]["h"].float(), back["model"]["w"])
    assert back["opt"]["state"][0]["step"].item() == 3.0
    assert back["opt"]["param_groups"][0]["betas"] == (0.9, 0.999)
    assert torch.equal(back["rng"], tree["rng"])
    assert back["np"].dtype == np.int64 and back["epoch"] == 4
    assert back["name"] == "x" and back["none"] is None
    files = sorted(os.listdir(tmp_path / "step_00000001"))
    assert files == ["arrays.npz", "tree.json"]
    assert "model/w" in np.load(tmp_path / "step_00000001" / "arrays.npz")
    manager.close()


def test_autoresume_through_the_async_manager(tmp_path):
    auto = AutoResume(str(tmp_path), interval=2, keep=2, async_save=True)
    assert not auto.maybe_save(1, {"x": torch.zeros(1)})
    for step in (2, 4, 6):
        assert auto.maybe_save(step, {"x": torch.full((1,), step),
                                      "epoch": step})
    auto.close()
    assert AutoResume(str(tmp_path), async_save=True).manager.steps() \
        == [4, 6]
    step, state = AutoResume(str(tmp_path), async_save=True) \
        .restore_latest()
    assert step == 6 and state["epoch"] == 6 and state["x"].item() == 6
    assert AutoResume(str(tmp_path / "none"),
                      async_save=True).restore_latest() == (0, None)


def test_step_timer_summary_matches_jax(monkeypatch):
    """The same step durations (a fake clock in each module) give the
    same summary, key for key."""
    durations = [0.5, 0.25, 0.125, 0.3, 0.2, 0.1]
    timers = []
    for module in (jax_profiling, profiling):
        stamps, t = [], 0.0
        for d in durations:
            stamps += [t, t + d]
            t += d + 1.0
        clock = iter(stamps)
        monkeypatch.setattr(module, "time", type(
            "Clock", (), {"perf_counter": staticmethod(lambda: next(clock))}))
        timer = module.StepTimer(ema=0.8)
        for _ in durations:
            with timer:
                pass
        timers.append(timer)
    for kw in ({}, dict(items_per_step=4, skip_warmup=2)):
        assert timers[1].summary(**kw) == timers[0].summary(**kw)


def test_trace_writes_a_tensorboard_trace_with_annotations(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("gfe_step"):
            torch.ones(8).sum()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert traces, os.listdir(tmp_path)
    assert "gfe_step" in open(tmp_path / traces[0]).read()
