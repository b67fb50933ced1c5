"""Checkpoints (counterpart of ``gfe_mamba_tpu/training/checkpoint.py``:
its ``Checkpointer``, ``AsyncCheckpointManager``, ``BestTracker`` and npz
weights).

* ``Checkpointer``: named full-state snapshots, ``torch.save`` to a
  temporary file in the directory and then ``os.replace``, so a crash
  never leaves a half-written snapshot under the name.
* ``AsyncCheckpointManager``: step-indexed snapshots written by a
  background thread, with JAX's retention (``max_to_keep`` newest plus
  the ``keep_best`` highest metrics) and its ``index.json``.  The format
  is the port's own, one directory per step: ``arrays.npz`` holds every
  array leaf under its ``'/'``-joined path (a flax tree's JAX keys) and
  ``tree.json`` the rest of the tree (keys and their types, scalars,
  tensor dtypes).
* ``save_params_npz`` / ``load_params_npz``: one module's weights as a
  flat npz whose keys are the JAX package's ``'/'``-joined flax paths in
  flax layouts (``utils/convert.py``), so the generator, combiner and
  classifier files of either package load in the other, bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from gfe_mamba_torch.utils.convert import (flatten_tree,
                                           jax_tree_from_state_dict,
                                           state_dict_from_jax)


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, name: str, tree: Any) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f".{name}.")
        os.close(fd)
        try:
            torch.save(tree, tmp)
            os.replace(tmp, self._path(name))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def restore(self, name: str, map_location=None) -> Any:
        return torch.load(self._path(name), map_location=map_location,
                          weights_only=False)

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))


def _encode(tree: Any, arrays: dict, path: str = "") -> Any:
    """``tree``'s skeleton for ``tree.json``; its array leaves go into
    ``arrays`` as host copies (a tensor the caller writes to afterwards
    does not change what is saved)."""
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {"dict": [[k if isinstance(k, str) else int(k),
                          isinstance(k, str), _encode(v, arrays, join(k))]
                         for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        return {"list": [_encode(v, arrays, join(i))
                         for i, v in enumerate(tree)],
                "tuple": isinstance(tree, tuple)}
    if isinstance(tree, torch.Tensor):
        dtype = torch.float32 if tree.dtype == torch.bfloat16 else tree.dtype
        arrays[path] = tree.detach().to("cpu", dtype, copy=True).numpy()
        return {"array": path, "torch": str(tree.dtype)}
    if isinstance(tree, np.ndarray):
        arrays[path] = np.array(tree)
        return {"array": path, "torch": None}
    if isinstance(tree, np.generic):
        tree = tree.item()
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"{path}: cannot checkpoint a {type(tree).__name__}")


def _decode(node: Any, arrays) -> Any:
    if "dict" in node:
        return {(k if is_str else int(k)): _decode(v, arrays)
                for k, is_str, v in node["dict"]}
    if "list" in node:
        items = [_decode(v, arrays) for v in node["list"]]
        return tuple(items) if node["tuple"] else items
    if "array" in node:
        value = arrays[node["array"]]
        if node["torch"] is None:
            return value
        dtype = getattr(torch, node["torch"].split(".")[-1])
        return torch.from_numpy(value).to(dtype)
    return node["value"]


class AsyncCheckpointManager:
    """Step-indexed asynchronous snapshots with retention.

    ``save`` copies the tree to the host before it returns (the trainers'
    Adam updates the parameters in place, so a write that read the live
    tensors later would hold a later step's weights) and leaves the
    writing to one background thread; old steps are deleted down to the
    ``max_to_keep`` newest, and ``keep_best`` also keeps the steps with
    the highest ``metric``.  ``wait()`` (or ``close()``) drains pending
    writes.  A step is written under a temporary name and renamed when
    complete, so ``steps()`` lists only whole ones.

    In a multi-process run every rank calls ``save`` (after the
    collective ``host_local`` of what it saves); only the ``writer``
    (rank 0 by default) writes and prunes, as JAX's manager mutates the
    directory on process 0 only.  Every rank may ``restore``.
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 keep_best: int = 0, writer: bool | None = None):
        if writer is None:
            from gfe_mamba_torch.parallel.multihost import is_main_process
            writer = is_main_process()
        self.directory = os.path.abspath(directory)
        self.writer = writer
        if writer:
            os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_best = keep_best
        self._metrics: dict[int, float] = {}
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="ckpt")
        self._pending: list = []
        self._load_index()

    # -- index persistence (metrics survive restarts) ------------------
    def _index_path(self) -> str:
        return os.path.join(self.directory, "index.json")

    def _load_index(self) -> None:
        if os.path.exists(self._index_path()):
            with open(self._index_path()) as f:
                self._metrics = {int(k): v for k, v in json.load(f).items()}

    def _save_index(self) -> None:
        with open(self._index_path(), "w") as f:
            json.dump({str(k): v for k, v in self._metrics.items()}, f)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name[5:]) for name in os.listdir(self.directory)
                      if name.startswith("step_") and name[5:].isdigit()
                      and os.path.isdir(os.path.join(self.directory, name)))

    def _write(self, step: int, arrays: dict, skeleton: Any) -> None:
        final = self._step_path(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(skeleton, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)

    def save(self, step: int, tree: Any, *, metric: float | None = None
             ) -> None:
        """Snapshot ``tree`` (nested dicts, lists and tuples of tensors,
        arrays and scalars) as ``step``; ``metric`` (higher is better)
        feeds best-k retention."""
        if metric is not None:
            self._metrics[step] = float(metric)
        if not self.writer:
            return
        # a finished write's error surfaces at the next save, not only at
        # wait(); its future is dropped
        for future in [f for f in self._pending if f.done()]:
            self._pending.remove(future)
            future.result()
        arrays: dict = {}
        skeleton = _encode(tree, arrays)
        self._pending.append(
            self._pool.submit(self._write, step, arrays, skeleton))
        if metric is not None:
            self._save_index()
        self._gc()

    def _retained(self, steps: list[int]) -> set:
        keep = set(steps[-self.max_to_keep:]) if self.max_to_keep else set()
        if self.keep_best and self._metrics:
            ranked = sorted(self._metrics, key=self._metrics.get,
                            reverse=True)
            keep |= set(ranked[:self.keep_best])
        return keep

    def _gc(self) -> None:
        # only whole steps are listed, so the step being written is never
        # deleted, and a save does not wait for the one before it; one
        # listing serves both the choice and the deletion (a step that
        # lands in between is left for the next pass)
        steps = self.steps()
        keep = self._retained(steps)
        for step in steps:
            if step not in keep:
                shutil.rmtree(self._step_path(step), ignore_errors=True)
                self._metrics.pop(step, None)
        self._save_index()

    def best_step(self) -> int | None:
        if not self._metrics:
            return None
        return max(self._metrics, key=self._metrics.get)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int) -> Any:
        """The tree saved as ``step``: tensors (on the CPU, in their saved
        dtype) where tensors were saved, numpy arrays and scalars
        elsewhere."""
        self.wait()
        path = self._step_path(step)
        with open(os.path.join(path, "tree.json")) as f:
            skeleton = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as arrays:
            return _decode(skeleton, arrays)

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def close(self) -> None:
        """Drain pending writes, then prune once more: retention counts
        only whole steps, so the last save's prune ran before it landed."""
        self.wait()
        self._pool.shutdown()
        if self.writer and os.path.isdir(self.directory):
            self._gc()


class BestTracker:
    """Best-by-accuracy, ties broken by lower validation loss
    (classify_mamba.py:155-160)."""

    def __init__(self):
        self.best_accuracy = 0.0
        self.best_loss = float("inf")

    def is_better(self, accuracy: float, loss: float) -> bool:
        if accuracy > self.best_accuracy or (
                accuracy == self.best_accuracy and loss < self.best_loss):
            self.best_accuracy = accuracy
            self.best_loss = loss
            return True
        return False


def save_params_npz(path: str, module: nn.Module | Mapping,
                    layer_order: str = "gcr") -> None:
    """``module``'s weights (or a state_dict, such as ``host_local``
    returns) as the JAX package's ``save_params_npz`` would write the same
    subtree; ``layer_order`` is a generator's order string (it names the
    GroupNorms)."""
    state = module if isinstance(module, Mapping) else module.state_dict()
    flat = flatten_tree(jax_tree_from_state_dict(state, layer_order))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_params_npz(path: str, module: nn.Module) -> None:
    """Load an npz of flax paths (either package's ``save_params_npz``)
    into ``module`` in place; every parameter must be there with its
    shape."""
    with np.load(path) as loaded:
        tree: dict = {}
        for key in loaded.files:
            node = tree
            *parents, leaf = key.split("/")
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = loaded[key]
    state = state_dict_from_jax(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError(f"{path}: checkpoint missing {missing[:5]}")
    unexpected = sorted(set(state) - set(own))
    if unexpected:
        raise KeyError(f"{path}: parameters the module lacks "
                       f"{unexpected[:5]}")
    for key, value in state.items():
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(value.shape)} vs model "
                             f"{tuple(own[key].shape)}")
    module.load_state_dict(state)
