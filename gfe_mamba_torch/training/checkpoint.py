"""Checkpoints (counterpart of ``gfe_mamba_tpu/training/checkpoint.py``,
its ``Checkpointer``, ``BestTracker`` and npz weights; the async manager
is not ported).

* ``Checkpointer``: named full-state snapshots, ``torch.save`` to a
  temporary file in the directory and then ``os.replace``, so a crash
  never leaves a half-written snapshot under the name.
* ``save_params_npz`` / ``load_params_npz``: one module's weights as a
  flat npz whose keys are the JAX package's ``'/'``-joined flax paths in
  flax layouts (``utils/convert.py``), so the generator, combiner and
  classifier files of either package load in the other, bit for bit.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

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


def save_params_npz(path: str, module: nn.Module,
                    layer_order: str = "gcr") -> None:
    """``module``'s weights as the JAX package's ``save_params_npz`` would
    write the same subtree; ``layer_order`` is a generator's order string
    (it names the GroupNorms)."""
    flat = flatten_tree(jax_tree_from_state_dict(module.state_dict(),
                                                 layer_order))
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
