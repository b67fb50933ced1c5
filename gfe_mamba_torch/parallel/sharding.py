"""Tensor- and expert-parallel split of the parameters (counterpart of
``gfe_mamba_tpu/parallel/sharding.py``).

The rules are JAX's, read on each parameter's flax path and flax layout
(``utils/convert.py::flax_entry``), with the same ``threshold``:

* MoE stacked expert kernels (``experts_*``, ``(E, d, f)`` in both
  packages): dim 0 over the model axis (expert parallelism);
* dense kernels whose input dim is at least ``threshold`` (the 25600-wide
  cross-attention ``k_proj`` / ``v_proj``, the 409600-wide ViT patch
  embed): row parallel, the input dim split;
* dense kernels whose output dim is at least ``threshold`` (the
  409600-wide ``patch_unembed``): column parallel, the output dim split;
* everything else replicated; a model axis of 1 replicates everything.

A flax kernel is ``(in, out)`` and an ``nn.Linear.weight`` ``(out, in)``,
so a row-parallel split is flax dim 0 and port dim 1.  Where GSPMD
inserts the collectives in JAX, :func:`apply_param_shardings` swaps each
matched ``nn.Linear`` for a :class:`RowParallelLinear` or
:class:`ColumnParallelLinear` holding its shard and gives each matched
``SparseMoEBlock`` its slice of the experts; their forwards use the
autograd pairs of ``parallel/collectives.py`` (``add_bias=False`` leaves
the bias out, for a Mamba layer's ``dt_proj``, whose bias the scan adds).
State-dict keys stay as they were, with the shards' shapes.  The
parallel forms compute in the promoted dtype of their input and their
shard, as the ``Linear`` they replace (``models/promote.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.models.promote import promote
from gfe_mamba_torch.parallel.collectives import (copy_to_model,
                                                  gather_from_model,
                                                  group_rank, group_size,
                                                  reduce_from_model)
from gfe_mamba_torch.utils.convert import flax_entry


class Split(NamedTuple):
    """A sharded parameter: the port dim split over the model axis, and
    the flax path and dim of the same split."""
    dim: int
    flax_path: str
    flax_dim: int


def _rule(path: str, shape: tuple, axis_size: int,
          threshold: int) -> Optional[int]:
    """JAX's ``_rule`` (sharding.py:31-48): the flax dim split, or None."""
    if axis_size == 1:
        return None
    if "experts_" in path and len(shape) == 3:
        return 0 if shape[0] % axis_size == 0 else None
    if len(shape) == 2 and path.endswith("kernel"):
        fan_in, fan_out = shape
        if fan_in >= threshold and fan_in % axis_size == 0:
            return 0
        if fan_out >= threshold and fan_out % axis_size == 0:
            return 1
    return None


def infer_param_shardings(model: nn.Module, model_size: int, *,
                          threshold: int = 16384,
                          layer_order: str = "gcr") -> dict[str, Split]:
    """``{parameter name: Split}`` of every parameter the rules shard at a
    model axis of ``model_size``; the others are replicated.
    ``layer_order`` names a generator's GroupNorms on the flax side."""
    out = {}
    for name, p in model.named_parameters():
        path, flax_value = flax_entry(
            name, np.broadcast_to(np.float32(0), tuple(p.shape)), layer_order)
        flax_dim = _rule(path, flax_value.shape, model_size, threshold)
        if flax_dim is None:
            continue
        dim = 1 - flax_dim if flax_value.ndim == 2 else flax_dim
        out[name] = Split(dim, path, flax_dim)
    return out


def _shard(t: torch.Tensor, dim: int, index: int, size: int) -> torch.Tensor:
    per = t.shape[dim] // size
    return t.detach().narrow(dim, index * per, per).clone()


class ColumnParallelLinear(nn.Module):
    """``nn.Linear`` with its output features split over ``group``: each
    rank projects onto its block of columns, the blocks are all-gathered
    in rank order (flax's column order) and the whole bias is added."""

    def __init__(self, linear: nn.Linear, group):
        super().__init__()
        self.group, self.index = group, group_rank(group)
        self.size = group_size(group)
        self.in_features, self.out_features = (linear.in_features,
                                               linear.out_features)
        self.weight = nn.Parameter(_shard(linear.weight, 0, self.index,
                                          self.size))
        self.bias = None if linear.bias is None else \
            nn.Parameter(linear.bias.detach().clone())

    def forward(self, x: torch.Tensor, add_bias: bool = True):
        y = F.linear(*promote(copy_to_model(x, self.group), self.weight))
        y = gather_from_model(y, -1, self.group)
        return y if self.bias is None or not add_bias else y + self.bias


class RowParallelLinear(nn.Module):
    """``nn.Linear`` with its input features split over ``group``: each
    rank contracts its block of the input, the partial sums are
    all-reduced and the bias is added once, after the reduce."""

    def __init__(self, linear: nn.Linear, group):
        super().__init__()
        self.group, self.index = group, group_rank(group)
        self.size = group_size(group)
        self.in_features, self.out_features = (linear.in_features,
                                               linear.out_features)
        self.weight = nn.Parameter(_shard(linear.weight, 1, self.index,
                                          self.size))
        self.bias = None if linear.bias is None else \
            nn.Parameter(linear.bias.detach().clone())

    def forward(self, x: torch.Tensor, add_bias: bool = True):
        per = self.weight.shape[1]
        x = copy_to_model(x, self.group).narrow(-1, self.index * per, per)
        y = reduce_from_model(F.linear(*promote(x, self.weight)), self.group)
        return y if self.bias is None or not add_bias else y + self.bias


EXPERTS = ("experts_gate", "experts_up", "experts_down")


def _shard_experts(moe: nn.Module, group) -> None:
    """Give a ``SparseMoEBlock`` its slice of the experts (dim 0) and the
    group its forward reduces over (``models/jamba.py``)."""
    index, size = group_rank(group), group_size(group)
    for name in EXPERTS:
        setattr(moe, name, nn.Parameter(_shard(getattr(moe, name), 0, index,
                                               size)))
    moe.ep_group, moe.ep_index = group, index


def apply_param_shardings(model: nn.Module, shardings: dict[str, Split],
                          group) -> nn.Module:
    """Swap every sharded parameter's module in ``model`` (in place) for
    its parallel form over the model ``group``; returns ``model``.  Call
    after the weights are drawn or loaded: each rank keeps its shard of
    what the module holds."""
    from gfe_mamba_torch.models.jamba import SparseMoEBlock

    done = set()
    for name, split in shardings.items():
        owner, leaf = name.rsplit(".", 1)
        if owner in done:
            continue
        module = model.get_submodule(owner)
        if isinstance(module, SparseMoEBlock) and leaf in EXPERTS:
            wanted = {f"{owner}.{e}" for e in EXPERTS}
            if not wanted <= set(shardings):
                raise ValueError(f"{owner}: the rules split only some of "
                                 f"its experts' kernels")
            _shard_experts(module, group)
        elif isinstance(module, nn.Linear) and leaf == "weight":
            cls = RowParallelLinear if split.dim == 1 else \
                ColumnParallelLinear
            parent, _, child = owner.rpartition(".")
            setattr(model.get_submodule(parent) if parent else model, child,
                    cls(module, group))
        else:
            raise NotImplementedError(
                f"{name}: no parallel form for {type(module).__name__}."
                f"{leaf}")
        done.add(owner)
    return model


def sharded_state(model: nn.Module) -> dict[str, tuple[int, object]]:
    """``{state_dict key: (split dim, model group)}`` of every shard that
    :func:`apply_param_shardings` left in ``model``."""
    out = {}
    for owner, module in model.named_modules():
        prefix = f"{owner}." if owner else ""
        if isinstance(module, RowParallelLinear):
            out[prefix + "weight"] = (1, module.group)
        elif isinstance(module, ColumnParallelLinear):
            out[prefix + "weight"] = (0, module.group)
        elif getattr(module, "ep_group", None) is not None:
            for name in EXPERTS:
                out[prefix + name] = (0, module.ep_group)
    return out


def shard_state_dict(model: nn.Module,
                     state: dict[str, torch.Tensor]) -> dict:
    """A whole (unsharded) state_dict cut to this rank's shards of
    ``model``'s parallel modules."""
    splits = sharded_state(model)
    out = dict(state)
    for key, (dim, group) in splits.items():
        out[key] = _shard(state[key], dim, group_rank(group),
                          group_size(group))
    return out

