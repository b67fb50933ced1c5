"""Gradient clipping and the mixed-precision policy of the trainers
(counterpart of ``gfe_mamba_tpu/training/optim.py``).

* Per-tensor clip (the Stage-2 loop clips each parameter on its own):
  ``g * min(1, max_norm / max(|g|, 1e-12))``.
* Global-norm clip with optax's formula, ``g`` if ``|g| < max_norm`` else
  ``g / |g| * max_norm``; ``torch.nn.utils.clip_grad_norm_`` divides by
  ``|g| + 1e-6`` and does not match.
* Adam is ``torch.optim.Adam``: with its defaults (b1 0.9, b2 0.999,
  eps 1e-8) it makes optax's update.  A step the finite guard skips
  still advances its count (``advance_adam_count_``), as optax's does.
* bf16 compute: the trainers keep f32 master parameters and run the loss
  on a bf16 copy (``cast_for_compute``) through
  ``torch.func.functional_call``.  ``Tensor.to`` is differentiable, so
  the gradients land on the f32 masters.  ``torch.autocast`` would keep
  some ops in f32 and is not the JAX package's semantics.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch

from gfe_mamba_torch.utils.profiling import to_host


def compute_dtype(mixed_precision: str) -> torch.dtype:
    """bf16 for any half-precision setting, f32 otherwise."""
    if mixed_precision in ("bf16", "bfloat16", "fp16", "float16"):
        return torch.bfloat16
    return torch.float32


def cast_for_compute(params: Mapping[str, torch.Tensor],
                     dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Float tensors cast to ``dtype`` (differentiably); others pass."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


def _norm(g: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(g, dtype=torch.float32)


def _split_squares(grads: list, splits: Mapping[int, object]) -> dict:
    """``{index: |g|^2 of the whole logical tensor}`` of the gradients of
    split parameters (``splits``: index -> model group): each shard's
    squared norm summed over its group, one all-reduce per group."""
    import torch.distributed as dist

    by_group: dict = {}
    for i, group in splits.items():
        by_group.setdefault(id(group), (group, []))[1].append(i)
    out = {}
    for group, idx in by_group.values():
        sq = torch.stack([_norm(grads[i]).square() for i in idx])
        dist.all_reduce(sq, group=group)
        out.update(zip(idx, sq))
    return out


@torch.no_grad()
def clip_by_param_norm_(grads: Iterable[torch.Tensor], max_norm: float,
                        splits: Mapping[int, object] | None = None) -> None:
    """Scale each gradient in place to a norm of at most ``max_norm``.
    ``splits`` maps the index of a tensor-parallel shard's gradient to
    its model group: its norm is the whole tensor's."""
    grads = list(grads)
    split_sq = _split_squares(grads, splits) if splits else {}
    for i, g in enumerate(grads):
        norm = torch.sqrt(split_sq[i]) if i in split_sq else _norm(g)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        g.mul_(scale.to(g.dtype))


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float,
                         splits: Mapping[int, object] | None = None
                         ) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place; returns the global norm.
    ``splits`` as in :func:`clip_by_param_norm_`: a split parameter counts
    once, whole; a replicated one once, not once per model rank."""
    grads = list(grads)
    split_sq = _split_squares(grads, splits) if splits else {}
    norm_sq = sum(_norm(g).square() for i, g in enumerate(grads)
                  if i not in split_sq)
    norm = torch.sqrt(norm_sq + sum(split_sq.values()))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


@torch.no_grad()
def advance_adam_count_(optimizer: torch.optim.Adam,
                        params: Iterable[torch.Tensor]) -> None:
    """Count a skipped step as optax does under the JAX trainers' finite
    guard, which keeps the old value of every inexact leaf but takes the
    new integer ``count``: each parameter's ``step`` rises by 1, and its
    moments and value stay as they are.  A missing state is made as
    ``torch.optim.Adam`` makes it (step on the CPU unless capturable or
    fused, zero moments like the parameter), then counted."""
    group_of = {p: g for g in optimizer.param_groups for p in g["params"]}
    for p in params:
        group, state = group_of[p], optimizer.state[p]
        if not state:
            fused = bool(group.get("fused"))
            dtype = torch.float32 if fused \
                or torch.get_default_dtype() != torch.float64 \
                else torch.float64
            on_device = fused or group.get("capturable")
            state["step"] = torch.zeros(
                (), dtype=dtype, device=p.device if on_device else "cpu")
            for key in ("exp_avg", "exp_avg_sq") \
                    + (("max_exp_avg_sq",) if group.get("amsgrad") else ()):
                state[key] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
        state["step"] += 1


def all_finite(tensors: Iterable[torch.Tensor]) -> bool:
    """Whether every element of every tensor is finite (one host sync)."""
    flags = [torch.isfinite(t).all() for t in tensors]
    return to_host(torch.stack(flags).all(), "all_finite") if flags \
        else True
