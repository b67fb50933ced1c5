"""Collectives inside a gradient, and the trainers' reductions.

The three autograd pairs of tensor parallelism over a model group, each
written out so that its backward is the one the math needs
(``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient
again in its backward, which over-counts by the group's size after a
row-parallel projection whose downstream gradient is replicated):

* :func:`copy_to_model`: forward identity, backward all-reduce.  Put
  before a sharded computation that reads a replicated input: each rank's
  gradient of the input holds only its shard's part.
* :func:`reduce_from_model`: forward all-reduce, backward identity.  Sums
  the shards' partial outputs; the gradient arriving is replicated.
* :func:`gather_from_model`: forward all-gather along a dim, backward the
  rank's slice of the gradient.

A ``None`` group means a single process: every function is the identity.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from gfe_mamba_torch.utils.profiling import annotate, to_host


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        start = group_rank(ctx.group) * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if group is None:
        return x
    return _GatherFromModel.apply(x, dim % x.dim(), group)


BUCKET_BYTES = 256 << 20


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group,
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each tensor by its mean over ``group``, in place: tensors
    of one dtype and device are packed into flat buckets of at most
    ``bucket_bytes`` (a larger tensor goes alone), one all-reduce per
    bucket.  The sum is divided by the group's size after the reduce, so
    every rank holds the same bits."""
    if group is None:
        return
    n = group_size(group)
    buckets: dict = {}
    for t in tensors:
        key = (t.dtype, t.device)
        open_ = buckets.setdefault(key, [[]])
        if open_[-1] and sum(x.numel() for x in open_[-1]) * t.element_size() \
                + t.numel() * t.element_size() > bucket_bytes:
            open_.append([])
        open_[-1].append(t)
    for groups in buckets.values():
        for bucket in groups:
            if len(bucket) == 1 and bucket[0].is_contiguous():
                dist.all_reduce(bucket[0], group=group)
                bucket[0].div_(n)
                continue
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            flat.div_(n)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


@torch.no_grad()
def all_true(flag: bool, device, group=None) -> bool:
    """Whether ``flag`` holds on every rank of ``group`` (the world when
    None and a process group exists)."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return to_host(t[0] > 0.5, "all_true")


def mean_over(values: Sequence[float], group, device) -> list[float]:
    """Python floats averaged over ``group`` in f64 (one all-reduce);
    the values themselves when ``group`` is None."""
    if group is None:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64, device=device)
    dist.all_reduce(t, group=group)
    with annotate("gfe.sync.mean_over"):
        return (t / group_size(group)).tolist()
