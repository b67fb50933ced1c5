"""The multi-process runtime (counterpart of
``gfe_mamba_tpu/parallel/multihost.py``).

One process per card under a launcher (``torchrun``), each with its own
device; ``torch.distributed`` carries the collectives.

* :func:`initialize` reads the launcher's ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` and joins the
  process group: ``nccl`` for CUDA devices, ``gloo`` for the CPU, or the
  backend the caller names.  Without ``WORLD_SIZE`` in the environment it
  is a no-op, so every entry point calls it unconditionally.  A failed
  initialisation raises; nothing falls back to one process.
* :func:`process_count`, :func:`process_index`, :func:`is_main_process`
  and :func:`local_batch_slice` as in JAX.
* :func:`host_local`: a module's whole state on the host, its
  tensor-parallel shards all-gathered.  Collective: every rank calls it,
  then only rank 0 writes what it returns.
* :func:`barrier`: a barrier with a timeout over a ``gloo`` group, so a
  rank that never arrives fails the others instead of hanging them.

JAX's ``form_global_array`` has no counterpart: there every process feeds
its rows into one logical global batch of a single SPMD program.  Here
each rank keeps its rows (its ``DataLoader`` ``process_shard``) and runs
its own step on them, and the trainers' mean all-reduce of the gradients
over the data group gives the global batch's gradient, the same value up
to the order of the f32 sums.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from gfe_mamba_torch import resolve_device

DEFAULT_TIMEOUT_S = 1800.0
_CPU_GROUP = None          # a gloo group of every rank, for barrier()


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize(device=None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               init_method: Optional[str] = None) -> torch.device:
    """Join the process group a launcher describes and return this rank's
    device.

    ``device``: ``None`` or ``"cuda"`` mean ``cuda:LOCAL_RANK`` (made the
    current device before any allocation or NCCL call); an indexed
    ``"cuda:k"`` or ``"cpu"`` is taken as given (two ranks on one card
    pass ``"cuda:0"`` with ``backend="gloo"``: NCCL refuses two ranks on
    one GPU).  ``backend`` defaults to ``nccl`` on CUDA, ``gloo`` on the
    CPU.  ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``).  Idempotent; without ``WORLD_SIZE`` in the
    environment it only resolves ``device``."""
    world = _env_int("WORLD_SIZE")
    if world is None:
        return resolve_device(device)
    rank = _env_int("RANK")
    if rank is None:
        raise RuntimeError(f"WORLD_SIZE={world} but RANK is not set: "
                           f"launch every process with torchrun (or set "
                           f"RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    local = _env_int("LOCAL_RANK") or 0
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank, timeout=timeout)
    global _CPU_GROUP
    _CPU_GROUP = dist.new_group(backend="gloo", timeout=timeout) \
        if backend != "gloo" else dist.group.WORLD
    return dev


def shutdown() -> None:
    """Leave the process group (a no-op in a single process)."""
    global _CPU_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _CPU_GROUP = None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """``accelerator.is_main_process`` (main_gan_vit.py:54)."""
    return process_index() == 0


def local_batch_slice(global_batch: int, pid: Optional[int] = None,
                      nproc: Optional[int] = None) -> slice:
    """Rows of the global batch this process owns: ``nproc`` contiguous
    equal blocks (``global_batch`` must divide evenly)."""
    pid = process_index() if pid is None else pid
    nproc = process_count() if nproc is None else nproc
    if global_batch % nproc:
        raise ValueError(
            f"global batch {global_batch} not divisible by {nproc} processes")
    per = global_batch // nproc
    return slice(pid * per, (pid + 1) * per)


def barrier(timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Wait for every rank, at most ``timeout_s`` seconds (then raise,
    naming the ranks that did not arrive).  A no-op in one process."""
    if not dist.is_initialized():
        return
    group = _CPU_GROUP or dist.group.WORLD
    dist.monitored_barrier(group=group,
                           timeout=datetime.timedelta(seconds=timeout_s))


def host_local(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``module``'s state_dict on the host as one process holds it: each
    tensor-parallel or expert-parallel shard (``parallel/sharding.py``)
    all-gathered over its model group along its split dim, everything
    else copied.  Collective over each sharded module's group."""
    from gfe_mamba_torch.parallel.collectives import all_gather_cat
    from gfe_mamba_torch.parallel.sharding import sharded_state

    splits = sharded_state(module)
    out = {}
    for key, value in module.state_dict().items():
        if key in splits:
            dim, group = splits[key]
            value = all_gather_cat(value.detach(), dim, group)
        out[key] = value.detach().cpu().clone()
    return out
