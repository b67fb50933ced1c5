"""The (data, model) process grid (counterpart of
``gfe_mamba_tpu/parallel/mesh.py``).

JAX builds one named ``Mesh`` of devices and lets GSPMD insert the
collectives.  The port lays the ranks out the same way, row-major over
the axes as ``np.reshape`` lays JAX's devices, and builds the two kinds
of process groups the collectives run over:

* a *data row* (the ranks of one data index): the ``model`` group, over
  which tensor- and expert-parallel shards are reduced and gathered;
* a *model column* (the ranks of one model index): the ``data`` group,
  over which the trainers average the gradients.

What JAX's placement helpers become:

* ``batch_sharding`` / ``shard_batch``: each rank keeps its rows of the
  global batch, :meth:`Mesh.local_rows` (the CLIs' loaders read only
  those rows, ``DataLoader(process_shard=...)``);
* ``replicated``: the weights are drawn from the same seed on every rank,
  and :func:`replicate` broadcasts a module's state from rank 0 at
  start-up where they might not be.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """``grid[d, m]`` is the rank at data index ``d`` and model index
    ``m``; ``rank`` is this process's (None when the mesh was laid out
    from a rank list without processes), ``data_group`` / ``model_group``
    its column and row (None without processes)."""

    axes: dict
    grid: np.ndarray
    rank: Optional[int] = None
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def data_size(self) -> int:
        return self.axes.get("data", 1)

    @property
    def model_size(self) -> int:
        return self.axes.get("model", 1)

    def _coords(self) -> tuple[int, int]:
        d, m = np.argwhere(self.grid.reshape(self.data_size,
                                             self.model_size) == self.rank)[0]
        return int(d), int(m)

    @property
    def data_index(self) -> int:
        return self._coords()[0] if self.rank is not None else 0

    @property
    def model_index(self) -> int:
        return self._coords()[1] if self.rank is not None else 0

    def local_rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch: its data index's block."""
        from gfe_mamba_torch.parallel.multihost import local_batch_slice
        return local_batch_slice(global_batch, self.data_index,
                                 self.data_size)


def _resolve_axes(axes: Optional[Mapping[str, int]], n: int) -> dict:
    """JAX's ``make_mesh`` rule: one axis may be -1 (what remains); the
    product must be ``n``."""
    axes = {"data": n} if axes is None else dict(axes)
    known = int(np.prod([s for s in axes.values() if s != -1]))
    for name, size in axes.items():
        if size == -1:
            axes[name] = n // known
    total = int(np.prod(list(axes.values())))
    if total != n:
        raise ValueError(f"mesh {axes} needs {total} devices, have {n}")
    unknown = set(axes) - {"data", "model"}
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)}: the port lays "
                         f"out 'data' and 'model' only")
    return axes


def make_mesh(axes: Optional[Mapping[str, int]] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The grid of ``axes`` (``{axis: size}``; default: every rank on
    ``data``) over ``ranks``.

    With ``ranks`` given the mesh is only laid out (no process group is
    needed).  Otherwise the ranks are the world's, and every rank builds
    every row and column group (``new_group`` is collective), keeping its
    own two; a single process gets the 1x1 mesh with no groups."""
    if ranks is not None:
        ranks = list(ranks)
        axes = _resolve_axes(axes, len(ranks))
        return Mesh(axes, np.asarray(ranks).reshape(tuple(axes.values())))
    world = dist.get_world_size() if dist.is_initialized() else 1
    axes = _resolve_axes(axes, world)
    grid = np.arange(world).reshape(tuple(axes.values()))
    mesh = Mesh(axes, grid,
                rank=dist.get_rank() if dist.is_initialized() else 0)
    if not dist.is_initialized():
        return mesh
    square = grid.reshape(mesh.data_size, mesh.model_size)
    for d in range(mesh.data_size):
        group = dist.new_group([int(r) for r in square[d]])
        if mesh.rank in square[d]:
            mesh.model_group = group
    for m in range(mesh.model_size):
        group = dist.new_group([int(r) for r in square[:, m]])
        if mesh.rank in square[:, m]:
            mesh.data_group = group
    return mesh


@torch.no_grad()
def replicate(module: torch.nn.Module, src: int = 0) -> None:
    """Broadcast every parameter and buffer of ``module`` from rank
    ``src``, so all ranks start from one state (a no-op in one
    process)."""
    if not dist.is_initialized():
        return
    for tensor in [*module.parameters(), *module.buffers()]:
        dist.broadcast(tensor.data, src)
