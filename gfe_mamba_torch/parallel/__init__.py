"""The parallel layer (counterpart of ``gfe_mamba_tpu/parallel``): the
process runtime (``multihost``), the (data, model) process grid
(``mesh``), the collectives that sit inside a gradient (``collectives``),
the tensor- and expert-parallel split of the parameters (``sharding``)
and the multi-process dry run (``dryrun``)."""

from gfe_mamba_torch import lazy_exports

# batch_sharding, replicated and shard_batch place a global array on a
# JAX mesh; each rank here keeps its own rows, so they have no twin.
_EXPORTS = {
    "make_mesh": "mesh",
    "infer_param_shardings": "sharding",
    "apply_param_shardings": "sharding",
    "multihost": "multihost",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
