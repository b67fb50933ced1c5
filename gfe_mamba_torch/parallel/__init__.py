"""The parallel layer (counterpart of ``gfe_mamba_tpu/parallel``): the
process runtime (``multihost``), the (data, model) process grid
(``mesh``), the collectives that sit inside a gradient (``collectives``),
the tensor- and expert-parallel split of the parameters (``sharding``)
and the multi-process dry run (``dryrun``)."""
