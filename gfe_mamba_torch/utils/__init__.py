"""Experiment folders, weight conversion, initialisers and profiling
hooks of the port (counterpart of ``gfe_mamba_tpu/utils``)."""

from gfe_mamba_torch import lazy_exports

_EXPORTS = {
    "ExperimentDir": "experiment",
    "count_parameters": "experiment",
    "save_plot_data": "experiment",
    "volume_grid": "experiment",
    "save_volume_grid": "experiment",
    "profiling": "profiling",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
