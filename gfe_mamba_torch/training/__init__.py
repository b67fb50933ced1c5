"""The trainers, optimiser, checkpoints and metrics of the port
(counterpart of ``gfe_mamba_tpu/training``)."""

from gfe_mamba_torch import lazy_exports

_EXPORTS = {
    "BinaryMetrics": "metrics",
    "binary_metrics": "metrics",
    "confusion_counts": "metrics",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
