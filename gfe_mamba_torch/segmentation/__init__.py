"""The segmentation stack of the port (counterpart of
``gfe_mamba_tpu/segmentation``): losses, metrics, patch slicing,
sliding-window prediction, augmentation, HDF5 datasets over
``data/h5.py``, the 2D DSB2018 dataset and its predictor, and the
config-driven trainer."""

from gfe_mamba_torch import lazy_exports

_EXPORTS = {
    "get_loss_criterion": "losses",
    "get_evaluation_metric": "metrics",
    "SliceBuilder": "slicers",
    "FilterSliceBuilder": "slicers",
    "sliding_window_predict": "predictor",
    "build_transforms": "transforms",
    "HDF5Dataset": "hdf5",
    "save_predictions_h5": "hdf5",
    "DSB2018Dataset": "dsb",
    "UNetTrainer": "trainer",
    "create_optimizer": "trainer",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
