"""The data layer of the port (counterpart of ``gfe_mamba_tpu/data``)."""

from gfe_mamba_torch import lazy_exports

_EXPORTS = {
    "load_nifti": "nifti",
    "save_nifti": "nifti",
    "prepare_table": "table",
    "TablePreprocessor": "table",
    "MRI2PETDataset": "datasets",
    "MRIClassifyDataset": "datasets",
    "form_dataloader": "datasets",
    "classi_dataloader": "datasets",
    "DataLoader": "loader",
    "augment2d": "augment2d",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
