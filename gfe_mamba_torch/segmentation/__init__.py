"""The segmentation stack of the port (counterpart of
``gfe_mamba_tpu/segmentation``): losses, metrics, patch slicing,
sliding-window prediction, augmentation, HDF5 datasets over
``data/h5.py``, the 2D DSB2018 dataset and its predictor, and the
config-driven trainer."""
