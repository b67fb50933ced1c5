"""The segmentation stack of the port (counterpart of
``gfe_mamba_tpu/segmentation``): losses, metrics, patch slicing,
sliding-window prediction, augmentation, HDF5 datasets over
``data/h5.py`` and the config-driven trainer.  The 2D DSB dataset and
its predictor are not ported."""
