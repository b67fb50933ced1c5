"""The ops of the port (counterpart of ``gfe_mamba_tpu/ops``); the
kernels behind them build at their first launch."""

from gfe_mamba_torch import lazy_exports

_EXPORTS = {
    "SingleConv": "blocks",
    "DoubleConv": "blocks",
    "ResNetBlock": "blocks",
    "ResNetBlockSE": "blocks",
    "Encoder": "blocks",
    "Decoder": "blocks",
    "make_encoder_stack": "blocks",
    "make_decoder_stack": "blocks",
    "ChannelSELayer": "blocks",
    "SpatialSELayer": "blocks",
    "ChannelSpatialSELayer": "blocks",
    "adaptive_normal": "volumetric",
    "scale_intensity_range": "volumetric",
    "resize_volume": "volumetric",
    "crop_foreground": "volumetric",
    "linear_recurrence": "scan",
    "selective_scan": "scan",
    "selective_scan_step": "scan",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
