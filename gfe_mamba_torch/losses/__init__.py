"""The losses of the port (counterpart of ``gfe_mamba_tpu/losses``)."""

from gfe_mamba_torch import lazy_exports

_EXPORTS = {
    "patch_adversarial_loss": "gan",
    "PerceptualLoss": "perceptual",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
