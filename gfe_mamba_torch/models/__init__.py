"""The models of the port (counterpart of ``gfe_mamba_tpu/models``)."""

from gfe_mamba_torch import lazy_exports

_EXPORTS = {
    "ImageToImageViT": "vit",
    "ViTTransformer": "vit",
    "SelfAttention": "attention",
    "CrossAttention": "attention",
    "Mamba": "mamba",
    "MambaConfig": "mamba",
    "FTTransformerEncoder": "ft_transformer",
    "TransformerCross": "ft_transformer",
    "NumericalEmbedder": "ft_transformer",
    "TabularEmbedder": "ft_transformer",
    "CrossTransformerBoth": "ft_transformer",
    "CrossTransformer": "ft_transformer",
    "FTTransformerCrossImg": "ft_transformer",
    "FTTransformerCross": "ft_transformer",
    "CrossMambaBoth": "fusion",
    "CrossJambaBoth": "fusion",
    "CrossMambaAblation": "fusion",
    "CombineClassifierVitMid": "combiners",
    "CombinePyramid": "combiners",
    "Jamba": "jamba",
    "JambaConfig": "jamba",
    "JambaLM": "jamba",
    "SparseMoEBlock": "jamba",
    "load_balancing_loss": "jamba",
    "GFEMamba": "pipeline",
    "build_gfe_mamba": "pipeline",
    "UNet": "unet3d",
    "UNet3D": "unet3d",
    "ResidualUNet3D": "unet3d",
    "ResidualUNetSE3D": "unet3d",
    "UNet2D": "unet3d",
    "ResidualUNet2D": "unet3d",
    "ResidualMidUNet3D": "unet3d",
    "ResidualMidUNet3DViT": "unet3d",
    "get_model": "unet3d",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
