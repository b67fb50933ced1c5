from gfe_mamba_torch.data import augment2d  # noqa: F401 (as the JAX package exports it)
