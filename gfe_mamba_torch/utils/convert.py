"""JAX parameter trees -> the port's ``state_dict``.

The inverse of the transforms in ``gfe_mamba_tpu/utils/torch_import.py``
(kept as this package's own copy): flax Dense kernels ``(I, O)`` become
Linear weights ``(O, I)``; conv kernels ``(kx, ky, kz, I, O)`` become
``(O, I, kx, ky, kz)``; transposed-conv kernels are flipped spatially into
``(I, O, kx, ky, kz)``; depthwise conv1d kernels ``(k, 1, ED)`` become
``(ED, 1, k)``; 2D conv kernels ``(kh, kw, I, O)`` become
``(O, I, kh, kw)``; LayerNorm/GroupNorm ``scale`` becomes ``weight``.  The
module paths are rewritten to the reference torch names the port uses.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

# (pattern on the '/'-joined flax path, replacement), applied in order
_RENAMES = [
    (r"(^|/)encoder_(\d+)/", r"\1encoders/\2/"),
    (r"(^|/)decoder_(\d+)/", r"\1decoders/\2/"),
    (r"/groupnorm_\d+/", "/groupnorm/"),
    (r"(^|/)upsampling/kernel$",
     r"\1upsampling/upsample/conv_transposed/kernel"),
    # ViT bottleneck
    (r"(^|/)patch_norm_in/", r"\1to_patch_embedding/1/"),
    (r"(^|/)patch_embed/", r"\1to_patch_embedding/2/"),
    (r"(^|/)patch_norm_out/", r"\1to_patch_embedding/3/"),
    (r"(^|/)out_norm_tokens/", r"\1from_patch_embedding/0/"),
    (r"(^|/)token_mix/", r"\1from_patch_embedding/2/"),
    (r"(^|/)patch_unembed/", r"\1from_patch_embedding/4/"),
    (r"(^|/)out_norm_patch/", r"\1from_patch_embedding/5/"),
    (r"(^|/)attn_(\d+)/to_out/", r"\1layers/\2/0/to_out/0/"),
    (r"(^|/)attn_(\d+)/", r"\1layers/\2/0/"),
    (r"(^|/)ff_(\d+)/LayerNorm_0/", r"\1layers/\2/1/net/0/"),
    (r"(^|/)ff_(\d+)/Dense_0/", r"\1layers/\2/1/net/1/"),
    (r"(^|/)ff_(\d+)/Dense_1/", r"\1layers/\2/1/net/4/"),
    # classifier
    (r"(^|/)embed/", r"\1"),
    (r"(^|/)layer_(\d+)/", r"\1layers/\2/"),
    (r"(^|/)(final_feed|to_logits)/LayerNorm_0/", r"\1\2/0/"),
    (r"(^|/)(final_feed|to_logits)/Dense_0/", r"\1\2/1/"),
    (r"(^|/)final_feed/Dense_1/", r"\1final_feed/4/"),
    (r"(^|/)dt_proj_kernel$", r"\1dt_proj/kernel"),
    (r"(^|/)dt_proj_bias$", r"\1dt_proj/bias"),
    # leaves
    (r"/(kernel|scale|embedding)$", "/weight"),
    (r"^(kernel|scale|embedding)$", "weight"),
]


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _transform(path: str, value: np.ndarray) -> np.ndarray:
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "dt_proj_kernel" or (leaf == "kernel" and value.ndim == 2):
        return value.T
    if leaf == "kernel" and value.ndim == 3:       # depthwise conv1d
        return np.transpose(value, (2, 1, 0))
    if leaf == "kernel" and value.ndim == 4:       # 2D conv
        return np.transpose(value, (3, 2, 0, 1))
    if leaf == "kernel" and value.ndim == 5:
        if path.endswith("upsampling/kernel"):
            return np.transpose(value, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1]
        return np.transpose(value, (4, 3, 0, 1, 2))
    return value


def state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Convert a flax parameter tree (nested dicts of arrays, optionally
    under a ``'params'`` key) into the port's state_dict, as float32.

    Works on the whole ``GFEMamba`` tree (keys under ``generator.``,
    ``combiner.`` and ``classifier.``), on the tree of any ported
    submodule (the generator, a ResNetBlock, the ViT, a MambaBlock, the
    classifier), and on the Stage-1 trees whose flax names the port keeps:
    ``PatchDiscriminator`` (``conv_i``, ``norm_i``, ``conv_pre``,
    ``norm_pre``, ``conv_out``) and the perceptual loss's
    ``SqueezeFeatures`` (``conv1``, ``fire1..8``).  ``group_norm_act``
    (``ops/group_norm.py``) needs nothing here: its scale and bias are
    arguments, and no model holds it."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, value in _flatten(params):
        key = path
        for pattern, repl in _RENAMES:
            key = re.sub(pattern, repl, key)
        out[key.replace("/", ".")] = torch.from_numpy(
            np.array(_transform(path, value), dtype=np.float32))
    return out

