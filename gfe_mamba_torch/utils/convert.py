"""JAX parameter trees <-> the port's ``state_dict``.

The inverse of the transforms in ``gfe_mamba_tpu/utils/torch_import.py``
(kept as this package's own copy): flax Dense kernels ``(I, O)`` become
Linear weights ``(O, I)``; conv kernels ``(kx, ky, kz, I, O)`` become
``(O, I, kx, ky, kz)``; transposed-conv kernels are flipped spatially into
``(I, O, kx, ky, kz)``; depthwise conv1d kernels ``(k, 1, ED)`` become
``(ED, 1, k)``; 2D conv kernels ``(kh, kw, I, O)`` become
``(O, I, kh, kw)``; LayerNorm/GroupNorm ``scale`` becomes ``weight``.  The
module paths are rewritten to the reference torch names the port uses.
:func:`jax_tree_from_state_dict` goes the other way, so that the npz files
of ``training/checkpoint.py`` carry the JAX package's keys and layouts.

A model whose parameters ``parallel/sharding.py`` split over a model
group crosses the same way: :func:`jax_tree_from_module` gathers its
shards (collective: every rank of the group calls it) into the tree an
unsharded model gives, and :func:`load_jax_tree` loads a whole tree into
it, each rank taking its shard.
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
    (r"/(groupnorm|batchnorm)_\d+/", r"/\1/"),
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
    # TransformerCross's per-layer cross-attention
    (r"(^|/)cross_(\d+)/", r"\1cross/\2/"),
    # classifier
    (r"(^|/)embed/", r"\1"),
    (r"(^|/)layer_(\d+)/", r"\1layers/\2/"),
    (r"(^|/)(final_feed|to_logits)/LayerNorm_0/", r"\1\2/0/"),
    (r"(^|/)(final_feed|to_logits)/Dense_0/", r"\1\2/1/"),
    (r"(^|/)final_feed/Dense_1/", r"\1final_feed/4/"),
    (r"(^|/)dt_proj_kernel$", r"\1dt_proj/kernel"),
    (r"(^|/)dt_proj_bias$", r"\1dt_proj/bias"),
    # ResNet3D: the reference's stage lists and downsample Sequentials
    (r"(^|/)layer(\d+)_(\d+)/", r"\1layer\2/\3/"),
    (r"(^|/)downsample/", r"\1downsample/0/"),
    (r"(^|/)downsample_bn/", r"\1downsample/1/"),
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
    if leaf == "kernel" and path.endswith("upsampling/kernel"):
        # transposed conv (*k, I, O) -> (I, O, *k), flipped spatially
        k = value.ndim - 2
        flip = (slice(None),) * 2 + (slice(None, None, -1),) * k
        return np.transpose(value, (k, k + 1, *range(k)))[flip]
    if leaf == "kernel" and value.ndim == 4:       # 2D conv
        return np.transpose(value, (3, 2, 0, 1))
    if leaf == "kernel" and value.ndim == 5:
        return np.transpose(value, (4, 3, 0, 1, 2))
    return value


def state_dict_from_jax(params: Mapping[str, Any],
                        model: torch.nn.Module | None = None
                        ) -> dict[str, torch.Tensor]:
    """Convert a flax parameter tree (nested dicts of arrays, optionally
    under a ``'params'`` key) into the port's state_dict, as float32.

    Given ``model``, a ViT-zoo model of ``models/vit_zoo*.py``, the tree is
    its flax variables and ``utils/convert_zoo.py`` maps them onto that
    model's state_dict.

    Works on the whole ``GFEMamba`` tree (keys under ``generator.``,
    ``combiner.`` and ``classifier.``, any mixer), on the tree of any
    ported submodule (the generator, a ResNetBlock, the ViT, a
    MambaBlock, a classifier head, the FT-Transformer models, Jamba and
    ``JambaLM``, whose stacked ``experts_*`` pass as they are), and on
    the Stage-1 trees whose flax names the port keeps:
    ``PatchDiscriminator`` (``conv_i``, ``norm_i``, ``conv_pre``,
    ``norm_pre``, ``conv_out``) and the perceptual loss's
    ``SqueezeFeatures`` (``conv1``, ``fire1..8``), and on the segmentation
    UNets', whose flax names the port keeps too, and on the baselines
    and leftovers of ``models/``: ``ResNet3D`` (the flax ``layer<s>_<b>``,
    ``downsample`` and ``downsample_bn`` become the reference's
    ``layer<s>.<b>``, ``downsample.0`` and ``downsample.1``),
    ``MVCSNet``, the legacy combiners and the 2D ``PatchDiscriminator``
    (flax names kept); flax variables
    ``{"params": ..., "batch_stats": ...}`` give the BatchNorms' running
    statistics as well.  ``group_norm_act``
    (``ops/group_norm.py``) needs nothing here: its scale and bias are
    arguments, and no model holds it."""
    if model is not None:
        from gfe_mamba_torch.utils.convert_zoo import zoo_state_dict_from_jax
        return zoo_state_dict_from_jax(params, model)
    stats = {}
    if set(params) <= {"params", "batch_stats"} and "params" in params:
        params, stats = params["params"], params.get("batch_stats", {})
    out = {}
    for path, value in _flatten(params):
        out[_port_key(path)] = torch.from_numpy(
            np.array(_transform(path, value), dtype=np.float32))
    for path, value in _flatten(stats):
        head, leaf = _port_key(path).rsplit(".", 1)
        out[f"{head}.{_STAT_NAMES[leaf]}"] = torch.from_numpy(
            np.array(value, dtype=np.float32))
    return out


# flax BatchNorm's ``batch_stats`` leaves and the port's buffers
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _port_key(path: str) -> str:
    for pattern, repl in _RENAMES:
        path = re.sub(pattern, repl, path)
    return path.replace("/", ".")



# The inverse: port state_dict keys ('/'-joined) -> flax paths, applied in
# order.  ViT rules (which the FT-Transformer encoders share) come before
# the Mamba and Jamba ones: all live under a ``transformer/layers/<i>/``
# prefix, the ViT's with a /0/ or /1/ after it.
_INVERSE_RENAMES = [
    (r"(^|/)encoders/(\d+)/", r"\1encoder_\2/"),
    (r"(^|/)decoders/(\d+)/", r"\1decoder_\2/"),
    (r"(^|/)upsampling/upsample/conv_transposed/weight$",
     r"\1upsampling/kernel"),
    # ViT bottleneck
    (r"(^|/)to_patch_embedding/1/", r"\1patch_norm_in/"),
    (r"(^|/)to_patch_embedding/2/", r"\1patch_embed/"),
    (r"(^|/)to_patch_embedding/3/", r"\1patch_norm_out/"),
    (r"(^|/)from_patch_embedding/0/", r"\1out_norm_tokens/"),
    (r"(^|/)from_patch_embedding/2/", r"\1token_mix/"),
    (r"(^|/)from_patch_embedding/4/", r"\1patch_unembed/"),
    (r"(^|/)from_patch_embedding/5/", r"\1out_norm_patch/"),
    (r"(^|/)layers/(\d+)/0/to_out/0/", r"\1attn_\2/to_out/"),
    (r"(^|/)layers/(\d+)/0/", r"\1attn_\2/"),
    (r"(^|/)layers/(\d+)/1/net/0/", r"\1ff_\2/LayerNorm_0/"),
    (r"(^|/)layers/(\d+)/1/net/1/", r"\1ff_\2/Dense_0/"),
    (r"(^|/)layers/(\d+)/1/net/4/", r"\1ff_\2/Dense_1/"),
    (r"(^|/)cross/(\d+)/", r"\1cross_\2/"),
    # classifier: the tabular embedder is the flax submodule ``embed``
    (r"^(classifier/)?(categorical_embeds/|numerical_embedder/|cls_token$)",
     r"\1embed/\2"),
    (r"(^|/)layers/(\d+)/(mixer|norm|self_attn|mamba|moe|input_layernorm|"
     r"pre_moe_layernorm)/", r"\1layer_\2/\3/"),
    (r"(^|/)(final_feed|to_logits)/0/", r"\1\2/LayerNorm_0/"),
    (r"(^|/)(final_feed|to_logits)/1/", r"\1\2/Dense_0/"),
    (r"(^|/)final_feed/4/", r"\1final_feed/Dense_1/"),
    (r"(^|/)dt_proj/weight$", r"\1dt_proj_kernel"),
    (r"(^|/)dt_proj/bias$", r"\1dt_proj_bias"),
    (r"(^|/)layer(\d+)/(\d+)/", r"\1layer\2_\3/"),
    (r"(^|/)downsample/0/", r"\1downsample/"),
    (r"(^|/)downsample/1/", r"\1downsample_bn/"),
]


def _flax_leaf(path: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """The flax leaf name and layout of a port ``weight`` (or
    ``dt_proj_kernel``) at ``path``."""
    if path.endswith("dt_proj_kernel"):
        return path, value.T
    head, leaf = path.rsplit("/", 1) if "/" in path else ("", path)
    if leaf != "weight":
        return path, value
    join = (lambda name: f"{head}/{name}") if head else (lambda name: name)
    if re.search(r"(^|/)(categorical_embeds|embedding)$", head):
        return join("embedding"), value
    if value.ndim == 1:
        # RMSNorm (a Mamba layer's ``norm``, Jamba's ``*_layernorm``)
        # keeps ``weight``; LayerNorm, GroupNorm and InstanceNorm call it
        # ``scale``
        if re.search(r"(^|/)(layer_\d+/norm|\w+_layernorm)$", head):
            return path, value
        return join("scale"), value
    if value.ndim == 2:
        return join("kernel"), value.T
    if value.ndim == 3:                            # depthwise conv1d
        return join("kernel"), np.transpose(value, (2, 1, 0))
    if value.ndim == 4:                            # 2D conv
        return join("kernel"), np.transpose(value, (2, 3, 1, 0))
    return join("kernel"), np.transpose(value, (2, 3, 4, 1, 0))


def _norm_index(order: str, conv: str, norm: str) -> int:
    """flax names a SingleConv's GroupNorm ``groupnorm_<position of 'g' in
    its order>`` (a BatchNorm ``batchnorm_<of 'b'>``); a ResNetBlock's
    conv3's order is the block's without non-linearities."""
    if conv == "conv3":
        order = "".join(c for c in order if c not in "rel")
    return order.index(norm[0])


def flax_entry(key: str, value: np.ndarray,
               layer_order: str = "gcr") -> tuple[str, np.ndarray]:
    """The ``'/'``-joined flax path and flax layout of the port's
    state_dict entry ``key``."""
    path = key.replace(".", "/")
    deconv = path.endswith("upsampling/upsample/conv_transposed/weight")
    for pattern, repl in _INVERSE_RENAMES:
        path = re.sub(pattern, repl, path)
    path = re.sub(r"(^|/)(conv[23]|SingleConv[12])/(groupnorm|batchnorm)/",
                  lambda m: f"{m.group(1)}{m.group(2)}/{m.group(3)}_"
                  f"{_norm_index(layer_order, m.group(2), m.group(3))}/",
                  path)
    if deconv:
        k = value.ndim - 2
        flip = (slice(None),) * 2 + (slice(None, None, -1),) * k
        return path, np.transpose(value[flip], (*range(2, k + 2), 0, 1))
    return _flax_leaf(path, value)


def jax_tree_from_state_dict(state_dict: Mapping[str, Any],
                             layer_order: str = "gcr") -> dict:
    """The inverse of :func:`state_dict_from_jax`: the port's state_dict
    (or any ported submodule's) as a nested flax tree of f32 numpy arrays,
    in flax names and layouts.  ``layer_order`` is the generator's order
    string, which names its GroupNorms.  Transposed-conv weights
    ``(I, O, k, k, k)`` are flipped spatially and become ``(k, k, k, I,
    O)``."""
    tree: dict = {}
    for key, tensor in state_dict.items():
        if key.rsplit(".", 1)[-1] in _STAT_NAMES.values():
            raise ValueError(f"{key}: running statistics go to flax's "
                             f"batch_stats (jax_variables_from_state_dict)")
        path, value = flax_entry(key, _numpy(tensor), layer_order)
        _put(tree, path, value)
    return tree


def _numpy(tensor) -> np.ndarray:
    return np.asarray(tensor.detach().float().cpu()
                      if torch.is_tensor(tensor) else tensor, np.float32)


def _put(tree: dict, path: str, value: np.ndarray) -> None:
    node = tree
    *parents, leaf = path.split("/")
    for name in parents:
        node = node.setdefault(name, {})
    node[leaf] = np.ascontiguousarray(value)


def jax_variables_from_state_dict(state_dict: Mapping[str, Any],
                                  layer_order: str = "gcr") -> dict:
    """The flax variables of a port state_dict: ``{"params": ...}`` as
    :func:`jax_tree_from_state_dict` gives them, and with BatchNorms
    ``"batch_stats"`` too (``running_mean`` / ``running_var`` ->
    ``mean`` / ``var``)."""
    leaves = {v: k for k, v in _STAT_NAMES.items()}
    params, stats = {}, {}
    for key, tensor in state_dict.items():
        head, leaf = key.rsplit(".", 1)
        if leaf in leaves:
            path, _ = flax_entry(head + ".weight", np.zeros(1), layer_order)
            _put(stats, path.rsplit("/", 1)[0] + "/" + leaves[leaf],
                 _numpy(tensor))
        else:
            params[key] = tensor
    out = {"params": jax_tree_from_state_dict(params, layer_order)}
    if stats:
        out["batch_stats"] = stats
    return out


def flatten_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """``{'/'-joined path: array}`` of a nested tree, the npz key form of
    the JAX package's ``save_params_npz``."""
    return dict(_flatten(tree, prefix))


def jax_tree_from_module(module: torch.nn.Module,
                         layer_order: str = "gcr") -> dict:
    """:func:`jax_tree_from_state_dict` of ``module`` with its
    tensor-parallel shards all-gathered (``parallel.multihost.host_local``,
    collective)."""
    from gfe_mamba_torch.parallel.multihost import host_local
    return jax_tree_from_state_dict(host_local(module), layer_order)


def load_jax_tree(module: torch.nn.Module, params: Mapping[str, Any]) -> None:
    """Load a whole flax tree into ``module`` in place; a split parameter
    takes this rank's shard of it."""
    from gfe_mamba_torch.parallel.sharding import shard_state_dict
    module.load_state_dict(shard_state_dict(module,
                                            state_dict_from_jax(params)))
