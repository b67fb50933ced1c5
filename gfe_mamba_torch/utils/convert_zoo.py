"""JAX variables of a ViT-zoo model -> the port's ``state_dict``
(``models/vit_zoo*.py``); :func:`utils.convert.state_dict_from_jax` calls
it when given the port model.

Most zoo models keep the flax module names, so a flax path becomes the
port key with three rewrites: under a port ``models/vit.py::Transformer``
the JAX ``ViTTransformer`` names become the reference's
(``attn_<i>/to_out`` -> ``layers.<i>.0.to_out.0``, ``ff_<i>/Dense_1`` ->
``layers.<i>.1.net.4``, ...); a model's own table renames what it names
after the vendored reference (``ViT3D``, ``SimpleViT3D``, ``ViViT``,
``CCT``) or flax names automatically (``LayerNorm_0``, ``Dense_0``); the
leaves take torch's layouts (Dense kernels ``(I, O)`` -> ``(O, I)``, 2D
conv kernels ``(kh, kw, I, O)`` -> ``(O, I, kh, kw)``, 3D likewise,
``scale`` -> ``weight``, ``batch_stats`` mean / var -> ``running_mean``
/ ``running_var``).  Two models also move values: ViT3D's position rows
from JAX's ``(h w f)`` token order to the reference's ``(f h w)``, and
SimpleViT3D's patch features from JAX's ``(pf p1 p2 c)`` packing to the
reference's ``(p1 p2 pf c)``.  The result must fill the model's
state_dict exactly, key for key and shape for shape.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

# ViTTransformer -> the port's Transformer, on the path below its prefix
_VIT_RULES = [
    (r"^attn_(\d+)/to_out/", r"layers/\1/0/to_out/0/"),
    (r"^attn_(\d+)/", r"layers/\1/0/"),
    (r"^ff_(\d+)/LayerNorm_0/", r"layers/\1/1/net/0/"),
    (r"^ff_(\d+)/Dense_0/", r"layers/\1/1/net/1/"),
    (r"^ff_(\d+)/Dense_1/", r"layers/\1/1/net/4/"),
]



def _auto_embed(prefix: str = "") -> list:
    """flax's automatic names of a patch embedding (under ``prefix``)."""
    return [(rf"^{prefix}LayerNorm_0/", f"{prefix}to_patch_embedding/1/"),
            (rf"^{prefix}Dense_0/", f"{prefix}to_patch_embedding/2/"),
            (rf"^{prefix}LayerNorm_1/", f"{prefix}to_patch_embedding/3/")]


_AUTO_EMBED = _auto_embed()
_NAMED_EMBED = [(r"^patch_norm1/", "to_patch_embedding/1/"),
                (r"^patch_embed/", "to_patch_embedding/2/"),
                (r"^patch_norm2/", "to_patch_embedding/3/")]
_CCT_BLOCK = r"classifier/blocks/\1/"

# per model class: (pattern on the '/'-joined flax path, replacement)
_MODEL_RULES = {
    "ClassifierViT": _AUTO_EMBED,
    "SimpleViT": _AUTO_EMBED,
    "ViT3D": _AUTO_EMBED + [(r"^transformer/norm/", "mlp_head/0/"),
                            (r"^mlp_head/(kernel|bias)$", r"mlp_head/1/\1")],
    "SimpleViT3D": _NAMED_EMBED,
    "ViViT": _NAMED_EMBED,
    "DinoHead": [(r"^Dense_0/", "net/0/"), (r"^Dense_1/", "net/2/")],
    "CCT": [(r"^tokenizer/conv_(\d+)/", r"tokenizer/conv_layers/\1/0/"),
            (r"^pre_norm_(\d+)/", _CCT_BLOCK + "pre_norm/"),
            (r"^attn_(\d+)/", _CCT_BLOCK + "self_attn/"),
            (r"^norm1_(\d+)/", _CCT_BLOCK + "norm1/"),
            (r"^fc1_(\d+)/", _CCT_BLOCK + "linear1/"),
            (r"^fc2_(\d+)/", _CCT_BLOCK + "linear2/"),
            (r"^final_norm/", "classifier/norm/"),
            (r"^(attention_pool|fc)/", r"classifier/\1/"),
            (r"^class_emb$", "classifier/class_emb"),
            (r"^pos_embedding$", "classifier/positional_emb")],
    # LayerScale's flax ``scale`` is the port's ``gamma`` (a ``scale``
    # leaf becomes a norm's ``weight``)
    "XCiT": [(r"_scale/scale$", "_scale/gamma")],
    "ATSViT": _AUTO_EMBED,
    "DistillableViT": _AUTO_EMBED,
    "DistillWrapper": _auto_embed("student/"),
}

_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _leaf(path: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    head, _, leaf = path.rpartition("/")
    if leaf == "kernel":
        k = value.ndim - 2
        value = value.T if value.ndim == 2 else np.transpose(
            value, (k + 1, k, *range(k)))
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf in _STATS:
        leaf = _STATS[leaf]
    return (f"{head}/{leaf}" if head else leaf), value


def _rename(path: str, rules) -> str:
    for pattern, repl in rules:
        path = re.sub(pattern, repl, path)
    return path


def _fix_vit3d(model, out: dict) -> None:
    """JAX's position rows run (h w f), the reference's (f h w)."""
    f, h, w = model.grid
    pos = out["pos_embedding"]
    rest = pos[:, 1:].reshape(1, h, w, f, -1).permute(0, 3, 1, 2, 4)
    out["pos_embedding"] = torch.cat(
        [pos[:, :1], rest.reshape(1, f * h * w, -1)], 1).contiguous()


def _fix_simple_vit3d(model, out: dict) -> None:
    """JAX packs a patch (pf p1 p2 c), the reference (p1 p2 pf c)."""
    pf, ph, pw = model.to_patch_embedding[0].patch
    keys = ("to_patch_embedding.1.weight", "to_patch_embedding.1.bias",
            "to_patch_embedding.2.weight")
    for key in keys:
        t = out[key]
        lead = t.shape[:-1]
        t = t.reshape(*lead, pf, ph, pw, -1)
        n = len(lead)
        out[key] = t.permute(*range(n), n + 1, n + 2, n, n + 3) \
            .reshape(*lead, -1).contiguous()


_FIXES = {"ViT3D": _fix_vit3d, "SimpleViT3D": _fix_simple_vit3d}


def zoo_state_dict_from_jax(variables: Mapping[str, Any],
                            model: nn.Module) -> dict[str, torch.Tensor]:
    """The state_dict of the zoo ``model`` (any class of
    ``models/vit_zoo*.py``) holding the flax ``variables`` (``{"params":
    ...}``, with ``"batch_stats"`` for MobileViT, or the params alone), as
    float32; raises unless it fills the model's state_dict exactly."""
    from gfe_mamba_torch.models.vit import Transformer

    params, stats = variables, {}
    if "params" in variables and set(variables) <= {"params",
                                                    "batch_stats"}:
        params, stats = variables["params"], variables.get("batch_stats", {})
    rules = _MODEL_RULES.get(type(model).__name__, [])
    prefixes = [name.replace(".", "/") + "/"
                for name, mod in model.named_modules()
                if isinstance(mod, Transformer)]
    out = {}
    for path, value in [*_flatten(params), *_flatten(stats)]:
        path = _rename(path, rules)
        for pre in prefixes:
            if path.startswith(pre):
                path = pre + _rename(path[len(pre):], _VIT_RULES)
        path, value = _leaf(path, value)
        out[path.replace("/", ".")] = torch.from_numpy(
            np.array(value, dtype=np.float32))
    fix = _FIXES.get(type(model).__name__)
    if fix is not None:
        fix(model, out)
    want = model.state_dict()
    if set(out) != set(want):
        raise KeyError(f"{type(model).__name__}: JAX keys without a port "
                       f"tensor {sorted(set(out) - set(want))[:8]}, port "
                       f"tensors without a JAX key "
                       f"{sorted(set(want) - set(out))[:8]}")
    for key, value in out.items():
        if value.shape != want[key].shape:
            raise ValueError(f"{key}: JAX shape {tuple(value.shape)} != the "
                             f"port's {tuple(want[key].shape)}")
    return out
