"""HF checkpoints -> the port's modules (counterpart of
``gfe_mamba_tpu/utils/torch_import.py``, whose Jamba part this is).

:func:`import_jamba_hf` loads a state dict of transformers'
``JambaForCausalLM`` (the ai21labs/Jamba-v0.1 names) into the port's
``JambaLM``.  The port keeps torch layouts, so most tensors pass as they
are: the depthwise ``conv1d`` weight ``(d_inner, 1, d_conv)``, ``A_log``,
``D``, the inner ``dt/b/c`` RMSNorms (``dt_layernorm``, ``B_layernorm``,
``C_layernorm`` here), and GQA's ``k_proj`` / ``v_proj`` at
``num_key_value_heads``.  Each layer's experts ``experts.<e>.
{gate,up,down}_proj.weight`` (``(f, d)``, ``(f, d)``, ``(d, f)``) are
transposed into their slot of the MoE's stacked ``experts_gate`` /
``experts_up`` ``(E, d, f)`` and ``experts_down`` ``(E, f, d)``.  With
tied embeddings (the model has no ``lm_head``) the checkpoint's
``lm_head.weight``, the embedding itself, is not read.

The import copies one checkpoint tensor at a time into the model's own
storage and stacks no experts on the host, so it needs no memory beyond
the checkpoint's and the model's: Jamba-v0.1's 16 experts of 4096 x
14336 are 3.8 GB per projection and layer in f32.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# HF Jamba mamba-mixer names -> the port's MambaBlock names
_MAMBA = {
    "A_log": "A_log", "D": "D",
    "in_proj.weight": "in_proj.weight", "in_proj.bias": "in_proj.bias",
    "conv1d.weight": "conv1d.weight", "conv1d.bias": "conv1d.bias",
    "x_proj.weight": "x_proj.weight",
    "dt_proj.weight": "dt_proj.weight", "dt_proj.bias": "dt_proj.bias",
    "out_proj.weight": "out_proj.weight", "out_proj.bias": "out_proj.bias",
    "dt_layernorm.weight": "dt_layernorm.weight",
    "b_layernorm.weight": "B_layernorm.weight",
    "c_layernorm.weight": "C_layernorm.weight",
}
_EXPERT = re.compile(r"model\.layers\.(\d+)\.feed_forward\.experts\.(\d+)\."
                     r"(gate|up|down)_proj\.weight")


def _tensor(value) -> torch.Tensor:
    """A numpy array or CPU tensor as a CPU tensor."""
    if torch.is_tensor(value):
        return value.detach()
    return torch.from_numpy(np.asarray(value))


def build_jamba_hf_mapping(state_dict: Mapping) -> dict[str, str]:
    """HF key -> the port's ``JambaLM`` key, for every key but the
    stacked experts (:func:`_stack_hf_experts`) and ``lm_head.weight``,
    which :func:`import_jamba_hf` maps only where the model has a head."""
    mapping = {"model.embed_tokens.weight": "embedding.weight",
               "model.final_layernorm.weight": "final_layernorm.weight"}
    for key in state_dict:
        m = re.match(r"model\.layers\.(\d+)\.(.*)", key)
        if not m:
            continue
        base, rest = f"jamba.layers.{m.group(1)}", m.group(2)
        if rest == "input_layernorm.weight":
            mapping[key] = f"{base}.input_layernorm.weight"
        elif rest == "pre_ff_layernorm.weight":
            mapping[key] = f"{base}.pre_moe_layernorm.weight"
        elif re.fullmatch(r"self_attn\.[qkvo]_proj\.weight", rest):
            mapping[key] = f"{base}.{rest}"
        elif rest.startswith("mamba.") and rest[6:] in _MAMBA:
            mapping[key] = f"{base}.mamba.{_MAMBA[rest[6:]]}"
        elif rest == "feed_forward.router.weight":
            mapping[key] = f"{base}.moe.router.weight"
        elif re.fullmatch(r"feed_forward\.(gate|up|down)_proj\.weight", rest):
            # a layer with one expert: the plain SwiGLU MLP
            mapping[key] = f"{base}.moe.expert.{rest.split('.', 1)[1]}"
    return mapping


def _stack_hf_experts(state_dict: Mapping) -> dict[str, list]:
    """``model.layers.<i>.feed_forward.experts.<e>.<proj>_proj.weight``
    -> ``jamba.layers.<i>.moe.experts_<proj>``: the experts' transposed
    weights (views, not copies) in expert order, the slices of the
    stacked tensor."""
    groups: dict = {}
    for key, value in state_dict.items():
        m = _EXPERT.fullmatch(key)
        if m:
            layer, expert, proj = int(m.group(1)), int(m.group(2)), m.group(3)
            groups.setdefault((layer, proj), {})[expert] = \
                _tensor(value).transpose(0, 1)
    out = {}
    for (layer, proj), experts in groups.items():
        if sorted(experts) != list(range(len(experts))):
            raise KeyError(f"layer {layer} {proj}_proj: experts "
                           f"{sorted(experts)} are not 0..E-1")
        out[f"jamba.layers.{layer}.moe.experts_{proj}"] = [
            experts[e] for e in range(len(experts))]
    return out


@torch.no_grad()
def import_jamba_hf(state_dict: Mapping, model: torch.nn.Module
                    ) -> torch.nn.Module:
    """Load an HF Jamba state dict (numpy arrays or CPU tensors) into the
    port's ``JambaLM`` ``model`` in place, on the model's device and in
    its dtypes, and return it.  Every tensor of the model must be filled
    from the checkpoint and match its shape (checked before anything is
    copied); a checkpoint key that maps to nothing raises too."""
    mapping = build_jamba_hf_mapping(state_dict)
    has_head = "lm_head.weight" in model.state_dict()
    if has_head:
        mapping["lm_head.weight"] = "lm_head.weight"
    out = {port: _tensor(state_dict[hf]) for hf, port in mapping.items()
           if hf in state_dict}
    experts = _stack_hf_experts(state_dict)
    unread = [k for k in state_dict if k not in mapping
              and not _EXPERT.fullmatch(k)
              and not (k == "lm_head.weight" and not has_head)]
    if unread:
        raise KeyError(f"HF keys with no place in JambaLM: {unread[:8]}")
    want = model.state_dict()
    missing = sorted(set(want) - set(out) - set(experts))
    if missing:
        raise KeyError(f"JambaLM tensors the checkpoint lacks: {missing[:8]}")
    shapes = {key: value.shape for key, value in out.items()}
    for key, views in experts.items():
        shapes[key] = torch.Size([len(views), *views[0].shape])
        if any(v.shape != views[0].shape for v in views):
            raise ValueError(f"{key}: the experts' shapes differ")
    for key, shape in shapes.items():
        if key not in want:
            raise KeyError(f"{key}: no such tensor in JambaLM")
        if shape != want[key].shape:
            raise ValueError(f"{key}: checkpoint shape {tuple(shape)} != "
                             f"the model's {tuple(want[key].shape)}")
    for key, value in out.items():
        want[key].copy_(value)
    for key, views in experts.items():
        for target, value in zip(want[key], views):
            target.copy_(value)
    return model


# ---------------------------------------------------------------------------
# The vendored ViT zoo's 3D-capable members (vit_pytorch_diy's vit_3d.py,
# simple_vit_3d.py, vivit.py, cct.py / cct_3d.py) -> models/vit_zoo*.py.
# Those port models carry the reference's keys and layouts (ViT3D its
# (f h w) position rows, SimpleViT3D its (p1 p2 pf c) patches, CCT its
# channels-first convs), so an import is a strict load_state_dict plus
# what the JAX mappings do beyond renaming.

# simple_vit_3d.py's keys -> the port's ``Transformer``'s: its bias-free
# plain ``to_out`` Linear and its dropout-free feed-forward, whose second
# Linear is ``net.3``
_SIMPLE_FLAVOUR = ((re.compile(r"(\.layers\.\d+\.0\.to_out)\.weight$"),
                    r"\1.0.weight"),
                   (re.compile(r"(\.layers\.\d+\.1\.net)\.3\."), r"\1.4."))


@torch.no_grad()
def _load(model: torch.nn.Module, state_dict: Mapping) -> torch.nn.Module:
    """A strict ``load_state_dict`` (every tensor of the model filled, no
    key left over, shapes equal), onto the model's device and dtypes."""
    model.load_state_dict({k: _tensor(v) for k, v in state_dict.items()})
    return model


def import_vit3d(state_dict: Mapping, model: torch.nn.Module
                 ) -> torch.nn.Module:
    """vit_3d.py ``ViT`` checkpoint -> the port's ``ViT3D`` ``model``, in
    place; returns it."""
    return _load(model, state_dict)


def import_simple_vit3d(state_dict: Mapping, model: torch.nn.Module
                        ) -> torch.nn.Module:
    """simple_vit_3d.py ``SimpleViT`` checkpoint -> the port's
    ``SimpleViT3D``: its keys renamed to the port's, a zero bias for each
    bias-free attention output (as JAX's importer zero-fills)."""
    sd = {}
    for key, value in state_dict.items():
        for pattern, repl in _SIMPLE_FLAVOUR:
            key = pattern.sub(repl, key)
        sd[key] = _tensor(value)
        if key.endswith("to_out.0.weight") and \
                key[:-len("weight")] + "bias" not in state_dict:
            sd[key[:-len("weight")] + "bias"] = torch.zeros(
                sd[key].shape[0])
    return _load(model, sd)


def import_vivit(state_dict: Mapping, model: torch.nn.Module
                 ) -> torch.nn.Module:
    """vivit.py ``ViT`` (factorized) checkpoint -> the port's ``ViViT``."""
    return _load(model, state_dict)


def import_cct(state_dict: Mapping, model: torch.nn.Module
               ) -> torch.nn.Module:
    """cct.py / cct_3d.py ``CCT`` checkpoint -> the port's ``CCT`` (2D or
    3D, as the model was built).  A 'sine' position table is recomputed,
    not read: the checkpoint's copy is checked against it and dropped."""
    sd = dict(state_dict)
    key = "classifier.positional_emb"
    table = getattr(model.classifier, "positional_emb", None)
    if key in sd and table is not None and \
            key not in model.state_dict():
        if not torch.allclose(_tensor(sd[key]).float(), table.float().cpu(),
                              atol=1e-5):
            raise ValueError(f"{key}: not the sine table the model "
                             f"recomputes")
        del sd[key]
    return _load(model, sd)
