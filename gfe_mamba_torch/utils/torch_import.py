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
transposed into their slot of the dense-dispatch MoE's ``experts_gate`` /
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
