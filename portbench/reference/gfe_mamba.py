"""GFE-Mamba (Tinysqua/GFE-Mamba) as plain PyTorch: the generator
(:func:`portbench.reference.unet.vit_generator`), the combiner of the
ViT's input and output maps, and the Mamba classifier head, as
functions of a parameter dict keyed by the published state_dict
(``generator.``, ``combiner.``, ``classifier.`` prefixes).

The head: a CLS token, one embedding per categorical column (a shared
table with per-column offsets after two special rows) and a per-feature
affine lift of the numerical columns, then the generator's feature
tokens; ``depth`` residual Mamba blocks (RMSNorm, in_proj, causal
depthwise conv, SiLU, the selective scan with softplus(dt) in float32
walked step by step, the SiLU(z) gate, out_proj); the mean over tokens;
a residual cross-attention over the slice tokens of [MRI, PET]
(``b h w d c -> b (d c) (h w)``); a residual GEGLU feed-forward with
dropout; LayerNorm and the logit.  LayerNorm eps 1e-6, RMSNorm 1e-5."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.layers import (attention, layer_norm, linear,
                                        rms_norm)
from portbench.reference.unet import vit_generator

NUM_SPECIAL_TOKENS = 2


def sub(P, prefix):
    """The entries of ``P`` under ``prefix.``, the prefix taken off."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in P.items() if k.startswith(prefix + ".")}


def selective_scan(x, delta, A, B, C, D):
    """h_t = exp(delta_t A) h_{t-1} + delta_t x_t B_t; y_t = C_t h_t +
    D x_t, walked over t in float32."""
    h = x.new_zeros(x.shape[0], x.shape[2], A.shape[1])
    ys = []
    for t in range(x.shape[1]):
        d = delta[:, t, :, None]
        h = torch.exp(d * A) * h + d * x[:, t, :, None] * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1) + D * x


def mamba_block(P, pre, x, q, d_state=16, d_conv=4):
    h = rms_norm(x, P[f"{pre}.norm.weight"])
    m = f"{pre}.mixer"
    xi, z = linear(h, P[f"{m}.in_proj.weight"], None, q).chunk(2, dim=-1)
    L, ed = xi.shape[1], xi.shape[2]
    xi = q.out(F.conv1d(q(xi.transpose(1, 2)), q(P[f"{m}.conv1d.weight"]),
                        P[f"{m}.conv1d.bias"].float(), padding=d_conv - 1,
                        groups=ed))[..., :L].transpose(1, 2)
    xi = F.silu(xi)
    dt_rank = P[f"{m}.dt_proj.weight"].shape[1]
    dt, B, C = torch.split(linear(xi, P[f"{m}.x_proj.weight"], None, q),
                           [dt_rank, d_state, d_state], dim=-1)
    delta = F.softplus(linear(dt, P[f"{m}.dt_proj.weight"],
                              P[f"{m}.dt_proj.bias"], q))
    A = -torch.exp(P[f"{m}.A_log"].float())
    y = selective_scan(xi, delta, A, B, C, P[f"{m}.D"].float())
    y = y * F.silu(z)
    return linear(y, P[f"{m}.out_proj.weight"], None, q) + x


def embed(P, x_cat, x_num, categories):
    b = x_cat.shape[0]
    offsets = torch.tensor(categories, device=x_cat.device).cumsum(0) \
        - torch.tensor(categories, device=x_cat.device) + NUM_SPECIAL_TOKENS
    cat = P["categorical_embeds.weight"].float()[x_cat.long() + offsets]
    num = x_num.float()[..., None] * P["numerical_embedder.weights"].float() \
        + P["numerical_embedder.biases"].float()
    cls = P["cls_token"].float().expand(b, -1, -1)
    return torch.cat([cls, cat, num], dim=1)


def classifier(P, x_cat, x_num, feature, volumes, *, categories, depth,
               heads, q, dropout=None):
    """The Mamba head -> logits ``(B,)``.  ``dropout`` is the final
    feed-forward's ``(keep mask (B, 1, 2 * dim), rate)``; None in eval
    mode."""
    x = torch.cat([embed(P, x_cat, x_num, categories), feature.float()],
                  dim=1)
    for i in range(depth):
        x = mamba_block(P, f"transformer.layers.{i}", x, q)
    x = x.mean(dim=1, keepdim=True)
    cond = torch.cat([v.float().reshape(v.shape[0], -1,
                                        v.shape[3] * v.shape[4])
                      .transpose(1, 2) for v in volumes], dim=1)
    c = "final_cross"
    qh = linear(x, P[f"{c}.q_proj.weight"], P[f"{c}.q_proj.bias"], q)
    k = linear(cond, P[f"{c}.k_proj.weight"], P[f"{c}.k_proj.bias"], q)
    v = linear(cond, P[f"{c}.v_proj.weight"], P[f"{c}.v_proj.bias"], q)
    y = attention(qh, k, v, heads, q)
    x = linear(y, P[f"{c}.out_proj.weight"], P[f"{c}.out_proj.bias"], q) + x
    f = "final_feed"
    y = layer_norm(x, P[f"{f}.0.weight"], P[f"{f}.0.bias"])
    y, gates = linear(y, P[f"{f}.1.weight"], P[f"{f}.1.bias"], q).chunk(2, -1)
    y = y * F.gelu(gates, approximate="tanh")
    if dropout is not None:
        keep, rate = dropout
        y = torch.where(keep, y / (1.0 - rate), 0.0)
    x = linear(y, P[f"{f}.4.weight"], P[f"{f}.4.bias"], q) + x
    x = layer_norm(x[:, 0], P["to_logits.0.weight"], P["to_logits.0.bias"])
    return linear(x, P["to_logits.1.weight"], P["to_logits.1.bias"],
                  q)[:, 0]


def combiner(P, mid_input, mid_output, q):
    x = torch.cat([mid_input, mid_output], dim=-1)
    b, h, w, c = x.shape
    x = x.reshape(b, h * w, c).transpose(1, 2)
    return linear(x, P["vit_mid_linear.weight"], P["vit_mid_linear.bias"],
                  q).transpose(1, 2)


def generator(P, mri, cfg, q, drop=None):
    g = cfg["generator"]
    return vit_generator(P, mri, levels=len(g["f_maps"]),
                         order=g["layer_order"], groups=g["num_groups"],
                         fold=g["fold_factor"],
                         vit=dict(patch=g["vit_patch_size"],
                                  heads=g["vit_heads"],
                                  depth=g["vit_depth"]), q=q, drop=drop)


def forward(P, mri, x_cat, x_num, cfg, q, dropout=None):
    """The whole pipeline -> ``(logits (B,), pet (B, X, Y, Z, 1))``."""
    mid_input, mid_output, pet = generator(sub(P, "generator"), mri, cfg, q)
    feature = combiner(sub(P, "combiner"), mid_input, mid_output, q)
    h = cfg["head"]
    logits = classifier(sub(P, "classifier"), x_cat, x_num, feature,
                        [mri, pet], categories=h["categories"],
                        depth=h["depth"], heads=h["heads"], q=q,
                        dropout=dropout)
    return logits, pet
