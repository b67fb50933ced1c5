"""AI21 Jamba (HF ``JambaForCausalLM``) as plain PyTorch in float32, as
functions of a parameter dict keyed by the program's ``JambaLM``
state_dict (``embedding.weight``, ``jamba.layers.<i>.*``,
``final_layernorm.weight``, ``lm_head.weight``) and of the published
config's keys (``hidden_size``, ``mamba_d_state``, ...).

A layer is RMSNorm -> Mamba or attention -> + residual, then RMSNorm ->
MoE or MLP -> + residual; the stack ends in an RMSNorm and the head.

* Mamba-1: in_proj to (x, z); the causal depthwise conv with its bias;
  SiLU; x_proj to (dt, B, C), each through its RMSNorm; dt_proj with its
  bias, softplus; the selective scan walked step by step in float32
  (``gfe_mamba.selective_scan``); the SiLU(z) gate; out_proj.
* Attention: grouped-query heads (each key/value head serves
  ``heads / kv_heads`` query heads), causal softmax scaled by
  head_dim^-1/2, no positional encoding; taken in blocks of queries so
  that a long sequence fits.
* MoE: the router's logits in float32, softmax, top-k, the k weights not
  renormalised; each expert's SwiGLU applied to the tokens that chose it
  and added back with its weight.  MLP: the same SwiGLU, dense.

Every matrix product takes its operands through a ``Rounding`` ``q``
(identity for the reference, fp8 for the control); TF32 is set off by
``precision.reference_mode``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.gfe_mamba import selective_scan, sub
from portbench.reference.layers import einsum, linear, rms_norm

QUERY_BLOCK = 512


def is_attention(cfg: dict, i: int) -> bool:
    return (i - cfg["attn_layer_offset"]) % cfg["attn_layer_period"] == 0


def is_moe(cfg: dict, i: int) -> bool:
    return (i - cfg["expert_layer_offset"]) % cfg["expert_layer_period"] \
        == 0


def mm(a, b, q):
    """``a @ b`` on rounded operands."""
    return q.out(q(a) @ q(b))


def mamba(P, x, cfg, q):
    """The Mamba mixer of one layer (``P``: its ``mamba.*`` entries) on
    ``x (B, L, D)``."""
    eps, n = cfg["rms_norm_eps"], cfg["mamba_d_state"]
    k = cfg["mamba_d_conv"]
    xi, z = linear(x, P["in_proj.weight"], None, q).chunk(2, dim=-1)
    L, ed = xi.shape[1], xi.shape[2]
    xi = q.out(F.conv1d(q(xi.transpose(1, 2)), q(P["conv1d.weight"]),
                        None, padding=k - 1, groups=ed))[..., :L]
    xi = F.silu(xi + P["conv1d.bias"].float()[:, None]).transpose(1, 2)
    dt, B, C = torch.split(linear(xi, P["x_proj.weight"], None, q),
                           [cfg["mamba_dt_rank"], n, n], dim=-1)
    dt = rms_norm(dt, P["dt_layernorm.weight"], eps)
    B = rms_norm(B, P["B_layernorm.weight"], eps)
    C = rms_norm(C, P["C_layernorm.weight"], eps)
    delta = F.softplus(linear(dt, P["dt_proj.weight"], P["dt_proj.bias"],
                              q))
    A = -torch.exp(P["A_log"].float())
    y = selective_scan(xi, delta, A, B, C, P["D"].float()) * F.silu(z)
    return linear(y, P["out_proj.weight"], None, q)


def attention(P, x, cfg, q):
    """Causal grouped-query attention of one layer (``P``: its
    ``self_attn.*`` entries) on ``x (B, L, D)``."""
    b, L, _ = x.shape
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // heads

    def split(t, n):
        return t.reshape(b, L, n, hd).transpose(1, 2)

    qh = split(linear(x, P["q_proj.weight"], None, q), heads)
    kh = split(linear(x, P["k_proj.weight"], None, q), kv) \
        .repeat_interleave(heads // kv, dim=1)
    vh = split(linear(x, P["v_proj.weight"], None, q), kv) \
        .repeat_interleave(heads // kv, dim=1)
    out = []
    for s in range(0, L, QUERY_BLOCK):
        e = min(L, s + QUERY_BLOCK)
        logits = einsum("bhid,bhjd->bhij", qh[:, :, s:e], kh[:, :, :e],
                        q) / math.sqrt(hd)
        mask = torch.ones(e - s, e, dtype=torch.bool,
                          device=x.device).tril(s)
        attn = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        out.append(einsum("bhij,bhjd->bhid", attn, vh[:, :, :e], q))
    out = torch.cat(out, dim=2).transpose(1, 2).reshape(b, L, heads * hd)
    return linear(out, P["o_proj.weight"], None, q)


def swiglu(x, gate, up, down, q):
    """down(silu(x gate) * (x up)), weights ``(D, F)``, ``(D, F)``,
    ``(F, D)``."""
    return mm(F.silu(mm(x, gate, q)) * mm(x, up, q), down, q)


def moe(P, x, cfg, q):
    """The routed experts of one layer (``P``: its ``moe.*`` entries)."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    logits = linear(x, P["router.weight"], None, q)
    top_w, top_i = torch.softmax(logits, dim=-1).topk(
        cfg["num_experts_per_tok"], dim=-1)
    out = torch.zeros_like(x)
    for e in range(P["experts_gate"].shape[0]):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(x[rows], P["experts_gate"][e].float(),
                   P["experts_up"][e].float(),
                   P["experts_down"][e].float(), q)
        out.index_add_(0, rows, y * top_w[rows, slot, None])
    return out.reshape(shape)


def mlp(P, x, q):
    """The dense SwiGLU of one layer (``P``: its ``moe.expert.*``)."""
    return linear(F.silu(linear(x, P["gate_proj.weight"], None, q))
                  * linear(x, P["up_proj.weight"], None, q),
                  P["down_proj.weight"], None, q)


def embed(P, tokens):
    return P["embedding.weight"].float()[tokens]


def layer(P, i: int, x, cfg, q):
    """Layer ``i`` (``P``: its entries, the ``jamba.layers.<i>.`` prefix
    taken off) on the residual stream ``x (B, L, D)`` in float32."""
    eps = cfg["rms_norm_eps"]
    h = rms_norm(x, P["input_layernorm.weight"], eps)
    if is_attention(cfg, i):
        x = x + attention(sub(P, "self_attn"), h, cfg, q)
    else:
        x = x + mamba(sub(P, "mamba"), h, cfg, q)
    h = rms_norm(x, P["pre_moe_layernorm.weight"], eps)
    if is_moe(cfg, i):
        return x + moe(sub(P, "moe"), h, cfg, q)
    return x + mlp(sub(P, "moe.expert"), h, q)


def head(P, x, cfg, q):
    """The final RMSNorm and the LM head -> logits ``(B, n, vocab)``."""
    h = rms_norm(x, P["final_layernorm.weight"], cfg["rms_norm_eps"])
    return linear(h, P["lm_head.weight"], None, q)


def forward(P, tokens, cfg, q):
    """Logits ``(B, L, vocab)`` of ``tokens (B, L)`` at every position."""
    x = embed(P, tokens)
    for i in range(cfg["num_hidden_layers"]):
        x = layer(sub(P, f"jamba.layers.{i}"), i, x, cfg, q)
    return head(P, x, cfg, q)
