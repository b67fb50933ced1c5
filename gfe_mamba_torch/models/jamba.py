"""Jamba: interleaved Mamba / grouped-query attention layers, each
followed by a SwiGLU MLP or a top-k routed mixture of them (counterpart
of ``gfe_mamba_tpu/models/jamba.py``).

The experts' dispatch is dense, as in the JAX package: the experts'
SwiGLU weights are stacked into ``(E, D, F)`` parameters
(``experts_gate``, ``experts_up``, ``experts_down``), every token goes
through every expert as one batched einsum, and the outputs are summed
with hard top-k gates (the softmax weights of the k chosen experts, not
renormalised).  The router's softmax runs in f32 and the gates are cast
to the activations' dtype, so bf16 runs choose the experts f32 would.
Every projection and expert einsum computes in the promoted dtype of its
input and its weights (``models/promote.py``), as flax's do.

``step`` runs one token through caches from ``init_cache``: a Mamba
layer's ``(h, conv window)``, an attention layer's ``(k, v)``, which
starts as ``(None, None)`` and grows along the sequence.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.models.attention import _heads, _merge
from gfe_mamba_torch.models.dropout import Dropout
from gfe_mamba_torch.models.mamba import MambaBlock, MambaConfig, RMSNorm
from gfe_mamba_torch.models.promote import Linear, promote
from gfe_mamba_torch.parallel.collectives import (copy_to_model,
                                                  reduce_from_model)


@dataclass(frozen=True)
class JambaConfig:
    d_model: int
    n_layers: int
    mlp_size: int

    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-5

    # mamba
    d_state: int = 16
    expand_factor: int = 2
    d_conv: int = 4
    dt_rank: int | str = "auto"
    dt_min: float = 0.001
    dt_max: float = 0.1
    dt_init: str = "random"
    dt_scale: float = 1.0
    dt_init_floor: float = 1e-4
    bias: bool = False
    conv_bias: bool = True
    inner_layernorms: bool = True

    # attention
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    attention_dropout: float = 0.0

    # MoE
    num_experts: int = 16
    num_experts_per_tok: int = 2

    # structure: layer i is attention / an MoE when (i - offset) % period
    # == 0
    attn_layer_offset: int = 4
    attn_layer_period: int = 8
    expert_layer_offset: int = 1
    expert_layer_period: int = 2

    # language modelling
    vocab_size: int = 65536
    tie_lm_weights: bool = True

    @property
    def mamba_config(self) -> MambaConfig:
        return MambaConfig(
            d_model=self.d_model, n_layers=0, dt_rank=self.dt_rank,
            d_state=self.d_state, expand_factor=self.expand_factor,
            d_conv=self.d_conv, dt_min=self.dt_min, dt_max=self.dt_max,
            dt_init=self.dt_init, dt_scale=self.dt_scale,
            dt_init_floor=self.dt_init_floor,
            rms_norm_eps=self.rms_norm_eps, bias=self.bias,
            conv_bias=self.conv_bias, inner_layernorms=self.inner_layernorms)

    def is_attn_layer(self, i: int) -> bool:
        return (i - self.attn_layer_offset) % self.attn_layer_period == 0

    def is_expert_layer(self, i: int) -> bool:
        return (i - self.expert_layer_offset) % self.expert_layer_period == 0


class GQAttention(nn.Module):
    """Grouped-query attention, bias-free projections.  Without a cache
    it is causal over the sequence; with one (``(None, None)`` at the
    first token) the new keys and values are appended along the length
    and no mask applies."""

    def __init__(self, config: JambaConfig):
        super().__init__()
        d, n_heads = config.d_model, config.num_attention_heads
        n_kv = config.num_key_value_heads
        if n_heads < n_kv or n_heads % n_kv:
            raise ValueError(f"{n_heads} attention heads do not group over "
                             f"{n_kv} key/value heads")
        self.n_heads, self.n_kv = n_heads, n_kv
        self.head_dim = d // n_heads
        self.q_proj = Linear(d, n_heads * self.head_dim, bias=False)
        self.k_proj = Linear(d, n_kv * self.head_dim, bias=False)
        self.v_proj = Linear(d, n_kv * self.head_dim, bias=False)
        self.o_proj = Linear(n_heads * self.head_dim, d, bias=False)
        self.attn_drop = Dropout(config.attention_dropout)

    def forward(self, x: torch.Tensor, cache=None):
        q = _heads(self.q_proj(x), self.n_heads)
        k = _heads(self.k_proj(x), self.n_kv)
        v = _heads(self.v_proj(x), self.n_kv)
        causal = cache is None
        if cache is not None:
            past_k, past_v = cache
            if past_k is not None:
                k = torch.cat([past_k, k], dim=2)
                v = torch.cat([past_v, v], dim=2)
            cache = (k, v)
        groups = self.n_heads // self.n_kv
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
        logits = torch.einsum("bhid,bhjd->bhij", *promote(q, k)) \
            / math.sqrt(self.head_dim)
        if causal:
            li, lj = logits.shape[-2:]
            mask = torch.ones(li, lj, dtype=torch.bool,
                              device=x.device).tril(lj - li)
            logits = logits.masked_fill(~mask, float("-inf"))
        attn = self.attn_drop(torch.softmax(logits, dim=-1))
        out = torch.einsum("bhij,bhjd->bhid", *promote(attn, v))
        return self.o_proj(_merge(out)), cache


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, d_model: int, mlp_size: int):
        super().__init__()
        self.gate_proj = Linear(d_model, mlp_size, bias=False)
        self.up_proj = Linear(d_model, mlp_size, bias=False)
        self.down_proj = Linear(mlp_size, d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class SparseMoEBlock(nn.Module):
    """Top-k routed SwiGLU experts, dense dispatch.  Returns the output
    and the router logits ``(B*L, E)``; with one expert, a plain
    :class:`MLP` (``expert``) and ones ``(B*L, 1)``.

    Expert parallel (``parallel/sharding.py`` sets ``ep_group`` and
    ``ep_index`` and leaves this rank's slice of the experts): the router
    runs whole on every rank, the dense dispatch runs over this rank's
    experts with their gates, and the partial outputs are all-reduced over
    the model group."""

    ep_group = None
    ep_index = 0

    def __init__(self, d_model: int, num_experts: int,
                 num_experts_per_tok: int, mlp_size: int):
        super().__init__()
        self.num_experts, self.k = num_experts, num_experts_per_tok
        if num_experts == 1:
            self.expert = MLP(d_model, mlp_size)
            return
        self.router = Linear(d_model, num_experts, bias=False)
        self.experts_gate = nn.Parameter(
            torch.empty(num_experts, d_model, mlp_size))
        self.experts_up = nn.Parameter(
            torch.empty(num_experts, d_model, mlp_size))
        self.experts_down = nn.Parameter(
            torch.empty(num_experts, mlp_size, d_model))

    def forward(self, x: torch.Tensor):
        bsz, seq, _ = x.shape
        if self.num_experts == 1:
            return self.expert(x), torch.ones(bsz * seq, 1, dtype=x.dtype,
                                              device=x.device)
        router_logits = self.router(x)                       # (B, L, E)
        weights = torch.softmax(router_logits.float(), dim=-1)
        top_w, top_i = weights.topk(self.k, dim=-1)
        gates = torch.zeros_like(weights).scatter(-1, top_i, top_w) \
            .to(x.dtype)
        if self.ep_group is not None:
            local = self.experts_gate.shape[0]
            x = copy_to_model(x, self.ep_group)
            gates = copy_to_model(gates, self.ep_group).narrow(
                -1, self.ep_index * local, local)
        g = torch.einsum("bld,edf->belf", *promote(x, self.experts_gate))
        u = torch.einsum("bld,edf->belf", *promote(x, self.experts_up))
        y = torch.einsum("belf,efd->beld",
                         *promote(F.silu(g) * u, self.experts_down))
        out = reduce_from_model(torch.einsum("beld,ble->bld", y, gates),
                                self.ep_group)
        return out, router_logits.reshape(bsz * seq, self.num_experts)


class JambaLayer(nn.Module):
    """RMSNorm -> attention or Mamba -> + residual; RMSNorm -> MoE (or
    MLP) -> + residual."""

    def __init__(self, config: JambaConfig, is_attn: bool,
                 num_experts: int):
        super().__init__()
        self.is_attn = is_attn
        if is_attn:
            self.self_attn = GQAttention(config)
        else:
            self.mamba = MambaBlock(config.mamba_config)
        k = config.num_experts_per_tok if num_experts > 1 else 1
        self.moe = SparseMoEBlock(config.d_model, num_experts, k,
                                  config.mlp_size)
        self.input_layernorm = RMSNorm(config.d_model, config.rms_norm_eps)
        self.pre_moe_layernorm = RMSNorm(config.d_model,
                                         config.rms_norm_eps)

    def _moe(self, x: torch.Tensor):
        h, router_logits = self.moe(self.pre_moe_layernorm(x))
        return x + h, router_logits

    def forward(self, x: torch.Tensor):
        h = self.input_layernorm(x)
        h = self.self_attn(h)[0] if self.is_attn else self.mamba(h)
        return self._moe(x + h)

    def step(self, x: torch.Tensor, cache):
        """``x (B, 1, D)``, one token."""
        h = self.input_layernorm(x)
        if self.is_attn:
            h, cache = self.self_attn(h, cache)
        else:
            h, cache = self.mamba.step(h[:, 0], cache)
            h = h[:, None]
        return self._moe(x + h)[0], cache


class Jamba(nn.Module):
    """The layer stack; returns ``(x, router logits of every layer)``."""

    def __init__(self, config: JambaConfig):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(
            JambaLayer(config, config.is_attn_layer(i),
                       config.num_experts if config.is_expert_layer(i)
                       else 1)
            for i in range(config.n_layers))

    def forward(self, x: torch.Tensor):
        router_logits = []
        for layer in self.layers:
            x, logits = layer(x)
            router_logits.append(logits)
        return x, router_logits

    def step(self, x: torch.Tensor, caches: list):
        """``x (B, 1, D)``, one token, through :meth:`init_cache`'s caches."""
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.step(x, cache)
            new_caches.append(cache)
        return x, new_caches

    def init_cache(self, batch: int, dtype=torch.float32,
                   device=None) -> list:
        """Zero Mamba caches and empty attention caches, on ``device`` (the
        model's when omitted)."""
        cfg, mc = self.config, self.config.mamba_config
        device = device or self.layers[0].input_layernorm.weight.device
        return [(None, None) if cfg.is_attn_layer(i) else
                (torch.zeros(batch, mc.d_inner, cfg.d_state, dtype=dtype,
                             device=device),
                 torch.zeros(batch, cfg.d_conv - 1, mc.d_inner, dtype=dtype,
                             device=device))
                for i in range(cfg.n_layers)]


def load_balancing_loss(router_logits: Sequence[torch.Tensor],
                        num_experts: int,
                        num_experts_per_tok: int) -> torch.Tensor:
    """Switch-style auxiliary loss over the MoE layers' router logits
    (layers with one expert are left out)."""
    stacked = torch.cat([r for r in router_logits if r.shape[1] > 1])
    weights = torch.softmax(stacked, dim=-1)
    selected = weights.topk(num_experts_per_tok, dim=-1).indices
    mask = F.one_hot(selected, num_experts).float()
    tokens_per_expert = mask.mean(dim=0)
    router_prob_per_expert = weights.mean(dim=0)
    return (tokens_per_expert * router_prob_per_expert[None]).sum() \
        * num_experts


class JambaLM(nn.Module):
    """Embedding + Jamba + RMSNorm + LM head (tied to the embedding by
    default).  The embedding is drawn N(0, initializer_range)."""

    def __init__(self, config: JambaConfig):
        super().__init__()
        self.config = config
        self.embedding = nn.Embedding(config.vocab_size, config.d_model)
        self.embedding.init_std = config.initializer_range
        self.jamba = Jamba(config)
        self.final_layernorm = RMSNorm(config.d_model, config.rms_norm_eps)
        if not config.tie_lm_weights:
            self.lm_head = Linear(config.d_model, config.vocab_size,
                                  bias=False)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.tie_lm_weights:
            x, table = promote(x, self.embedding.weight)
            return x @ table.T
        return self.lm_head(x)

    def forward(self, tokens: torch.Tensor):
        x, router_logits = self.jamba(self.embedding(tokens))
        return self._logits(self.final_layernorm(x)), router_logits

    def step(self, token: torch.Tensor, caches: list):
        """``token (B,)`` -> ``(logits (B, vocab), caches)``."""
        x, caches = self.jamba.step(self.embedding(token)[:, None], caches)
        return self._logits(self.final_layernorm(x))[:, 0], caches

    @classmethod
    def from_pretrained(cls, path: str, device=None) -> "JambaLM":
        """An HF Jamba checkpoint saved at the local directory ``path``
        (``save_pretrained``'s; ai21labs/Jamba-v0.1's structure) as a
        ``JambaLM`` in eval mode on ``device`` (the card unless 'cpu'):
        the config from the checkpoint's ``config.json``, the weights by
        ``utils/torch_import.py::import_jamba_hf``.  Needs
        ``transformers``, imported here; hub names are refused."""
        import os

        from transformers import AutoModelForCausalLM

        from gfe_mamba_torch import resolve_device
        from gfe_mamba_torch.utils.torch_import import import_jamba_hf

        if not os.path.isdir(path):
            raise ValueError(f"from_pretrained takes a local checkpoint "
                             f"directory, got {path!r}")
        device = resolve_device(device)
        hf = AutoModelForCausalLM.from_pretrained(
            path, local_files_only=True, use_mamba_kernels=False)
        c = hf.config
        config = JambaConfig(
            vocab_size=c.vocab_size, d_model=c.hidden_size,
            n_layers=c.num_hidden_layers, rms_norm_eps=c.rms_norm_eps,
            mlp_size=c.intermediate_size, inner_layernorms=True,
            expand_factor=c.mamba_expand, dt_rank=c.mamba_dt_rank,
            d_state=c.mamba_d_state, d_conv=c.mamba_d_conv,
            conv_bias=c.mamba_conv_bias, bias=c.mamba_proj_bias,
            initializer_range=c.initializer_range,
            num_experts=c.num_experts,
            num_experts_per_tok=c.num_experts_per_tok,
            attn_layer_offset=c.attn_layer_offset,
            attn_layer_period=c.attn_layer_period,
            expert_layer_offset=c.expert_layer_offset,
            expert_layer_period=c.expert_layer_period,
            num_key_value_heads=c.num_key_value_heads,
            num_attention_heads=c.num_attention_heads,
            attention_dropout=c.attention_dropout,
            tie_lm_weights=c.tie_word_embeddings)
        # built on the device, filled there from the checkpoint
        with torch.device("meta"):
            model = cls(config)
        model.to_empty(device=device)
        return import_jamba_hf(hf.state_dict(), model).eval()


@torch.no_grad()
def generate(model: JambaLM, prompt: torch.Tensor, num_tokens: int,
             generator: torch.Generator, *, temperature: float = 1.0,
             top_k: int | None = None) -> torch.Tensor:
    """Autoregressive sampling: the prompt ``(B, P)`` goes token by token
    through the caches, then ``num_tokens`` tokens are drawn from
    softmax(logits / temperature), restricted to the ``top_k`` largest
    when given, with ``generator``.  Returns ``(B, P + num_tokens)``."""
    caches = model.jamba.init_cache(prompt.shape[0])
    for t in range(prompt.shape[1]):
        logits, caches = model.step(prompt[:, t], caches)
    tokens = [prompt]
    for _ in range(num_tokens):
        scaled = logits.float() / max(temperature, 1e-6)
        if top_k is not None:
            kth = scaled.topk(top_k, dim=-1).values[:, -1:]
            scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        current = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                    generator=generator)[:, 0]
        tokens.append(current[:, None])
        logits, caches = model.step(current, caches)
    return torch.cat(tokens, dim=1)
