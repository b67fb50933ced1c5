"""Jamba: interleaved Mamba / grouped-query attention layers, each
followed by a SwiGLU MLP or a top-k routed mixture of them (counterpart
of ``gfe_mamba_tpu/models/jamba.py``).

The experts' SwiGLU weights are stacked into ``(E, D, F)`` parameters
(``experts_gate``, ``experts_up``, ``experts_down``), as in the JAX
package, whose dispatch is dense.  Here the dispatch is routed: the
(token, slot) pairs are grouped by expert, each expert's products run
over its own tokens only (:class:`SparseMoEBlock`: one grouped product
per weight on the card in bf16, one product per expert elsewhere), and
the outputs are added back with hard top-k gates (the softmax weights of
the k chosen experts, not renormalised), so no token goes through an
expert that did not choose it, none is dropped, and the result is the
dense dispatch's.  The router's softmax runs in f32 and the gates are
cast to the activations' dtype, so bf16 runs choose the experts f32
would.  Every projection and expert product computes in the promoted
dtype of its input and its weights (``models/promote.py``), as flax's
do.

Attention runs ``F.scaled_dot_product_attention`` (grouped-query heads as
they are, no mask tensor for a causal prefill or a one-token step; flash
on the card, never cuDNN's: ``SDPA_BACKENDS``), except under an active
attention dropout, which keeps the explicit softmax and the port's
:class:`Dropout`.

Decoding: :meth:`JambaLM.prefill` runs the prompt as one parallel
forward and returns the last position's logits with the caches
:meth:`JambaLM.step` continues from: a Mamba layer's ``(h, conv
window)`` (``MambaBlock.prefill``), an attention layer's
:class:`KVCache`, preallocated for the prompt and the tokens to come and
written in place.  :func:`generate` is the two together; on the card in
bf16 its greedy steps replay a CUDA graph (:class:`_GreedyGraph`), one
per model, over attention caches of a power-of-two capacity.
``init_cache`` gives empty caches of the same kinds (the Mamba ones zero
and f32, as JAX's).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from gfe_mamba_torch.models.attention import _heads, _merge
from gfe_mamba_torch.models.dropout import Dropout
from gfe_mamba_torch.models.mamba import MambaBlock, MambaConfig, RMSNorm
from gfe_mamba_torch.models.promote import Linear, promote
from gfe_mamba_torch.parallel.collectives import (copy_to_model,
                                                  reduce_from_model)
from gfe_mamba_torch.utils.profiling import annotate


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


# every SDPA backend but cuDNN's, which builds a plan for each new shape:
# a decode step's key length grows by one, and the first request of each
# prompt length took 3.1-7.1 s against 0.41-0.52 s with flash (H100)
SDPA_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                 SDPBackend.MATH]


class KVCache:
    """An attention layer's keys and values along the sequence, written
    in place: ``k`` and ``v`` ``(B, n_kv, capacity, head_dim)``, of which
    the first ``length`` positions are filled.  The buffers are made at
    the first :meth:`append`, in its keys' dtype and device.

    After :meth:`freeze` the length lives on the device (``pos``, with
    ``valid`` the mask of filled positions), so that a one-token step can
    be recorded in a CUDA graph and replayed: nothing on the host changes
    from one replay to the next, and ``length`` stays as it was."""

    def __init__(self, capacity: int):
        self.capacity, self.length = capacity, 0
        self.k = self.v = None
        self.pos = self.valid = None

    def freeze(self) -> None:
        self.pos = torch.full((1,), self.length, dtype=torch.long,
                              device=self.k.device)
        self.valid = torch.arange(self.capacity,
                                  device=self.k.device) < self.length

    def append(self, k: torch.Tensor, v: torch.Tensor):
        """Write ``k, v (B, n_kv, n, head_dim)`` after the filled positions;
        returns the keys and values filled so far (views), or, frozen, one
        token's written at ``pos`` and the whole buffers."""
        if self.pos is not None:
            self.k.index_copy_(2, self.pos, k)
            self.v.index_copy_(2, self.pos, v)
            self.valid.index_fill_(0, self.pos, True)
            self.pos += 1
            return self.k, self.v
        end = self.length + k.shape[2]
        if end > self.capacity:
            raise ValueError(f"KVCache holds {self.capacity} positions, "
                             f"{end} asked")
        if self.k is None:
            # zeros, not empty: a frozen step reads the whole buffers, and
            # a masked NaN would still spoil the attention's sums
            shape = (*k.shape[:2], self.capacity, k.shape[3])
            self.k = k.new_zeros(shape)
            self.v = v.new_zeros(shape)
        self.k[:, :, self.length:end] = k
        self.v[:, :, self.length:end] = v
        self.length = end
        return self.k[:, :, :end], self.v[:, :, :end]


class GQAttention(nn.Module):
    """Grouped-query attention, bias-free projections.  Without a cache
    it is causal over the sequence; with a :class:`KVCache` the new keys
    and values are written after the cached ones and each new position
    attends to every cached one and the new ones up to itself."""

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

    def forward(self, x: torch.Tensor, cache: KVCache | None = None):
        with annotate("gfe.attention"):
            q = _heads(self.q_proj(x), self.n_heads)
            k = _heads(self.k_proj(x), self.n_kv)
            v = _heads(self.v_proj(x), self.n_kv)
            past = 0
            if cache is not None:
                past = cache.length
                k, v = cache.append(k, v)
            q, k, v = promote(q, k, v)
            n, m = q.shape[2], k.shape[2]
            mask = None
            if past and n > 1:
                mask = torch.ones(n, m, dtype=torch.bool,
                                  device=x.device).tril(past)
            if cache is not None and cache.pos is not None:
                out = self._attend_frozen(q, k, v, cache.valid)
            elif self.training and self.attn_drop.p > 0:
                out = self._attend_dropout(q, k, v, past == 0, mask)
            else:
                with sdpa_kernel(SDPA_BACKENDS):
                    out = F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask,
                        is_causal=past == 0 and n > 1, enable_gqa=True)
            return self.o_proj(_merge(out)), cache

    def _attend_frozen(self, q, k, v, valid):
        """One token over a frozen cache's whole buffers, its filled
        positions ``valid``: the query heads of each key/value head taken
        as that head's rows, so that one mask serves them all."""
        b, _, n, d = q.shape
        if n != 1:
            raise ValueError("a frozen KVCache takes one token a step")
        rows = q.reshape(b, self.n_kv, self.n_heads // self.n_kv, d)
        with sdpa_kernel(SDPA_BACKENDS):
            out = F.scaled_dot_product_attention(
                rows, k, v, attn_mask=valid[None, None, None, :])
        return out.reshape(b, self.n_heads, 1, d)

    def _attend_dropout(self, q, k, v, causal, mask):
        """The explicit softmax, with the port's dropout on its weights."""
        groups = self.n_heads // self.n_kv
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
        logits = torch.einsum("bhid,bhjd->bhij", q, k) \
            / math.sqrt(self.head_dim)
        if causal:
            li, lj = logits.shape[-2:]
            mask = torch.ones(li, lj, dtype=torch.bool,
                              device=q.device).tril(lj - li)
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        attn = self.attn_drop(torch.softmax(logits, dim=-1))
        return torch.einsum("bhij,bhjd->bhid", attn, v)


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
    """Top-k routed SwiGLU experts, routed dispatch (module docstring).
    Returns the output and the router logits ``(B*L, E)``; with one
    expert, a plain :class:`MLP` (``expert``) and ones ``(B*L, 1)``.

    The (token, slot) pairs are sorted by expert.  On the card in bf16
    (:func:`grouped_experts`) each weight's products run as one grouped
    product over the sorted pairs, the groups' ends cumulated on the
    device: no synchronisation, and each expert's weights read once, in
    place, so that a decode step can be recorded in a CUDA graph.
    Elsewhere (the CPU, float32, an expert-parallel slice) each expert's
    three products run over its slice of the sorted pairs, an expert no
    pair chose skipped, and the slices' ends reach the host once per call
    (one synchronisation).  The gated outputs are added back per token in
    f32 and rounded once to the activations' dtype.

    Expert parallel (``parallel/sharding.py`` sets ``ep_group`` and
    ``ep_index`` and leaves this rank's slice of the experts): the router
    runs whole on every rank, each rank computes the pairs routed to its
    own experts, and the partial outputs are all-reduced over the model
    group.  ``routed``, when set to an int64 tensor ``(E,)``, counts on
    its device the pairs routed to each expert; ``layer`` names the
    layer in the ``gfe.moe`` span."""

    ep_group = None
    ep_index = 0
    routed = None
    layer = -1

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
        bsz, seq, d = x.shape
        if self.num_experts == 1:
            return self.expert(x), torch.ones(bsz * seq, 1, dtype=x.dtype,
                                              device=x.device)
        with annotate("gfe.moe", str(self.layer)):
            router_logits = self.router(x).reshape(bsz * seq,
                                                   self.num_experts)
            weights = torch.softmax(router_logits.float(), dim=-1)
            top_w, top_i = weights.topk(self.k, dim=-1)
            gates = top_w.to(x.dtype)
            x = x.reshape(bsz * seq, d)
            local, first = self.num_experts, 0
            if self.ep_group is not None:
                local = self.experts_gate.shape[0]
                first = self.ep_index * local
                x = copy_to_model(x, self.ep_group)
                gates = copy_to_model(gates, self.ep_group)
            with annotate("gfe.moe.experts"):
                out = self._dispatch(x, top_i, gates, first, local).to(
                    torch.promote_types(x.dtype, self.experts_down.dtype))
            out = reduce_from_model(out, self.ep_group)
            return out.reshape(bsz, seq, d), router_logits

    def _dispatch(self, x, top_i, gates, first: int, local: int):
        """Experts ``first .. first + local - 1`` (this module's
        ``0 .. local - 1``) on the pairs routed to them; ``x (T, D)``,
        ``top_i`` and ``gates (T, k)``; the sum in f32."""
        chosen = top_i.reshape(-1)
        counts = torch.zeros(self.num_experts, dtype=torch.long,
                             device=x.device).index_add_(
            0, chosen, torch.ones_like(chosen))
        if self.routed is not None:
            self.routed += counts
        order = torch.argsort(chosen, stable=True)
        if local == self.num_experts and grouped_experts(x,
                                                         self.experts_gate):
            return self._grouped(x, order, counts, gates)
        return self._looped(x, order, counts, gates, first, local)

    def _grouped(self, x, order, counts, gates):
        """Every expert's products at once, one grouped product per
        weight over the pairs sorted by expert, the groups' ends summed
        on the device."""
        ends = counts.cumsum(0).to(torch.int32)
        token = order // self.k
        xs = x[token]
        h = F.silu(torch._grouped_mm(xs, self.experts_gate, offs=ends)) \
            * torch._grouped_mm(xs, self.experts_up, offs=ends)
        y = torch._grouped_mm(h, self.experts_down, offs=ends).float()
        w = gates.reshape(-1)[order].float()
        return torch.zeros(x.shape, dtype=torch.float32,
                           device=x.device).index_add_(0, token,
                                                       y * w[:, None])

    def _looped(self, x, order, counts, gates, first: int, local: int):
        """One product per expert and weight over the expert's slice of
        the pairs sorted by expert; an expert no pair chose is skipped.
        The slices' ends reach the host."""
        token = order // self.k
        ends = [0] + counts.cumsum(0).tolist()
        lo, hi = ends[first], ends[first + local]
        xs = x[token[lo:hi]]
        ys = []
        for e in range(local):
            a, b = ends[first + e] - lo, ends[first + e + 1] - lo
            if a == b:
                continue
            xe = xs[a:b]
            h = F.silu(torch.matmul(*promote(xe, self.experts_gate[e]))) \
                * torch.matmul(*promote(xe, self.experts_up[e]))
            ys.append(torch.matmul(*promote(h, self.experts_down[e])))
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        if ys:
            w = gates.reshape(-1)[order[lo:hi]].float()
            out.index_add_(0, token[lo:hi], torch.cat(ys).float() * w[:, None])
        return out


def grouped_experts(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether ``torch._grouped_mm`` runs the products of ``x`` and the
    stacked expert ``weight`` on the card's own grouped kernel, which takes
    the groups' ends from the device: both bf16, on a card of compute
    capability 9.0 or more.  (Elsewhere it falls back to a loop that reads
    the ends on the host.)"""
    return (x.is_cuda and x.dtype == weight.dtype == torch.bfloat16
            and hasattr(torch, "_grouped_mm")
            and torch.cuda.get_device_capability(x.device) >= (9, 0))


class JambaLayer(nn.Module):
    """RMSNorm -> attention or Mamba -> + residual; RMSNorm -> MoE (or
    MLP) -> + residual."""

    def __init__(self, config: JambaConfig, is_attn: bool,
                 num_experts: int, index: int = -1):
        super().__init__()
        self.is_attn = is_attn
        if is_attn:
            self.self_attn = GQAttention(config)
        else:
            self.mamba = MambaBlock(config.mamba_config)
        k = config.num_experts_per_tok if num_experts > 1 else 1
        self.moe = SparseMoEBlock(config.d_model, num_experts, k,
                                  config.mlp_size)
        self.moe.layer = index
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

    def prefill(self, x: torch.Tensor, max_len: int):
        """The forward of ``x (B, L, D)`` and the cache :meth:`step`
        continues from (an attention layer's holds ``max_len``
        positions)."""
        h = self.input_layernorm(x)
        if self.is_attn:
            h, cache = self.self_attn(h, KVCache(max_len))
        else:
            h, cache = self.mamba.prefill(h)
        return self._moe(x + h)[0], cache


class Jamba(nn.Module):
    """The layer stack; returns ``(x, router logits of every layer)``."""

    def __init__(self, config: JambaConfig):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(
            JambaLayer(config, config.is_attn_layer(i),
                       config.num_experts if config.is_expert_layer(i)
                       else 1, i)
            for i in range(config.n_layers))

    def forward(self, x: torch.Tensor):
        router_logits = []
        for layer in self.layers:
            x, logits = layer(x)
            router_logits.append(logits)
        return x, router_logits

    def step(self, x: torch.Tensor, caches: list):
        """``x (B, 1, D)``, one token, through the caches of
        :meth:`prefill` or :meth:`init_cache`."""
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.step(x, cache)
            new_caches.append(cache)
        return x, new_caches

    def prefill(self, x: torch.Tensor, max_len: int):
        """The forward of ``x (B, L, D)`` -> ``(x, caches)``: each layer's
        cache as :meth:`step` continues from it, the attention layers'
        holding ``max_len`` positions."""
        caches = []
        for layer in self.layers:
            x, cache = layer.prefill(x, max_len)
            caches.append(cache)
        return x, caches

    def init_cache(self, batch: int, dtype=torch.float32, device=None, *,
                   max_len: int) -> list:
        """Zero Mamba caches and empty attention caches of ``max_len``
        positions, on ``device`` (the model's when omitted)."""
        cfg, mc = self.config, self.config.mamba_config
        device = device or self.layers[0].input_layernorm.weight.device
        return [KVCache(max_len) if cfg.is_attn_layer(i) else
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
        with annotate("gfe.decode"):
            x, caches = self.jamba.step(self.embedding(token)[:, None],
                                        caches)
            return self._logits(self.final_layernorm(x))[:, 0], caches

    def prefill(self, tokens: torch.Tensor, max_new: int):
        """The prompt ``tokens (B, P)`` as one parallel forward ->
        ``(logits (B, vocab) of its last position, caches)``, the caches
        holding room for ``max_new`` more tokens (``num_logits_to_keep``
        1: the head runs on the last position only)."""
        with annotate("gfe.prefill"):
            x, caches = self.jamba.prefill(self.embedding(tokens),
                                           tokens.shape[1] + max_new)
            return self._logits(self.final_layernorm(x[:, -1:]))[:, 0], \
                caches

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
             generator: torch.Generator | None = None, *,
             temperature: float = 1.0, top_k: int | None = None,
             return_logits: bool = False):
    """Autoregressive sampling: :meth:`JambaLM.prefill` runs the prompt
    ``(B, P)`` at once, then each of ``num_tokens`` tokens is drawn from
    softmax(logits / temperature), restricted to the ``top_k`` largest
    when given, with ``generator``, and stepped through the caches.
    ``top_k=1`` is greedy: the argmax, with no draw; where a step never
    waits for the host (the card, every MoE grouped: :func:`_capturable`)
    its steps replay a CUDA graph (:class:`_GreedyGraph`).  Returns ``(B,
    P + num_tokens)``; with ``return_logits`` also the logits each token
    was chosen from, ``(B, num_tokens, vocab)``."""
    logits, caches = model.prefill(prompt, num_tokens)
    if top_k == 1 and num_tokens > 2 and _capturable(model, logits):
        picked, seen = _greedy_graph(model, logits, caches, num_tokens)
        out = torch.cat([prompt, picked], dim=1)
        return (out, seen) if return_logits else out
    tokens, seen = [prompt], []
    for i in range(num_tokens):
        seen.append(logits)
        if top_k == 1:
            current = logits.argmax(dim=-1)
        else:
            scaled = logits.float() / max(temperature, 1e-6)
            if top_k is not None:
                kth = scaled.topk(top_k, dim=-1).values[:, -1:]
                scaled = scaled.masked_fill(scaled < kth, float("-inf"))
            current = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                        generator=generator)[:, 0]
        tokens.append(current[:, None])
        if i + 1 < num_tokens:
            logits, caches = model.step(current, caches)
    out = torch.cat(tokens, dim=1)
    return (out, torch.stack(seen, dim=1)) if return_logits else out


def _capturable(model: JambaLM, logits: torch.Tensor) -> bool:
    """Whether a step of ``model`` runs on the card without waiting for
    the host: every routed MoE layer takes the grouped product on the
    step's activations (of ``logits``' dtype)."""
    return logits.is_cuda and all(
        m.num_experts == 1 or (m.ep_group is None
                               and grouped_experts(logits, m.experts_gate))
        for m in model.modules() if isinstance(m, SparseMoEBlock))


def _greedy_graph(model: JambaLM, logits: torch.Tensor, caches: list,
                  num_tokens: int):
    """Greedy decoding from the prefill's ``logits`` and ``caches`` on the
    card -> ``(tokens (B, num_tokens), logits (B, num_tokens, vocab))``,
    through the model's one :class:`_GreedyGraph`, recorded again only
    when the batch or the number of tokens changes, or the attention
    caches outgrow it (then at the next power of two)."""
    need = max((c.capacity for c in caches if isinstance(c, KVCache)),
               default=1)
    graph = model.__dict__.get("_greedy_graph")
    if graph is None or not graph.takes(logits, num_tokens, need):
        # the old graph's memory goes before the new one is recorded
        graph = model.__dict__["_greedy_graph"] = None
        graph = model.__dict__["_greedy_graph"] = _GreedyGraph(
            model, logits, caches, num_tokens, 1 << (need - 1).bit_length())
    return graph.run(logits, caches)


class _GreedyGraph:
    """Greedy decoding on the card for a batch, a number of tokens and
    attention caches of up to ``capacity`` positions.

    One step is a few hundred launches of small kernels, more host time
    than device time.  So the step is recorded once in a CUDA graph over
    caches of its own (the attention caches at ``capacity`` positions and
    frozen: :meth:`KVCache.freeze`, the whole buffers attended under the
    mask of filled positions), after one run that warms up its kernels,
    and a request loads its prefill's caches into them and replays the
    graph once a token.  Each replay reads its token from, and writes its
    logits, its argmax and the Mamba layers' new caches into, tensors the
    graph holds; nothing waits for the host."""

    def __init__(self, model, logits, caches, num_tokens: int,
                 capacity: int):
        self.n, self.capacity = num_tokens, capacity
        self.caches = []
        for c in caches:
            if isinstance(c, KVCache):
                mine = KVCache(capacity)
                shape = (*c.k.shape[:2], capacity, c.k.shape[3])
                # zeros, not empty: masked positions still enter the sums
                mine.k, mine.v = c.k.new_zeros(shape), c.v.new_zeros(shape)
                mine.freeze()
                self.caches.append(mine)
            else:
                self.caches.append((torch.empty_like(c[0]),
                                    torch.empty_like(c[1])))
        self.seen = logits.new_empty(num_tokens, *logits.shape)
        self.picked = torch.empty(num_tokens, logits.shape[0],
                                  dtype=torch.long, device=logits.device)
        self.token = torch.empty_like(self.picked[0])
        self.index = torch.ones(1, dtype=torch.long, device=logits.device)

        def step():
            out, new = model.step(self.token, self.caches)
            for c, n in zip(self.caches, new):
                if isinstance(c, tuple):
                    c[0].copy_(n[0])
                    c[1].copy_(n[1])
            self.seen.index_copy_(0, self.index, out[None])
            self.token.copy_(out.argmax(dim=-1))
            self.picked.index_copy_(0, self.index, self.token[None])
            self.index.add_(1)

        self.load(logits, caches)
        step()
        self.load(logits, caches)
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(device=logits.device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.graph.capture_begin()
            step()
            self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)

    def takes(self, logits, num_tokens: int, capacity: int) -> bool:
        return (self.n == num_tokens and capacity <= self.capacity
                and self.picked.shape[1] == logits.shape[0]
                and self.seen.dtype == logits.dtype)

    def load(self, logits, caches) -> None:
        """A request's prefill into the graph's tensors: its keys and
        values at the head of the attention buffers (what lies past them,
        finite and masked, stays)."""
        for mine, c in zip(self.caches, caches):
            if isinstance(mine, KVCache):
                mine.k[:, :, :c.length].copy_(c.k[:, :, :c.length])
                mine.v[:, :, :c.length].copy_(c.v[:, :, :c.length])
                mine.pos.fill_(c.length)
                torch.lt(torch.arange(self.capacity, device=c.k.device),
                         c.length, out=mine.valid)
            else:
                mine[0].copy_(c[0])
                mine[1].copy_(c[1])
        self.seen[0] = logits
        self.picked[0] = logits.argmax(dim=-1)
        self.token.copy_(self.picked[0])
        self.index.fill_(1)

    def run(self, logits, caches):
        self.load(logits, caches)
        for _ in range(self.n - 1):
            with annotate("gfe.decode"):
                self.graph.replay()
        return self.picked.T.clone(), self.seen.transpose(0, 1).clone()
