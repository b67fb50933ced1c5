"""Jamba's routed experts, its prefill and decoding, and the port against
the benchmark's plain reference (``portbench/reference/jamba.py``), on
the CPU in float32.

Tolerances: the routed dispatch against the dense einsum it replaces
1e-5 of max(1, max |dense|) (the same products, summed in another
order); prefill and steps against the full forward, and the port
against the reference, 1e-4 of max(1, max |want|) (the same f32
arithmetic in other orders and fusions, over 8 layers).
"""

import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from gfe_mamba_torch.models import jamba as pj
from portbench.reference import jamba as ref
from portbench.reference.precision import Rounding

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

# ai21labs/AI21-Jamba2-Mini's config.json, the keys that fix its shape
# (https://huggingface.co/ai21labs/AI21-Jamba2-Mini/blob/main/config.json)
PUBLISHED = {
    "attn_layer_offset": 4, "attn_layer_period": 8,
    "expert_layer_offset": 1, "expert_layer_period": 2,
    "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 14336,
    "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_state": 16,
    "mamba_dt_rank": 256, "mamba_expand": 2, "mamba_proj_bias": False,
    "max_position_embeddings": 262144, "model_type": "jamba",
    "num_attention_heads": 32, "num_experts": 16, "num_experts_per_tok": 2,
    "num_hidden_layers": 32, "num_key_value_heads": 8,
    "num_logits_to_keep": 1, "rms_norm_eps": 1e-06, "sliding_window": None,
    "tie_word_embeddings": False, "use_mamba_kernels": True,
    "vocab_size": 65536}

# a small JambaLM with every kind of layer: Mamba 0-3, 5-7, attention 4,
# 4-expert top-2 MoE on 1, 3, 5, 7
SMALL = dict(d_model=64, n_layers=8, mlp_size=96, vocab_size=128,
             num_attention_heads=8, num_key_value_heads=2, num_experts=4,
             num_experts_per_tok=2, dt_rank=8, rms_norm_eps=1e-6,
             inner_layernorms=True, tie_lm_weights=False)
SMALL_HF = dict(hidden_size=64, num_hidden_layers=8, num_attention_heads=8,
                num_key_value_heads=2, num_experts_per_tok=2,
                mamba_d_state=16, mamba_d_conv=4, mamba_dt_rank=8,
                rms_norm_eps=1e-6, attn_layer_offset=4, attn_layer_period=8,
                expert_layer_offset=1, expert_layer_period=2)


def _assert_close(got, want, rel):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= rel * max(1.0, want.abs().max().item()), err


@torch.no_grad()
def _fill(module, seed):
    """Normal weights at 1/sqrt(fan-in), norms near 1, Mamba's A and dt
    laws: a forward of a sane scale."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        t = torch.randn(p.shape, generator=gen)
        if name.endswith("A_log"):
            p.copy_(torch.log(torch.arange(1, p.shape[1] + 1.0)).expand(
                p.shape))
        elif name.endswith("dt_proj.bias"):
            p.copy_(torch.log(torch.expm1(torch.full(p.shape, 0.01)))
                    + 0.1 * t)
        elif p.dim() == 1:
            p.copy_(1.0 + 0.1 * t if name.endswith((".weight", ".D"))
                    else 0.1 * t)
        elif name.endswith(("experts_gate", "experts_up")):
            p.copy_(t / math.sqrt(p.shape[1]))
        elif name.endswith("experts_down"):
            p.copy_(t / math.sqrt(p.shape[1]))
        else:
            p.copy_(t / math.sqrt(math.prod(p.shape[1:])))
    return module


def _dense_moe(moe, x):
    """The dense dispatch: every token through every expert, summed with
    the hard top-k gates."""
    weights = torch.softmax(moe.router(x).float(), dim=-1)
    top_w, top_i = weights.topk(moe.k, dim=-1)
    gates = torch.zeros_like(weights).scatter(-1, top_i, top_w).to(x.dtype)
    g = torch.einsum("bld,edf->belf", x, moe.experts_gate)
    u = torch.einsum("bld,edf->belf", x, moe.experts_up)
    y = torch.einsum("belf,efd->beld", F.silu(g) * u, moe.experts_down)
    return torch.einsum("beld,ble->bld", y, gates)


@pytest.mark.parametrize("num_experts,k,seq", [(4, 2, 9), (16, 2, 33),
                                               (8, 1, 1)])
def test_routed_moe_equals_dense_dispatch(num_experts, k, seq):
    moe = _fill(pj.SparseMoEBlock(24, num_experts, k, 40), 1).eval()
    x = torch.randn(2, seq, 24, generator=torch.Generator().manual_seed(2))
    moe.routed = torch.zeros(num_experts, dtype=torch.int64)
    with torch.no_grad():
        out, logits = moe(x)
    _assert_close(out, _dense_moe(moe, x), 1e-5)
    assert logits.shape == (2 * seq, num_experts)
    assert int(moe.routed.sum()) == 2 * seq * k


@pytest.mark.parametrize("shares", [2, 4])
def test_routed_moe_expert_slices_add_up_to_the_layer(shares):
    """Expert parallelism's share of each rank: each slice's experts on
    the pairs routed to them (``_dispatch``), summed over the slices,
    give the whole layer."""
    moe = _fill(pj.SparseMoEBlock(16, 8, 2, 24), 3).eval()
    x = torch.randn(1, 21, 16, generator=torch.Generator().manual_seed(4))
    flat = x.reshape(-1, 16)
    with torch.no_grad():
        weights = torch.softmax(moe.router(flat).float(), dim=-1)
        top_w, top_i = weights.topk(2, dim=-1)
        local = 8 // shares
        total = 0
        for r in range(shares):
            part = pj.SparseMoEBlock(16, 8, 2, 24)
            for name in ("experts_gate", "experts_up", "experts_down"):
                setattr(part, name, torch.nn.Parameter(
                    getattr(moe, name)[r * local:(r + 1) * local]))
            total = total + part._dispatch(flat, top_i, top_w, r * local,
                                           local)
    _assert_close(total.reshape(x.shape), _dense_moe(moe, x), 1e-5)


@pytest.mark.parametrize("num_experts,k,seq", [(4, 2, 9), (16, 2, 33),
                                               (16, 2, 1)])
def test_grouped_experts_equal_dense_dispatch(monkeypatch, num_experts, k,
                                              seq):
    """The card's path (``SparseMoEBlock._grouped``: one grouped product
    per weight over the pairs sorted by expert, the groups' ends on the
    device) taken here through ``torch._grouped_mm``'s own fallback:
    empty groups (one token over 16 experts) included."""
    monkeypatch.setattr(pj, "grouped_experts", lambda x, w: True)
    moe = _fill(pj.SparseMoEBlock(24, num_experts, k, 40), 1).eval()
    x = torch.randn(2, seq, 24, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out, _ = moe(x)
    _assert_close(out, _dense_moe(moe, x), 1e-5)


def test_grouped_experts_are_not_taken_on_the_cpu():
    moe = pj.SparseMoEBlock(16, 4, 2, 32)
    assert not pj.grouped_experts(torch.zeros(2, 16), moe.experts_gate)
    assert not pj.grouped_experts(torch.zeros(2, 16, dtype=torch.bfloat16),
                                  moe.experts_gate.bfloat16())
    assert not pj._capturable(_small_lm(), torch.zeros(1, 128))


def _small_lm(seed=5):
    return _fill(pj.JambaLM(pj.JambaConfig(**SMALL)), seed).eval()


def test_prefill_then_steps_equal_the_full_forward():
    """The prefill's last logits and each step's, through the caches the
    prefill filled, against the full forward at every position; the
    attention cache is written in place up to its capacity."""
    model = _small_lm()
    tokens = torch.randint(0, 128, (2, 40),
                           generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        full, _ = model(tokens)
        logits, caches = model.prefill(tokens[:, :30], 10)
        got = [logits]
        for t in range(30, 39):
            logits, caches = model.step(tokens[:, t], caches)
            got.append(logits)
    _assert_close(torch.stack(got, 1), full[:, 29:39], 1e-4)
    kv = caches[4]
    assert isinstance(kv, pj.KVCache) and kv.length == 39 \
        and kv.k.shape[2] == 40
    h, window = caches[0]
    assert h.dtype == torch.float32 and window.shape == (2, 3, 128)


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_steps_through_frozen_caches_equal_the_full_forward(batch):
    """The steps a CUDA graph records: attention caches frozen after the
    prefill (length on the device, the whole buffers masked), at batches
    of fewer and more (token, expert) pairs than experts."""
    model = _small_lm()
    tokens = torch.randint(0, 128, (batch, 24),
                           generator=torch.Generator().manual_seed(10))
    moe = model.jamba.layers[1].moe
    with torch.no_grad():
        full, _ = model(tokens)
        moe.routed = torch.zeros(4, dtype=torch.int64)
        logits, caches = model.prefill(tokens[:, :16], 8)
        caches[4].freeze()
        got = [logits]
        for t in range(16, 23):
            logits, caches = model.step(tokens[:, t], caches)
            got.append(logits)
    _assert_close(torch.stack(got, 1), full[:, 15:23], 1e-4)
    assert caches[4].length == 16 and int(caches[4].pos) == 23
    assert int(caches[4].valid.sum()) == 23
    assert int(moe.routed.sum()) == 2 * batch * 23


def test_prefill_of_a_prompt_shorter_than_the_conv_window():
    model = _small_lm()
    tokens = torch.randint(0, 128, (1, 6),
                           generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        full, _ = model(tokens)
        logits, caches = model.prefill(tokens[:, :2], 4)
        got = [logits]
        for t in range(2, 6):
            logits, caches = model.step(tokens[:, t], caches)
            got.append(logits)
    _assert_close(torch.stack(got, 1), full[:, 1:6], 1e-4)


def test_small_jamba_lm_equals_the_reference():
    """The port's forward, and greedy ``generate``'s own logits (prefill
    then steps), against the plain reference on the program's tokens."""
    model = _small_lm()
    P = {k: v.detach() for k, v in model.state_dict().items()}
    tokens = torch.randint(0, 128, (2, 40),
                           generator=torch.Generator().manual_seed(8))
    q = Rounding("f32")
    with torch.no_grad():
        want = ref.forward(P, tokens, SMALL_HF, q)
        got, _ = model(tokens)
        _assert_close(got, want, 1e-4)
        out, logits = pj.generate(model, tokens[:, :32], 8, top_k=1,
                                  return_logits=True)
        want = ref.forward(P, out[:, :-1], SMALL_HF, q)[:, 31:]
    assert torch.equal(out[:, :32], tokens[:, :32])
    assert torch.equal(out[:, 32:], logits.argmax(-1))
    _assert_close(logits, want, 1e-4)


def test_generate_samples_with_a_generator():
    model = _small_lm()
    prompt = torch.randint(0, 128, (2, 5),
                           generator=torch.Generator().manual_seed(9))
    a = pj.generate(model, prompt, 4, torch.Generator().manual_seed(1),
                    top_k=5)
    b = pj.generate(model, prompt, 4, torch.Generator().manual_seed(1),
                    top_k=5)
    assert a.shape == (2, 9) and torch.equal(a, b)


def test_kv_cache_refuses_more_than_its_capacity():
    cache = pj.KVCache(3)
    cache.append(torch.zeros(1, 2, 2, 4), torch.zeros(1, 2, 2, 4))
    with pytest.raises(ValueError, match="3 positions"):
        cache.append(torch.zeros(1, 2, 2, 4), torch.zeros(1, 2, 2, 4))


def test_benchmark_config_keeps_the_published_widths():
    """Every key of the published config is in the benchmark's file with
    its value, but the one listed in ``reduced`` (the depth, one whole
    period of 8 layers kept)."""
    cfg = json.loads((ROOT / "portbench/configs/jamba2_mini.json")
                     .read_text())
    assert cfg["reduced"] == ["num_hidden_layers"]
    for key, value in PUBLISHED.items():
        if key in cfg["reduced"]:
            continue
        assert cfg[key] == value, key
    assert cfg["num_hidden_layers"] == cfg["attn_layer_period"] == 8
    assert cfg["source"].endswith("AI21-Jamba2-Mini/blob/main/config.json")
