"""Operations and bytes of a Jamba model's serving work, counted from the
published config's shapes, for the ``docqa`` cells' per-layer metrics.

As in ``portbench.work``: the operations of the products, the depthwise
conv and the causal attention's two products, 2 per multiply-add; the
scan, norms, activations and softmax not counted."""

from __future__ import annotations

from dataclasses import dataclass




@dataclass(frozen=True)
class Work:
    """Operations and bytes of one call of a layer's part while serving:
    ``phase`` 'prefill' or 'decode', ``part`` what the program's spans name
    ('mamba', 'scan', 'attention', 'mlp', 'router', 'experts', 'head')."""
    phase: str
    part: str
    name: str
    flops: int
    nbytes: int

    def least_s(self, peak_flops: float, peak_bytes_per_s: float) -> float:
        return max(self.flops / peak_flops, self.nbytes / peak_bytes_per_s)


def jamba_ops(cfg: dict, prompt_len: int, new_tokens: int,
              itemsize: int = 2) -> list:
    """One greedy request of a Jamba model (the published config's keys)
    at batch 1: the prefill of ``prompt_len`` tokens, then ``new_tokens -
    1`` decode steps (the last token is not stepped).  Operations: the
    products, the depthwise conv and the causal attention's two products
    (2 per multiply-add), the MoE at its top-k experts only, the head on
    one position per call.  Bytes: each weight a call uses read once,
    each layer's input and output, K2's operands and state, the keys and
    values a step reads, at ``itemsize`` bytes (the scan's A, state and
    the float32 router aside)."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    ed, n = cfg["mamba_expand"] * d, cfg["mamba_d_state"]
    r, kc = cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, vocab = d // heads, cfg["vocab_size"]
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    b = itemsize
    out = []

    def mm(phase, part, name, m, kk, nn, weights=True):
        out.append(Work(phase, part, name, 2 * m * kk * nn,
                        b * ((kk * nn if weights else 0) + m * kk + m * nn)))

    def layers(phase, L, past):
        for i in range(cfg["num_hidden_layers"]):
            if (i - cfg["attn_layer_offset"]) % cfg["attn_layer_period"]:
                mm(phase, "mamba", f"{i}.in_proj", L, d, 2 * ed)
                out.append(Work(phase, "mamba", f"{i}.conv1d", 2 * L * kc * ed,
                                b * (2 * L * ed + kc * ed)))
                mm(phase, "mamba", f"{i}.x_proj", L, ed, r + 2 * n)
                mm(phase, "mamba", f"{i}.dt_proj", L, r, ed)
                if phase == "prefill":
                    # K2: x, delta, z in and y out; B, C; D and the bias;
                    # A in and the last state out in float32
                    out.append(Work(phase, "scan", f"{i}.scan", 0,
                                    b * (4 * L * ed + 2 * L * n + 2 * ed)
                                    + 4 * 2 * ed * n))
                mm(phase, "mamba", f"{i}.out_proj", L, ed, d)
            else:
                mm(phase, "attention", f"{i}.q_proj", L, d, d)
                mm(phase, "attention", f"{i}.k_proj", L, d, kv * hd)
                mm(phase, "attention", f"{i}.v_proj", L, d, kv * hd)
                # causal: query t attends past + t + 1 keys
                pairs = L * past + L * (L + 1) // 2
                out.append(Work(phase, "attention", f"{i}.attend",
                                2 * 2 * heads * hd * pairs,
                                b * (2 * heads * L * hd
                                     + 2 * kv * (past + L) * hd)))
                mm(phase, "attention", f"{i}.o_proj", L, d, d)
            if (i - cfg["expert_layer_offset"]) % cfg["expert_layer_period"]:
                mm(phase, "mlp", f"{i}.mlp", L, d, 3 * f)
            else:
                mm(phase, "router", f"{i}.router", L, d, e)
                used = min(e, k * L)
                out.append(Work(phase, "experts", f"{i}.experts",
                                2 * k * L * 3 * d * f,
                                b * (used * 3 * d * f + 2 * k * L * d)))
        mm(phase, "head", "lm_head", 1, d, vocab)

    layers("prefill", prompt_len, 0)
    for j in range(new_tokens - 1):
        layers("decode", 1, prompt_len + j)
    return out
