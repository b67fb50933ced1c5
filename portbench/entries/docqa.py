"""Long-document question answering: greedy ``generate`` of a ``JambaLM``
at batch 1 (``JambaLM.prefill`` of the prompt, then decode steps through
the caches the prefill filled), each request ending when its answer's
tokens are on the host.

Set-up composes the model from the program's classes on the meta device,
materialises it on the card in the served dtype and fills its weights
from the seed one part at a time, each part under a stream of its own
(the embedding, each layer, the final norm with the head), so that no
draw of the whole model is ever held.  The stacked experts are drawn as
``(E * F, D)`` and ``(E * D, F)`` matrices, so that the weight law's
fan-in is an expert's input width.  The pool holds one prompt per length
of the mix, token ids uniform over the vocabulary; request ``i`` takes
prompt ``i mod 8``, and the warm-up runs the last ones, the longest
first: its greedy decoding records the CUDA graph every later request
replays, whose attention caches fit the longest prompt.

The check, once the model is released: the reference (plain float32,
``reference/jamba.py``) runs layer by layer, each layer drawn again and
every kept request passing through it on the program's own tokens (the
prompt and the answer but its last token: teacher forcing); its logits
at the prompt's last position and at each answer position are compared
with the logits the request itself chose its tokens from.  Per position
the relative L2 gap over the vocabulary; ``logits_rel_median`` is their
median, ``far_share`` the share of positions whose gap passes ``FAR``
(where the router's second expert flips on bf16 rounding, a gap runs
far above the median), ``logits_rel_max`` the widest (not compared)."""

from __future__ import annotations

import random
import statistics

import torch

from portbench.core import weights
from portbench.reference import jamba as ref
from portbench.reference.gfe_mamba import sub
from portbench.reference.precision import Rounding, reference_mode

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
EXPERTS = ("experts_gate", "experts_up", "experts_down")
FAR = 0.15


def jamba_config(cfg: dict):
    """The program's ``JambaConfig`` of a published Jamba config."""
    from gfe_mamba_torch.models.jamba import JambaConfig

    return JambaConfig(
        d_model=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        mlp_size=cfg["intermediate_size"], rms_norm_eps=cfg["rms_norm_eps"],
        d_state=cfg["mamba_d_state"], expand_factor=cfg["mamba_expand"],
        d_conv=cfg["mamba_d_conv"], dt_rank=cfg["mamba_dt_rank"],
        conv_bias=cfg["mamba_conv_bias"], bias=cfg["mamba_proj_bias"],
        inner_layernorms=True,
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"],
        num_experts=cfg["num_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        attn_layer_offset=cfg["attn_layer_offset"],
        attn_layer_period=cfg["attn_layer_period"],
        expert_layer_offset=cfg["expert_layer_offset"],
        expert_layer_period=cfg["expert_layer_period"],
        vocab_size=cfg["vocab_size"],
        tie_lm_weights=cfg["tie_word_embeddings"])


def drawn_shape(name: str, shape) -> tuple:
    """The shape a parameter is drawn in: a stacked expert weight ``(E, a,
    b)`` as ``(E * b, a)``, whose fan-in is ``a``."""
    if name.endswith(EXPERTS):
        return (shape[0] * shape[2], shape[1])
    return tuple(shape)


def parts(model) -> list:
    """``(stream tag, [(state_dict name, parameter)])`` of each part."""
    named = dict(model.named_parameters())

    def under(*prefixes):
        return [(n, p) for n, p in named.items() if n.startswith(prefixes)]

    out = [("weights.embedding", under("embedding."))]
    for i in range(len(model.jamba.layers)):
        out.append((f"weights.layer{i}", under(f"jamba.layers.{i}.")))
    out.append(("weights.head", under("final_layernorm.", "lm_head.")))
    return out


def draw_prompts(lengths, vocab: int, seed: int, device) -> list:
    g = weights.generator(seed, "inputs", device)
    return [torch.randint(0, vocab, (1, n), generator=g, device=device)
            for n in lengths]


def relative_gaps(got: list, want: list) -> list:
    """The relative L2 gap of the logits at each position of each
    request."""
    rel = []
    for a, b in zip(got, want):
        a, b = a.float().reshape(-1, a.shape[-1]), b.float().reshape(
            -1, b.shape[-1])
        rel += (torch.linalg.vector_norm(a - b, dim=-1)
                / torch.linalg.vector_norm(b, dim=-1)).tolist()
    return rel


def gaps(rel: list) -> dict:
    """The median of the positions' gaps, the share past ``FAR`` and the
    widest."""
    return {"logits_rel_median": statistics.median(rel),
            "far_share": sum(r > FAR for r in rel) / len(rel),
            "logits_rel_max": max(rel)}


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.device = seed, torch.device(device)
        self.batch = self.traffic["batch"]
        self.dtype = DTYPES[self.cfg["dtype"]]
        self.new = self.traffic["new_tokens"]
        self.kept = []
        self.rng = random.Random(weights.derive(seed, "sample"))
        self.want = None

    def setup(self) -> None:
        from gfe_mamba_torch.models.jamba import JambaLM, generate
        from gfe_mamba_torch.ops.cuda import build
        from gfe_mamba_torch.ops.cuda import selective_scan as k2

        JambaLM.prefill  # a program without a prefill stops here
        self.generate, self.k2 = generate, k2
        if self.device.type == "cuda":
            build.build()
        with torch.device("meta"):
            model = JambaLM(jamba_config(self.cfg)).to(self.dtype)
        model.to_empty(device=self.device)
        self.parts = []
        with torch.no_grad():
            for tag, params in parts(model):
                shapes = [(n, drawn_shape(n, p.shape)) for n, p in params]
                for (_, p), (_, v) in zip(params, weights.leaves(
                        shapes, self.seed, self.device, self.dtype, tag)):
                    p.copy_(v.view(p.shape))
                self.parts.append(
                    (tag, shapes, [tuple(p.shape) for _, p in params]))
        self.model = model.eval()
        self.pool = draw_prompts(self.traffic["lengths"],
                                 self.cfg["vocab_size"], self.seed,
                                 self.device)
        for i in range(self.traffic["warmup"]):
            self.item(-1 - i)
        self.moe = [m for m in model.modules()
                    if type(m).__name__ == "SparseMoEBlock"
                    and m.num_experts > 1]
        for m in self.moe:
            m.routed = torch.zeros(m.num_experts, dtype=torch.int64,
                                   device=self.device)
        self.k2_at = (k2.launches, k2.chunks)

    def layers(self) -> dict:
        return {}

    def item(self, i: int) -> bool:
        prompt = self.pool[i % len(self.pool)]
        with torch.inference_mode():
            out, logits = self.generate(self.model, prompt, self.new,
                                        top_k=1, return_logits=True)
            finite = torch.isfinite(logits).all()
            host = torch.cat([out[0, prompt.shape[1]:],
                              finite.long()[None]]).cpu()
        if i >= 0:
            self.keep(i, out, logits)
        return not bool(host[-1])

    def keep(self, i, out, logits) -> None:
        """Algorithm R: a uniform sample of ``sample`` requests."""
        k = self.traffic["sample"]
        if len(self.kept) < k:
            self.kept.append((i, out, logits))
        else:
            j = self.rng.randrange(i + 1)
            if j < k:
                self.kept[j] = (i, out, logits)

    def counters(self) -> dict:
        launches = self.k2.launches - self.k2_at[0]
        return {"sampled requests": sorted(i for i, _, _ in self.kept),
                "K2 chunks per launch": (self.k2.chunks - self.k2_at[1])
                / max(launches, 1),
                "tokens routed per expert, by MoE layer": {
                    m.layer: m.routed.tolist() for m in self.moe}}

    def release(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _redraw(self, k: int) -> dict:
        tag, shapes, param_shapes = self.parts[k]
        return {n: v.view(s).float() for (n, _), s, (_, v) in zip(
            shapes, param_shapes, weights.leaves(shapes, self.seed,
                                                 self.device, self.dtype,
                                                 tag))}

    @torch.no_grad()
    def _reference(self, q: Rounding) -> list:
        """The reference's logits of each kept request at the positions
        the request produced, layer by layer.  The requests go through as
        one batch, each padded at its end to the longest: every layer is
        causal or per token, so a pad changes no position before it."""
        reference_mode(q.name)
        seqs = [out[0, :-1] for _, out, _ in self.kept]
        longest = max(len(s) for s in seqs)
        tokens = torch.stack([torch.nn.functional.pad(s, (0, longest - len(s)))
                              for s in seqs])
        P = self._redraw(0)
        x = ref.embed(P, tokens)
        n = self.cfg["num_hidden_layers"]
        for i in range(n):
            P = sub(self._redraw(1 + i), f"jamba.layers.{i}")
            x = ref.layer(P, i, x, self.cfg, q)
            del P
        P = self._redraw(n + 1)
        return [ref.head(P, x[r:r + 1, len(s) - self.new:len(s)], self.cfg, q)
                for r, s in enumerate(seqs)]

    def check(self) -> dict:
        self.want = self._reference(Rounding("f32"))
        rel = relative_gaps([lg for _, _, lg in self.kept], self.want)
        self.explained = {"program": rel}
        return gaps(rel)

    def control(self, precision: str) -> dict:
        """The reference in ``precision`` in the program's place, judged
        against the reference in float32 on the same tokens."""
        if self.want is None:
            self.want = self._reference(Rounding("f32"))
        rel = relative_gaps(self._reference(Rounding(precision)), self.want)
        self.explained = {**getattr(self, "explained", {}), precision: rel}
        return gaps(rel)
