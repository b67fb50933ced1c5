"""The HF-Jamba import of the port (``utils/torch_import.py::
import_jamba_hf``, ``JambaLM.from_pretrained``) against transformers'
``JambaForCausalLM`` and against the JAX package's ``import_jamba_hf``,
on the CPU in f32.

The HF model is the tiny random-init one of ``tests/test_jamba_hf_import
.py`` (2 layers, attention and a 2-expert MoE at layer 1, GQA 4 / 2
heads), built locally: nothing is downloaded.  Tolerances: the port
against HF at rtol 2e-3 / atol 2e-4, JAX's own test's (HF's mixer takes
another summation order for the scan and the conv); against JAX on the
same state dict within 1e-5 relative to max(1, max |JAX|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models.jamba import JambaConfig as JaxJambaConfig
from gfe_mamba_tpu.models.jamba import JambaLM as JaxJambaLM
from gfe_mamba_tpu.utils.torch_import import \
    import_jamba_hf as jax_import_jamba_hf
from gfe_mamba_torch.models.jamba import JambaConfig, JambaLM
from gfe_mamba_torch.utils.torch_import import (_stack_hf_experts,
                                                build_jamba_hf_mapping,
                                                import_jamba_hf)

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)

TOKENS = np.asarray([[3, 17, 42, 5, 9, 30], [1, 2, 63, 0, 8, 8]], np.int64)
SHAPE = dict(d_model=32, n_layers=2, mlp_size=64, vocab_size=64,
             num_attention_heads=4, num_key_value_heads=2, d_state=8,
             d_conv=4, expand_factor=2, num_experts=2,
             num_experts_per_tok=1, attn_layer_offset=1,
             attn_layer_period=2, expert_layer_offset=1,
             expert_layer_period=2, inner_layernorms=True)


def _hf(tie: bool = False, seed: int = 0):
    try:
        from transformers import JambaConfig as HFJambaConfig
        from transformers import JambaForCausalLM
    except ImportError:
        pytest.skip("transformers lacks Jamba")
    cfg = HFJambaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        mamba_d_state=8, mamba_d_conv=4, mamba_expand=2,
        num_experts=2, num_experts_per_tok=1,
        attn_layer_offset=1, attn_layer_period=2,
        expert_layer_offset=1, expert_layer_period=2,
        tie_word_embeddings=tie, use_mamba_kernels=False)
    torch.manual_seed(seed)
    hf = JambaForCausalLM(cfg).eval()
    # move every norm weight and bias off its init, so a misplaced one
    # shows
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if p.dim() == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    return hf


def _port_config(hf) -> JambaConfig:
    c = hf.config
    return JambaConfig(dt_rank=c.mamba_dt_rank, rms_norm_eps=c.rms_norm_eps,
                       tie_lm_weights=c.tie_word_embeddings, **SHAPE)


def _rel(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("source", ["tensors", "numpy"])
def test_import_matches_hf_and_jax(source):
    hf = _hf()
    state = hf.state_dict()
    if source == "numpy":
        state = {k: v.detach().numpy() for k, v in state.items()}
    port = import_jamba_hf(state, JambaLM(_port_config(hf))).eval()
    with torch.no_grad():
        got, _ = port(torch.from_numpy(TOKENS))
        want = hf(torch.from_numpy(TOKENS)).logits
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-4)

    cfg = JaxJambaConfig(dt_rank=hf.config.mamba_dt_rank,
                         rms_norm_eps=hf.config.rms_norm_eps,
                         tie_lm_weights=False, **SHAPE)
    jmod = JaxJambaLM(cfg)
    tokens = jnp.asarray(TOKENS, jnp.int32)
    like = jax.eval_shape(jmod.init, jax.random.key(0), tokens)
    params = jax_import_jamba_hf(
        {k: v.detach().numpy() for k, v in hf.state_dict().items()},
        like["params"])
    jax_logits, _ = jax.jit(jmod.apply)({"params": params}, tokens)
    assert _rel(got, jax_logits) <= 1e-5


def test_mapping_covers_every_key_and_stacks_experts():
    hf = _hf()
    state = hf.state_dict()
    mapping = build_jamba_hf_mapping(state)
    stacked = _stack_hf_experts(state)
    port = JambaLM(_port_config(hf))
    assert set(mapping.values()) | set(stacked) | {"lm_head.weight"} \
        == set(port.state_dict())
    gate = torch.stack(stacked["jamba.layers.1.moe.experts_gate"])
    down = torch.stack(stacked["jamba.layers.1.moe.experts_down"])
    assert gate.shape == (2, 32, 64) and down.shape == (2, 64, 32)
    torch.testing.assert_close(
        gate[1], state["model.layers.1.feed_forward.experts.1.gate_proj."
                       "weight"].T, rtol=0, atol=0)
    # the depthwise conv, A_log and the inner norms pass as they are
    for hf_key, port_key in (("mamba.conv1d.weight", "mamba.conv1d.weight"),
                             ("mamba.A_log", "mamba.A_log"),
                             ("mamba.b_layernorm.weight",
                              "mamba.B_layernorm.weight")):
        assert mapping[f"model.layers.0.{hf_key}"] == \
            f"jamba.layers.0.{port_key}"
    assert state["model.layers.0.mamba.conv1d.weight"].shape == (64, 1, 4)
    # GQA's key/value projections at num_key_value_heads
    assert state["model.layers.1.self_attn.k_proj.weight"].shape == (16, 32)


def test_import_refuses_a_foreign_or_short_checkpoint():
    hf = _hf()
    state = dict(hf.state_dict())
    with pytest.raises(KeyError, match="no place"):
        import_jamba_hf({**state, "model.extra.weight": torch.zeros(1)},
                        JambaLM(_port_config(hf)))
    # a wrong shape is refused before any tensor is copied
    port = JambaLM(_port_config(hf))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    key = "model.layers.1.feed_forward.experts.1.down_proj.weight"
    with pytest.raises(ValueError, match="experts' shapes differ"):
        import_jamba_hf({**state, key: state[key][:, :-1]}, port)
    for k, v in port.state_dict().items():
        # the unfilled model's memory may hold NaNs
        torch.testing.assert_close(v, before[k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)
    del state["model.layers.0.mamba.D"]
    with pytest.raises(KeyError, match="lacks"):
        import_jamba_hf(state, JambaLM(_port_config(hf)))


def test_from_pretrained_reads_a_saved_checkpoint(tmp_path):
    """``save_pretrained`` then ``JambaLM.from_pretrained`` of the
    directory, with tied embeddings (no ``lm_head`` in the port)."""
    hf = _hf(tie=True, seed=3)
    hf.save_pretrained(tmp_path)
    port = JambaLM.from_pretrained(str(tmp_path), device="cpu")
    assert port.config.tie_lm_weights and not hasattr(port, "lm_head")
    assert port.config == _port_config(hf)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(TOKENS))
        want = hf(torch.from_numpy(TOKENS)).logits
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-4)
    with pytest.raises(ValueError, match="local"):
        JambaLM.from_pretrained(str(tmp_path / "absent"), device="cpu")
