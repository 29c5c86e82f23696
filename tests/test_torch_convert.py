"""Parity of the port's Hugging Face config converters with the JAX package's.

Each dict goes through ``accelerate_tpu.models.convert.<fn>`` and the port's
``accelerate_tpu_torch.models.convert.<fn>``; the two configs must agree
field by field (``dataclasses.asdict``). The dicts are the published
``config.json`` values of the Hugging Face hub models named beside them,
written out here (nothing is downloaded); the Qwen2 one also turns its
sliding window on, so that ``max_window_layers`` splits the layers. The
error cases raise ``ValueError`` in both, with the same message where the
two packages support the same set.
"""

import dataclasses

import pytest

from accelerate_tpu.models import convert as J
from accelerate_tpu.models.llama import Llama as JLlama
from accelerate_tpu_torch import Llama, LlamaConfig
from accelerate_tpu_torch.models import convert as T

# google/gemma-2-9b, config.json
GEMMA2_9B = dict(
    model_type="gemma2", vocab_size=256000, hidden_size=3584, intermediate_size=14336,
    num_hidden_layers=42, num_attention_heads=16, num_key_value_heads=8, head_dim=256,
    max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
    sliding_window=4096, query_pre_attn_scalar=256, attn_logit_softcapping=50.0,
    final_logit_softcapping=30.0, hidden_activation="gelu_pytorch_tanh",
)
# google/gemma-2-2b, config.json
GEMMA2_2B = dict(
    model_type="gemma2", vocab_size=256000, hidden_size=2304, intermediate_size=9216,
    num_hidden_layers=26, num_attention_heads=8, num_key_value_heads=4, head_dim=256,
    max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
    sliding_window=4096, query_pre_attn_scalar=256, attn_logit_softcapping=50.0,
    final_logit_softcapping=30.0, hidden_activation="gelu_pytorch_tanh",
)
# google/gemma-7b, config.json
GEMMA_7B = dict(
    model_type="gemma", vocab_size=256000, hidden_size=3072, intermediate_size=24576,
    num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=16, head_dim=256,
    max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
    hidden_activation="gelu_pytorch_tanh",
)
# Qwen/Qwen2-7B, config.json, with use_sliding_window turned on
QWEN2_7B_WINDOWED = dict(
    model_type="qwen2", vocab_size=152064, hidden_size=3584, intermediate_size=18944,
    num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
    max_position_embeddings=131072, rms_norm_eps=1e-6, rope_theta=1000000.0,
    hidden_act="silu", use_sliding_window=True, sliding_window=131072, max_window_layers=21,
)
# Qwen/Qwen3-8B, config.json
QWEN3_8B = dict(
    model_type="qwen3", vocab_size=151936, hidden_size=4096, intermediate_size=12288,
    num_hidden_layers=36, num_attention_heads=32, num_key_value_heads=8, head_dim=128,
    max_position_embeddings=40960, rms_norm_eps=1e-6, rope_theta=1000000.0,
    hidden_act="silu", use_sliding_window=False, sliding_window=None, max_window_layers=36,
)
# mistralai/Mistral-7B-v0.1, config.json
MISTRAL_7B = dict(
    model_type="mistral", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=10000.0,
    sliding_window=4096, hidden_act="silu", tie_word_embeddings=False,
)
# meta-llama/Llama-3.1-8B, config.json
LLAMA31_8B = dict(
    model_type="llama", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=131072, rms_norm_eps=1e-5, rope_theta=500000.0,
    hidden_act="silu", rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                                         high_freq_factor=4.0,
                                         original_max_position_embeddings=8192),
)

CASES = {
    "gemma2-9b": ("gemma2_config_from_hf", GEMMA2_9B),
    "gemma2-2b": ("gemma2_config_from_hf", GEMMA2_2B),
    "gemma-7b": ("gemma_config_from_hf", GEMMA_7B),
    "qwen2-7b-windowed": ("qwen2_config_from_hf", QWEN2_7B_WINDOWED),
    "qwen2-7b": ("qwen2_config_from_hf", dict(QWEN2_7B_WINDOWED, use_sliding_window=False)),
    "qwen2-all-windowed": ("qwen2_config_from_hf",
                           dict(QWEN2_7B_WINDOWED, max_window_layers=0, sliding_window=4096)),
    "qwen3-8b": ("qwen3_config_from_hf", QWEN3_8B),
    "mistral-7b": ("llama_config_from_hf", MISTRAL_7B),
    "llama3.1-8b": ("llama_config_from_hf", LLAMA31_8B),
    "yarn-accepted": ("llama_config_from_hf",
                      dict(LLAMA31_8B, rope_scaling=dict(rope_type="yarn", factor=4.0))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_config_matches_jax_field_by_field(case):
    fn, hf = CASES[case]
    want = dataclasses.asdict(getattr(J, fn)(hf))
    got = dataclasses.asdict(getattr(T, fn)(hf))
    assert got == want


def test_dispatch_by_model_type_matches_jax():
    for model_type in ("llama", "mistral", "gemma", "gemma2", "qwen2", "qwen3"):
        j_fn, t_fn = J._get_converter(model_type)[1], T._get_converter(model_type)
        assert t_fn.__name__ == j_fn.__name__
    assert T._get_converter("mistral") is T.llama_config_from_hf
    for conv in (J._get_converter, T._get_converter):
        with pytest.raises(ValueError, match="No converter for model_type='nope'"):
            conv("nope")


def test_gemma2_9b_config_and_the_trained_cut():
    """What the port's Gemma-2 training cell builds from the published
    config: tied, sqrt(3584) embedding multiplier, sandwich norms, layer 0
    local, windows alternating, softcaps 50 and 30, scale 256 ** -0.5; cut
    to 4 layers, 1.710B parameters by both packages' formula (which counts
    two norms a layer, where the sandwich has four)."""
    cfg = T.gemma2_config_from_hf(GEMMA2_9B)
    assert cfg.tie_word_embeddings and cfg.sandwich_norms and cfg.hidden_act == "gelu_tanh"
    assert cfg.embedding_multiplier == 3584 ** 0.5
    assert cfg.layer_windows == (4096, None) * 21 and cfg.sliding_window is None
    assert (cfg.attn_logit_softcap, cfg.final_logit_softcap) == (50.0, 30.0)
    assert cfg.query_pre_attn_scalar == 256.0 and cfg.head_dim == 256
    cut = T.gemma2_config_from_hf(dict(GEMMA2_9B, num_hidden_layers=4))
    assert cut.layer_windows == (4096, None, 4096, None)
    n = Llama(cut, device="cpu").num_params()
    assert n == JLlama(J.gemma2_config_from_hf(dict(GEMMA2_9B, num_hidden_layers=4))).num_params()
    assert n == 3584 * 256000 + 4 * 198_188_032 + 3584  # 1,710,259,712
    assert isinstance(cut, LlamaConfig)


@pytest.mark.parametrize("fn,hf,match", [
    ("llama_config_from_hf", dict(LLAMA31_8B, rope_scaling=dict(rope_type="longrope")),
     "rope_type='longrope' is not supported"),
    ("llama_config_from_hf", dict(MISTRAL_7B, mlp_bias=True), "mlp_bias"),
    ("llama_config_from_hf", dict(MISTRAL_7B, hidden_act="gelu"), "hidden_act='gelu'"),
    ("qwen2_config_from_hf", dict(QWEN2_7B_WINDOWED, hidden_act="relu"), "hidden_act='relu'"),
    ("gemma_config_from_hf", dict(GEMMA_7B, hidden_activation="gelu"),
     "not supported for Gemma "),
    ("gemma2_config_from_hf", dict(GEMMA2_9B, hidden_activation="relu"),
     "not supported for Gemma-2"),
], ids=["rope-type", "mlp-bias", "llama-act", "qwen2-act", "gemma-act", "gemma2-act"])
def test_error_cases_raise_alike(fn, hf, match):
    messages = []
    for module in (J, T):
        with pytest.raises(ValueError, match=match) as err:
            getattr(module, fn)(hf)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
