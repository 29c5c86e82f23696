"""Hugging Face config conversion — the config half of ``accelerate_tpu/models/convert.py``.

Maps a Hugging Face ``config.json`` (a ``transformers`` config object or a
plain dict) onto the port's :class:`LlamaConfig`, with the JAX package's
names and behaviour: the Llama recipe (also Mistral's), Gemma, Gemma-2
(alternating local and global layers, score and logit softcaps,
``query_pre_attn_scalar``, sandwich norms), Qwen2 and Qwen3; Mixtral onto
:class:`MoELlamaConfig`; and BERT onto :class:`BertConfig`. Features the model does not implement raise instead of
converting silently.

The state-dict converters (``*_params_from_hf``) are not ported yet
(ROADMAP.md, module queue); weights come across from the JAX package with
``models/from_jax.py``.
"""

from __future__ import annotations

import dataclasses

from .bert import BertConfig
from .llama import SUPPORTED_ROPE_TYPES, LlamaConfig
from .moe import MoELlamaConfig

# Rope types a config may name: the five both packages' models compute.
CONFIG_ROPE_TYPES = SUPPORTED_ROPE_TYPES


def _getter(hf_config):
    """Uniform field access for transformers config objects and plain dicts."""
    if isinstance(hf_config, dict):
        return lambda k, d=None: hf_config.get(k, d)
    return lambda k, d=None: getattr(hf_config, k, d)


def _get_converter(model_type):
    if model_type not in _CONVERTERS:
        raise ValueError(
            f"No converter for model_type={model_type!r}; supported: {sorted(_CONVERTERS)}"
        )
    return _CONVERTERS[model_type]


# --------------------------------------------------------------------- llama
def llama_config_from_hf(hf_config, check_act: bool = True) -> LlamaConfig:
    """Map a ``transformers.LlamaConfig`` (attributes or dict) onto the config.

    Raises on config features the model does not implement (unknown
    rope_type values, MLP biases, an activation other than SiLU)."""
    get = _getter(hf_config)
    rope_scaling = get("rope_scaling")
    if rope_scaling:
        rope_scaling = dict(rope_scaling)
        rope_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
        if rope_type not in CONFIG_ROPE_TYPES:
            raise ValueError(
                f"rope_type={rope_type!r} is not supported by the zoo Llama "
                f"(supported: {CONFIG_ROPE_TYPES}); converting would "
                "silently mis-position long contexts."
            )
    if get("mlp_bias"):
        raise ValueError("mlp_bias checkpoints are not supported (zoo Llama's FFN is bias-free)")
    if check_act:
        act = get("hidden_act") or "silu"
        if act != "silu":
            raise ValueError(
                f"hidden_act={act!r} is not supported for llama-type checkpoints "
                "(the zoo converts SwiGLU here; Gemma's GeGLU has its own converter)"
            )
    return LlamaConfig(
        head_dim=get("head_dim"),
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads") or get("num_attention_heads"),
        max_position_embeddings=get("max_position_embeddings", 2048),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        rope_theta=get("rope_theta", 10000.0),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        rope_scaling=rope_scaling,
        attention_bias=bool(get("attention_bias", False)),
        sliding_window=get("sliding_window"),
    )


def _gemma_activation(get, family: str):
    # Gemma's MLP reads hidden_activation (defaulting to tanh-gelu) and
    # ignores hidden_act; only the activation the model reproduces is taken.
    act = get("hidden_activation") or "gelu_pytorch_tanh"
    if act != "gelu_pytorch_tanh":
        raise ValueError(
            f"hidden_activation={act!r} is not supported for {family} (tanh-gelu only)"
        )


# --------------------------------------------------------------------- gemma
def gemma_config_from_hf(hf_config) -> LlamaConfig:
    """Gemma = the Llama skeleton with a GeGLU FFN, sqrt(hidden)-scaled
    embeddings, a decoupled head_dim and (1 + weight) RMSNorms (the offset
    belongs to the weights, so it needs no config field); always tied."""
    get = _getter(hf_config)
    _gemma_activation(get, "Gemma")
    cfg = llama_config_from_hf(hf_config, check_act=False)
    return dataclasses.replace(
        cfg,
        hidden_act="gelu_tanh",
        embedding_multiplier=float(get("hidden_size")) ** 0.5,
        tie_word_embeddings=True,
    )


# -------------------------------------------------------------------- gemma2
def gemma2_config_from_hf(hf_config) -> LlamaConfig:
    """Gemma-2 = Gemma + sandwich norms, tanh softcaps on the attention
    scores and the final logits, ``query_pre_attn_scalar`` scaling, and
    alternating local and global layers (``layer_types``; by default layer
    0 is local and the layers alternate)."""
    get = _getter(hf_config)
    _gemma_activation(get, "Gemma-2")
    cfg = llama_config_from_hf(hf_config, check_act=False)
    L = get("num_hidden_layers")
    window = get("sliding_window", 4096)
    layer_types = get("layer_types")
    if layer_types is None:  # HF default: odd-numbered (1-based) layers slide
        layer_types = [
            "sliding_attention" if (i + 1) % 2 else "full_attention" for i in range(L)
        ]
    layer_windows = tuple(window if t == "sliding_attention" else None for t in layer_types)
    return dataclasses.replace(
        cfg,
        hidden_act="gelu_tanh",
        embedding_multiplier=float(get("hidden_size")) ** 0.5,
        tie_word_embeddings=True,
        sliding_window=None,
        layer_windows=layer_windows,
        sandwich_norms=True,
        attn_logit_softcap=get("attn_logit_softcapping", 50.0),
        final_logit_softcap=get("final_logit_softcapping", 30.0),
        query_pre_attn_scalar=float(get("query_pre_attn_scalar", 256)),
    )


# --------------------------------------------------------------------- qwen
def _qwen_windows(get):
    """Qwen2/Qwen3 window rule: layer i is windowed iff use_sliding_window and
    i >= max_window_layers (the HF layer_types default). Uniform cases map
    onto sliding_window, mixed ones onto layer_windows (full, then windowed)."""
    window, layer_windows = None, None
    if get("use_sliding_window"):
        L = get("num_hidden_layers")
        mwl = get("max_window_layers", 0) or 0
        w = get("sliding_window")
        if mwl >= L or w is None:
            window = None  # no layer windowed
        elif mwl == 0:
            window = w  # every layer windowed
        else:
            layer_windows = (None,) * mwl + (w,) * (L - mwl)
    return window, layer_windows


def qwen2_config_from_hf(hf_config) -> LlamaConfig:
    """Qwen2 = the Llama recipe + QKV biases (``attention_bias=True``)."""
    get = _getter(hf_config)
    cfg = llama_config_from_hf(hf_config)
    window, layer_windows = _qwen_windows(get)
    return dataclasses.replace(
        cfg, attention_bias=True, sliding_window=window, layer_windows=layer_windows
    )


def qwen3_config_from_hf(hf_config) -> LlamaConfig:
    """Qwen3 = the Llama recipe + per-head QK RMSNorm (``qk_norm``), bias-free
    projections, decoupled head_dim."""
    get = _getter(hf_config)
    cfg = llama_config_from_hf(hf_config)
    window, layer_windows = _qwen_windows(get)
    return dataclasses.replace(
        cfg, qk_norm=True, sliding_window=window, layer_windows=layer_windows
    )


# ---------------------------------------------------------------------- bert
def bert_config_from_hf(hf_config) -> BertConfig:
    """Map a ``transformers.BertConfig`` (attributes or dict) onto the
    config: exact GELU and absolute positions only."""
    get = _getter(hf_config)
    act = get("hidden_act", "gelu")
    if act not in ("gelu", "gelu_python"):
        raise ValueError(f"hidden_act={act!r} is not supported (zoo BERT uses exact gelu)")
    pos_type = get("position_embedding_type", "absolute")
    if pos_type != "absolute":
        raise ValueError(
            f"position_embedding_type={pos_type!r} is not supported (zoo BERT uses "
            "absolute learned positions; relative distance_embedding weights would be dropped)")
    return BertConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        max_position_embeddings=get("max_position_embeddings", 512),
        type_vocab_size=get("type_vocab_size", 2),
        layer_norm_eps=get("layer_norm_eps", 1e-12),
        num_labels=get("num_labels", 2) or 2,
        hidden_dropout_prob=get("hidden_dropout_prob", 0.1),
    )


# ----------------------------------------------------------------- dispatcher
# model_type -> config converter. Mistral is the Llama recipe with a sliding
# window, which the Llama converter carries from the config.
# -------------------------------------------------------------------- mixtral
def mixtral_config_from_hf(hf_config) -> MoELlamaConfig:
    """Mixtral: Llama attention and norms with a top-k sparse MoE FFN (JAX
    ``models/convert.py:551-589``). The renormalised top-k gate equals
    Mixtral's softmax over the top-k logits, and ``capacity_factor =
    num_experts / top_k`` drops no token, so converted inference is exact.
    ``router_aux_loss_coef`` defaults to 0.001; an unsupported rope type
    raises."""
    get = _getter(hf_config)
    rope_scaling = get("rope_scaling")
    if rope_scaling:
        rope_scaling = dict(rope_scaling)
        rope_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
        if rope_type not in SUPPORTED_ROPE_TYPES:
            raise ValueError(f"rope_type={rope_type!r} is not supported by the zoo MoE Llama "
                             f"(supported: {SUPPORTED_ROPE_TYPES})")
    E = get("num_local_experts", 8)
    k = get("num_experts_per_tok", 2)
    coef = get("router_aux_loss_coef")
    return MoELlamaConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads") or get("num_attention_heads"),
        max_position_embeddings=get("max_position_embeddings", 2048),
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        rope_theta=get("rope_theta", 10000.0),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        num_experts=E,
        moe_top_k=k,
        capacity_factor=float(E) / k,
        router_aux_coef=coef if coef is not None else 0.001,
        rope_scaling=rope_scaling,
        sliding_window=get("sliding_window"),
    )


_CONVERTERS = {
    "llama": llama_config_from_hf,
    "mistral": llama_config_from_hf,
    "gemma": gemma_config_from_hf,
    "gemma2": gemma2_config_from_hf,
    "qwen2": qwen2_config_from_hf,
    "qwen3": qwen3_config_from_hf,
    "bert": bert_config_from_hf,
    "mixtral": mixtral_config_from_hf,
}
