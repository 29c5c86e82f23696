"""Hugging Face checkpoint conversion — the counterpart of ``accelerate_tpu/models/convert.py``.

Two halves, with the JAX package's names and behaviour:

- **configs** (``*_config_from_hf``): a Hugging Face ``config.json`` (a
  ``transformers`` config object or a plain dict) onto the port's configs:
  the Llama recipe (also Mistral's), Gemma, Gemma-2 (alternating local and
  global layers, softcaps, ``query_pre_attn_scalar``, sandwich norms),
  Qwen2, Qwen3 and Phi-3 onto :class:`LlamaConfig`; Mixtral onto
  :class:`MoELlamaConfig`; BERT onto :class:`BertConfig`; GPT-2 onto
  :class:`GPT2Config`; GPT-NeoX, GPT-J and OPT onto :class:`GPTXConfig`.
  Features the models do not implement raise instead of converting
  silently.
- **state dicts** (``*_params_from_hf``): a Hugging Face state dict (torch
  tensors, numpy arrays, or the memory maps of safetensors files) onto the
  port's stacked-layer parameter tree, on ``device`` (the card unless the
  caller asks for the CPU) in ``dtype``. ``nn.Linear`` weights are
  transposed to ``(in, out)``; GPT-2's ``Conv1D`` weights already are;
  per-layer tensors are stacked on a leading ``L`` dim, written layer by
  layer into one tensor on the device; NeoX's per-head interleaved fused
  QKV becomes ``[q | k | v]``; Phi-3's fused ``qkv_proj`` and
  ``gate_up_proj`` are split; Gemma's ``(1 + weight)`` norms get their 1
  folded in. Each value goes through f32 on its way to ``dtype`` as the
  JAX converter's ``_to_numpy`` does, so every leaf equals the JAX
  package's bit for bit. A BERT checkpoint without a pooler or classifier
  gets fresh ones drawn as the JAX converter draws them (numpy's
  ``default_rng(0)``, std 0.02, zero bias).

``from_hf(hf_model)`` converts a live model (any object with ``.config``
and ``.state_dict()``); ``from_hf_checkpoint(model_type, path, config)``
reads safetensors files (a file, a folder or an index) through memory maps
without ``transformers``. T5, Whisper and ViT, whose models the port does
not have, raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from .bert import BertConfig, BertForSequenceClassification
from .gpt2 import GPT2, GPT2Config
from .gptx import GPTX, GPTXConfig
from .llama import SUPPORTED_ROPE_TYPES, Llama, LlamaConfig
from .moe import MoELlama, MoELlamaConfig

# Rope types a config may name: the five both packages' models compute.
CONFIG_ROPE_TYPES = SUPPORTED_ROPE_TYPES


def _getter(hf_config):
    """Uniform field access for transformers config objects and plain dicts."""
    if isinstance(hf_config, dict):
        return lambda k, d=None: hf_config.get(k, d)
    return lambda k, d=None: getattr(hf_config, k, d)


# The JAX package's families whose models the port does not have yet.
UNPORTED_MODEL_TYPES = ("t5", "whisper", "vit")


def _get_family(model_type):
    """``(model class, config converter, state-dict converter)`` of a
    ``model_type``."""
    if model_type in UNPORTED_MODEL_TYPES:
        raise NotImplementedError(
            f"model_type={model_type!r}: the port has no {model_type} model yet (ROADMAP.md, "
            "Queue 1 item 8: T5, Whisper and ViT)")
    if model_type not in _FAMILIES:
        raise ValueError(
            f"No converter for model_type={model_type!r}; supported: {sorted(_FAMILIES)}"
        )
    return _FAMILIES[model_type]


def _get_converter(model_type):
    """The config converter of a ``model_type``."""
    return _get_family(model_type)[1]


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




# ---------------------------------------------------------------------- phi3
def phi3_config_from_hf(hf_config) -> LlamaConfig:
    """Phi-3 = the Llama recipe with fused ``qkv_proj`` and ``gate_up_proj``
    (split at conversion). Partial rotary (Phi-4-mini ships as ``phi3``)
    raises: the Llama model rotates the full head."""
    get = _getter(hf_config)
    prf = get("partial_rotary_factor", 1.0) or 1.0
    if prf != 1.0:
        raise ValueError(
            f"partial_rotary_factor={prf} is not supported for phi3-type "
            "checkpoints (the zoo Llama applies full-width rotary)")
    return llama_config_from_hf(hf_config)


# ---------------------------------------------------------------------- gpt2
def gpt2_config_from_hf(hf_config) -> GPT2Config:
    """GPT-2: tanh-gelu, uniform ``1/sqrt(head_dim)`` attention scaling."""
    get = _getter(hf_config)
    act = get("activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(f"activation_function={act!r} is not supported (zoo GPT-2 uses tanh-gelu)")
    if get("scale_attn_weights") is False:
        raise ValueError("scale_attn_weights=False checkpoints are not supported "
                         "(zoo GPT-2 always scales by 1/sqrt(head_dim))")
    if get("scale_attn_by_inverse_layer_idx") or get("reorder_and_upcast_attn"):
        raise ValueError(
            "scale_attn_by_inverse_layer_idx / reorder_and_upcast_attn checkpoints "
            "are not supported (zoo GPT-2 uses uniform 1/sqrt(head_dim) scaling)")
    n_embd = get("n_embd") or get("hidden_size")
    return GPT2Config(
        vocab_size=get("vocab_size"),
        hidden_size=n_embd,
        intermediate_size=get("n_inner") or 4 * n_embd,
        num_hidden_layers=get("n_layer") or get("num_hidden_layers"),
        num_attention_heads=get("n_head") or get("num_attention_heads"),
        max_position_embeddings=get("n_positions") or get("max_position_embeddings", 1024),
        layer_norm_eps=get("layer_norm_epsilon", 1e-5),
    )


# --------------------------------------------------------------- classic GPTs
def _map_act(act: str) -> str:
    """Hugging Face activation names onto the classic-GPT model's three."""
    if act in ("gelu", "gelu_python"):
        return "gelu"
    if act in ("gelu_new", "gelu_fast", "gelu_pytorch_tanh"):
        return "gelu_tanh"
    if act == "relu":
        return "relu"
    raise ValueError(f"activation {act!r} is not supported by the classic-GPT zoo model")


def gpt_neox_config_from_hf(hf_config) -> GPTXConfig:
    """GPT-NeoX (GPT-NeoX-20B, Pythia): partial half-split rotary
    (``rotary_pct``), parallel residual with two norms (sequential with
    ``use_parallel_residual=False``), the fused per-head interleaved QKV.
    Rope types other than linear, llama3 and yarn raise."""
    get = _getter(hf_config)
    head_dim = get("hidden_size") // get("num_attention_heads")
    rotary_dim = int(head_dim * get("rotary_pct", 0.25))
    if rotary_dim % 2:
        raise ValueError(f"rotary_pct yields odd rotary_dim {rotary_dim} at head_dim {head_dim}")
    rope_scaling = get("rope_scaling")
    if rope_scaling:
        rope_scaling = dict(rope_scaling)
        rope_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
        if rope_type not in ("linear", "llama3", "yarn", "default"):
            raise ValueError(
                f"rope_type={rope_type!r} is not supported for GPT-NeoX checkpoints "
                "(supported: linear, llama3, yarn)")
    return GPTXConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        max_position_embeddings=get("max_position_embeddings", 2048),
        layer_norm_eps=get("layer_norm_eps", 1e-5),
        position_style="rotary_neox",
        rotary_dim=rotary_dim,
        rope_theta=get("rotary_emb_base", get("rope_theta", 10000.0)),
        rope_scaling=rope_scaling,
        parallel_residual=bool(get("use_parallel_residual", True)),
        hidden_act=_map_act(get("hidden_act", "gelu")),
        attention_bias=bool(get("attention_bias", True)),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
    )


def gptj_config_from_hf(hf_config) -> GPTXConfig:
    """GPT-J (GPT-J-6B): interleaved-pair rotary over ``rotary_dim`` lanes,
    parallel residual sharing one norm, bias-free attention, an untied head
    with a bias. A config without ``rotary_dim`` raises."""
    get = _getter(hf_config)
    n_embd = get("n_embd") or get("hidden_size")
    rotary_dim = get("rotary_dim")
    if rotary_dim is None:
        raise ValueError("GPT-J checkpoints without rotary_dim are not supported")
    return GPTXConfig(
        vocab_size=get("vocab_size"),
        hidden_size=n_embd,
        intermediate_size=get("n_inner") or 4 * n_embd,
        num_hidden_layers=get("n_layer") or get("num_hidden_layers"),
        num_attention_heads=get("n_head") or get("num_attention_heads"),
        max_position_embeddings=get("n_positions") or get("max_position_embeddings", 2048),
        layer_norm_eps=get("layer_norm_epsilon", 1e-5),
        position_style="rotary_gptj",
        rotary_dim=rotary_dim,
        parallel_residual=True,
        shared_layernorm=True,
        hidden_act=_map_act(get("activation_function", "gelu_new")),
        attention_bias=False,
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        lm_head_bias=True,
    )


def opt_config_from_hf(hf_config) -> GPTXConfig:
    """OPT (OPT-30B): learned positions at a +2 table offset, sequential
    pre-LN blocks, relu, a tied head. Post-LN (OPT-350M's
    ``do_layer_norm_before=False``), its factored ``project_in`` embedding,
    early snapshots without the final norm, and bias-free or affine-free
    variants raise."""
    get = _getter(hf_config)
    if not get("do_layer_norm_before", True):
        raise ValueError(
            "do_layer_norm_before=False (OPT-350M) is not supported: the zoo "
            "model is pre-LN; converting would silently misplace every norm")
    if get("_remove_final_layer_norm"):
        raise ValueError("_remove_final_layer_norm checkpoints (early OPT snapshots) are not "
                         "supported")
    h = get("hidden_size")
    proj = get("word_embed_proj_dim", h) or h
    if proj != h:
        raise ValueError(
            f"word_embed_proj_dim={proj} != hidden_size={h} (OPT-350M's factored "
            "embedding) is not supported")
    if not get("enable_bias", True):
        raise ValueError("enable_bias=False OPT variants are not supported")
    if not get("layer_norm_elementwise_affine", True):
        raise ValueError("layer_norm_elementwise_affine=False OPT variants are not supported")
    return GPTXConfig(
        vocab_size=get("vocab_size"),
        hidden_size=h,
        intermediate_size=get("ffn_dim"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        max_position_embeddings=get("max_position_embeddings", 2048),
        layer_norm_eps=1e-5,
        position_style="learned",
        position_offset=2,
        parallel_residual=False,
        hidden_act=_map_act(get("activation_function", "relu")),
        attention_bias=True,
        tie_word_embeddings=bool(get("tie_word_embeddings", True)),
    )


# ================================================================ state dicts
def _normalize_keys(state_dict, prefixes=("model.", "transformer.", "bert.")) -> dict:
    """Strip the wrapper prefix transformers adds (``model.``,
    ``transformer.``, ``bert.``; the first match wins), so bare-backbone and
    LM-head checkpoints both map. The values are not touched."""
    out = {}
    for k, v in state_dict.items():
        for prefix in prefixes:
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        out[k] = v
    return out


def _to_tensor(value, dtype, device) -> torch.Tensor:
    """A state-dict value (a torch tensor, or a numpy array, bf16 included)
    on ``device`` in ``dtype``, rounded as the JAX converter's
    ``_to_numpy(t, dtype)`` rounds (through f32): the source's floats widen
    to f32 exactly, except f64, which is rounded to f32 first."""
    from ..utils.modeling import _as_host_tensor

    t = value.detach() if isinstance(value, torch.Tensor) else _as_host_tensor(value)
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device=device, dtype=dtype)


class _Reader:
    """The normalized state dict of one conversion with its ``dtype`` and
    ``device``: ``one(key)`` a tensor (``get``: a view of it),
    ``stack(pattern, L)`` the layers' stack (``transpose``: torch
    ``(out, in)`` to ``(in, out)``)."""

    def __init__(self, sd, dtype, device):
        self.sd, self.dtype, self.device = sd, dtype, resolve_device(device)

    def __contains__(self, key):
        return key in self.sd

    def get(self, key, transpose=False):
        t = _to_tensor(self.sd[key], self.dtype, self.device)
        return t.T if transpose else t

    def one(self, key, transpose=False):
        return self.get(key, transpose).contiguous()

    def stack(self, pattern: str, L: int, transpose=False):
        return self.layers(L, lambda i: self.get(pattern.format(i=i), transpose))

    def layers(self, L: int, fn):
        """The ``(L, ...)`` stack of ``fn(i)``, written layer by layer into
        one tensor on the device (the checkpoint is never staged whole)."""
        out = None
        for i in range(L):
            m = fn(i)
            if out is None:
                out = torch.empty((L,) + tuple(m.shape), dtype=self.dtype, device=self.device)
            out[i].copy_(m)
        return out

    def ln(self, pattern: str, L: int):
        return {"scale": self.stack(pattern + ".weight", L),
                "bias": self.stack(pattern + ".bias", L)}

    def ln_one(self, name: str):
        return {"scale": self.one(name + ".weight"), "bias": self.one(name + ".bias")}


# --------------------------------------------------------------------- llama
def _llama_backbone_params(r: _Reader, config) -> dict:
    """Embedding, attention, norms and head: shared by the dense Llama and
    Mixtral converters (Mixtral swaps only the FFN). A backbone-only
    checkpoint of an untied config gets the embedding as its head."""
    L = config.num_hidden_layers
    params = {
        "embed": {"weight": r.one("embed_tokens.weight")},
        "layers": {
            "attn": {w: r.stack(f"layers.{{i}}.self_attn.{p}_proj.weight", L, transpose=True)
                     for w, p in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o"))},
            "input_norm": {"weight": r.stack("layers.{i}.input_layernorm.weight", L)},
            "post_attn_norm": {"weight": r.stack("layers.{i}.post_attention_layernorm.weight",
                                                 L)},
        },
        "final_norm": {"weight": r.one("norm.weight")},
    }
    if not config.tie_word_embeddings:
        key = "lm_head.weight" if "lm_head.weight" in r else "embed_tokens.weight"
        params["lm_head"] = {"weight": r.one(key, transpose=True)}
    return params


def llama_params_from_hf(state_dict, config: LlamaConfig, dtype=torch.float32,
                         device=None) -> dict:
    """A Llama / Mistral / Qwen2 state dict (QKV biases with
    ``attention_bias``) → the port's parameters on ``device``."""
    r = _Reader(_normalize_keys(state_dict), dtype, device)
    L = config.num_hidden_layers
    params = _llama_backbone_params(r, config)
    if config.attention_bias:
        params["layers"]["attn"].update({
            b: r.stack(f"layers.{{i}}.self_attn.{p}_proj.bias", L)
            for b, p in (("bq", "q"), ("bk", "k"), ("bv", "v"))})
    params["layers"]["mlp"] = {
        w: r.stack(f"layers.{{i}}.mlp.{p}_proj.weight", L, transpose=True)
        for w, p in (("w_gate", "gate"), ("w_up", "up"), ("w_down", "down"))}
    return params


# Qwen2's QKV biases ride the Llama converter (its config sets attention_bias).
qwen2_params_from_hf = llama_params_from_hf


def gemma_params_from_hf(state_dict, config: LlamaConfig, dtype=torch.float32,
                         device=None) -> dict:
    """Gemma: the Llama layout with the ``(1 + weight)`` norms' 1 folded in
    (added in ``dtype``, as the JAX converter adds it)."""
    params = llama_params_from_hf(state_dict, config, dtype=dtype, device=device)
    for tree in (params["layers"]["input_norm"], params["layers"]["post_attn_norm"],
                 params["final_norm"]):
        tree["weight"] = tree["weight"] + 1.0
    return params


def gemma2_params_from_hf(state_dict, config: LlamaConfig, dtype=torch.float32,
                          device=None) -> dict:
    """Gemma-2: Gemma's leaves and the two sandwich norms, 1 folded in."""
    params = gemma_params_from_hf(state_dict, config, dtype=dtype, device=device)
    r = _Reader(_normalize_keys(state_dict), dtype, device)
    L = config.num_hidden_layers
    for leaf, name in (("pre_ffw_norm", "pre_feedforward_layernorm"),
                       ("post_ffw_norm", "post_feedforward_layernorm")):
        params["layers"][leaf] = {"weight": r.stack(f"layers.{{i}}.{name}.weight", L) + 1.0}
    return params


def qwen3_params_from_hf(state_dict, config: LlamaConfig, dtype=torch.float32,
                         device=None) -> dict:
    """Qwen3: the Llama layout and the per-head QK norms."""
    params = llama_params_from_hf(state_dict, config, dtype=dtype, device=device)
    r = _Reader(_normalize_keys(state_dict), dtype, device)
    L = config.num_hidden_layers
    params["layers"]["attn"].update({
        "q_norm": r.stack("layers.{i}.self_attn.q_norm.weight", L),
        "k_norm": r.stack("layers.{i}.self_attn.k_norm.weight", L)})
    return params


def phi3_params_from_hf(state_dict, config: LlamaConfig, dtype=torch.float32,
                        device=None) -> dict:
    """Phi-3: the fused ``qkv_proj`` (rows q, k, v) and ``gate_up_proj``
    (rows gate, up) split into the Llama layout."""
    r = _Reader(_normalize_keys(state_dict), dtype, device)
    L = config.num_hidden_layers
    nq = config.num_attention_heads * config.head_dim
    nkv = config.num_key_value_heads * config.head_dim
    inter = config.intermediate_size

    def rows(key, lo, hi):
        return lambda i: r.get(key.format(i=i))[lo:hi].T

    qkv, gu = "layers.{i}.self_attn.qkv_proj.weight", "layers.{i}.mlp.gate_up_proj.weight"
    params = {
        "embed": {"weight": r.one("embed_tokens.weight")},
        "layers": {
            "attn": {"wq": r.layers(L, rows(qkv, 0, nq)),
                     "wk": r.layers(L, rows(qkv, nq, nq + nkv)),
                     "wv": r.layers(L, rows(qkv, nq + nkv, nq + 2 * nkv)),
                     "wo": r.stack("layers.{i}.self_attn.o_proj.weight", L, transpose=True)},
            "mlp": {"w_gate": r.layers(L, rows(gu, 0, inter)),
                    "w_up": r.layers(L, rows(gu, inter, 2 * inter)),
                    "w_down": r.stack("layers.{i}.mlp.down_proj.weight", L, transpose=True)},
            "input_norm": {"weight": r.stack("layers.{i}.input_layernorm.weight", L)},
            "post_attn_norm": {"weight": r.stack("layers.{i}.post_attention_layernorm.weight",
                                                 L)},
        },
        "final_norm": {"weight": r.one("norm.weight")},
    }
    if not config.tie_word_embeddings:
        key = "lm_head.weight" if "lm_head.weight" in r else "embed_tokens.weight"
        params["lm_head"] = {"weight": r.one(key, transpose=True)}
    return params


def mixtral_params_from_hf(state_dict, config: MoELlamaConfig, dtype=torch.float32,
                           device=None) -> dict:
    """Mixtral: the Llama backbone, the router ``(L, h, E)`` and the expert
    stacks ``(L, E, in, out)`` (w1 gate, w3 up, w2 down)."""
    r = _Reader(_normalize_keys(state_dict), dtype, device)
    L, E = config.num_hidden_layers, config.num_experts
    params = _llama_backbone_params(r, config)
    moe = "layers.{i}.block_sparse_moe"

    def experts(w):
        def layer(i):
            return torch.stack([r.get(f"{moe.format(i=i)}.experts.{e}.{w}.weight", True)
                                for e in range(E)])
        return r.layers(L, layer)

    params["layers"]["mlp"] = {
        "router": r.stack(moe + ".gate.weight", L, transpose=True),
        "w_gate": experts("w1"), "w_up": experts("w3"), "w_down": experts("w2")}
    return params


# ---------------------------------------------------------------------- bert
def bert_params_from_hf(state_dict, config: BertConfig, dtype=torch.float32,
                        device=None) -> dict:
    """BertForSequenceClassification's layout. A backbone-only checkpoint
    gets a fresh pooler and classifier, drawn in that order from one numpy
    ``default_rng(0)`` stream with std 0.02 and zero biases (the JAX
    converter's draw, so the leaves equal its leaves)."""
    r = _Reader(_normalize_keys(state_dict), dtype, device)
    L, h = config.num_hidden_layers, config.hidden_size
    fresh = np.random.default_rng(0)

    def head_linear(key_w, key_b, out_dim):
        if key_w in r:
            return {"w": r.one(key_w, transpose=True), "b": r.one(key_b)}
        w = fresh.normal(scale=0.02, size=(h, out_dim)).astype(np.float32)
        return {"w": _to_tensor(w, dtype, r.device),
                "b": torch.zeros((out_dim,), dtype=dtype, device=r.device)}

    layer = "encoder.layer.{i}"
    attn = {}
    for w, p in (("q", "attention.self.query"), ("k", "attention.self.key"),
                 ("v", "attention.self.value"), ("o", "attention.output.dense")):
        attn[f"w{w}"] = r.stack(f"{layer}.{p}.weight", L, transpose=True)
        attn[f"b{w}"] = r.stack(f"{layer}.{p}.bias", L)
    return {
        "embeddings": {
            "word": r.one("embeddings.word_embeddings.weight"),
            "position": r.one("embeddings.position_embeddings.weight"),
            "token_type": r.one("embeddings.token_type_embeddings.weight"),
            "norm": r.ln_one("embeddings.LayerNorm"),
        },
        "layers": {
            "attn": attn,
            "attn_norm": r.ln(f"{layer}.attention.output.LayerNorm", L),
            "mlp": {
                "w_in": r.stack(f"{layer}.intermediate.dense.weight", L, transpose=True),
                "b_in": r.stack(f"{layer}.intermediate.dense.bias", L),
                "w_out": r.stack(f"{layer}.output.dense.weight", L, transpose=True),
                "b_out": r.stack(f"{layer}.output.dense.bias", L),
            },
            "mlp_norm": r.ln(f"{layer}.output.LayerNorm", L),
        },
        "pooler": head_linear("pooler.dense.weight", "pooler.dense.bias", h),
        "classifier": head_linear("classifier.weight", "classifier.bias", config.num_labels),
    }


# ---------------------------------------------------------------------- gpt2
def gpt2_params_from_hf(state_dict, config: GPT2Config, dtype=torch.float32,
                        device=None) -> dict:
    """GPT-2: ``Conv1D`` weights are already ``(in, out)``; the head is
    ``wte``."""
    r = _Reader(_normalize_keys(state_dict), dtype, device)
    L = config.num_hidden_layers
    return {
        "embed": {"wte": r.one("wte.weight"), "wpe": r.one("wpe.weight")},
        "layers": {
            "attn": {"w_qkv": r.stack("h.{i}.attn.c_attn.weight", L),
                     "b_qkv": r.stack("h.{i}.attn.c_attn.bias", L),
                     "wo": r.stack("h.{i}.attn.c_proj.weight", L),
                     "bo": r.stack("h.{i}.attn.c_proj.bias", L)},
            "mlp": {"w_in": r.stack("h.{i}.mlp.c_fc.weight", L),
                    "b_in": r.stack("h.{i}.mlp.c_fc.bias", L),
                    "w_out": r.stack("h.{i}.mlp.c_proj.weight", L),
                    "b_out": r.stack("h.{i}.mlp.c_proj.bias", L)},
            "ln_1": r.ln("h.{i}.ln_1", L),
            "ln_2": r.ln("h.{i}.ln_2", L),
        },
        "ln_f": r.ln_one("ln_f"),
    }


# --------------------------------------------------------------- classic GPTs
def gpt_neox_params_from_hf(state_dict, config: GPTXConfig, dtype=torch.float32,
                            device=None) -> dict:
    """GPT-NeoX: ``query_key_value`` holds ``[q_h, k_h, v_h]`` rows per head;
    the weight and the bias are de-interleaved into ``[q | k | v]``."""
    r = _Reader(_normalize_keys(state_dict, prefixes=("gpt_neox.",)), dtype, device)
    L = config.num_hidden_layers
    nh, hd, h = config.num_attention_heads, config.head_dim, config.hidden_size
    qkv = "layers.{i}.attention.query_key_value"

    def w_qkv(i):  # (nh, 3, hd, h) -> (3, nh, hd, h) -> (3h, h) -> (h, 3h)
        w = r.get(qkv.format(i=i) + ".weight").reshape(nh, 3, hd, h)
        return w.transpose(0, 1).reshape(3 * nh * hd, h).T

    def b_qkv(i):
        return r.get(qkv.format(i=i) + ".bias").reshape(nh, 3, hd).transpose(0, 1).reshape(-1)

    attn = {"w_qkv": r.layers(L, w_qkv),
            "wo": r.stack("layers.{i}.attention.dense.weight", L, transpose=True)}
    if config.attention_bias:
        attn["b_qkv"] = r.layers(L, b_qkv)
        attn["bo"] = r.stack("layers.{i}.attention.dense.bias", L)
    params = {
        "embed": {"wte": r.one("embed_in.weight")},
        "layers": {
            "attn": attn,
            "mlp": {
                "w_in": r.stack("layers.{i}.mlp.dense_h_to_4h.weight", L, transpose=True),
                "b_in": r.stack("layers.{i}.mlp.dense_h_to_4h.bias", L),
                "w_out": r.stack("layers.{i}.mlp.dense_4h_to_h.weight", L, transpose=True),
                "b_out": r.stack("layers.{i}.mlp.dense_4h_to_h.bias", L),
            },
            "ln_1": r.ln("layers.{i}.input_layernorm", L),
            "ln_2": r.ln("layers.{i}.post_attention_layernorm", L),
        },
        "ln_f": r.ln_one("final_layer_norm"),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = {"weight": r.one("embed_out.weight", transpose=True)}
    return params


def gptj_params_from_hf(state_dict, config: GPTXConfig, dtype=torch.float32,
                        device=None) -> dict:
    """GPT-J: bias-free q, k, v fused into ``w_qkv``, one norm a layer, the
    head with its bias."""
    r = _Reader(_normalize_keys(state_dict), dtype, device)
    L = config.num_hidden_layers

    def w_qkv(i):
        return torch.cat([r.get(f"h.{i}.attn.{p}_proj.weight", True) for p in "qkv"], dim=1)

    params = {
        "embed": {"wte": r.one("wte.weight")},
        "layers": {
            "attn": {"w_qkv": r.layers(L, w_qkv),
                     "wo": r.stack("h.{i}.attn.out_proj.weight", L, transpose=True)},
            "mlp": {"w_in": r.stack("h.{i}.mlp.fc_in.weight", L, transpose=True),
                    "b_in": r.stack("h.{i}.mlp.fc_in.bias", L),
                    "w_out": r.stack("h.{i}.mlp.fc_out.weight", L, transpose=True),
                    "b_out": r.stack("h.{i}.mlp.fc_out.bias", L)},
            "ln_1": r.ln("h.{i}.ln_1", L),
        },
        "ln_f": r.ln_one("ln_f"),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = {"weight": r.one("lm_head.weight", transpose=True),
                             "bias": r.one("lm_head.bias")}
    return params


def opt_params_from_hf(state_dict, config: GPTXConfig, dtype=torch.float32,
                       device=None) -> dict:
    """OPT: q, k, v fused into ``w_qkv`` and ``b_qkv``; the position table
    keeps its 2 leading rows; the per-layer ``final_layer_norm`` is the
    pre-MLP norm. A tied config reads no ``lm_head.weight`` (a checkpoint may
    lack it or hold a copy of the embedding)."""
    r = _Reader(_normalize_keys(state_dict, prefixes=("model.decoder.", "decoder.", "model.")),
                dtype, device)
    L = config.num_hidden_layers
    proj = "layers.{i}.self_attn.{p}_proj"

    def w_qkv(i):
        return torch.cat([r.get(proj.format(i=i, p=p) + ".weight", True) for p in "qkv"], dim=1)

    def b_qkv(i):
        return torch.cat([r.get(proj.format(i=i, p=p) + ".bias") for p in "qkv"])

    params = {
        "embed": {"wte": r.one("embed_tokens.weight"), "wpe": r.one("embed_positions.weight")},
        "layers": {
            "attn": {"w_qkv": r.layers(L, w_qkv), "b_qkv": r.layers(L, b_qkv),
                     "wo": r.stack("layers.{i}.self_attn.out_proj.weight", L, transpose=True),
                     "bo": r.stack("layers.{i}.self_attn.out_proj.bias", L)},
            "mlp": {"w_in": r.stack("layers.{i}.fc1.weight", L, transpose=True),
                    "b_in": r.stack("layers.{i}.fc1.bias", L),
                    "w_out": r.stack("layers.{i}.fc2.weight", L, transpose=True),
                    "b_out": r.stack("layers.{i}.fc2.bias", L)},
            "ln_1": r.ln("layers.{i}.self_attn_layer_norm", L),
            "ln_2": r.ln("layers.{i}.final_layer_norm", L),
        },
        "ln_f": r.ln_one("final_layer_norm"),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = {"weight": r.one("lm_head.weight", transpose=True)}
    return params


# ----------------------------------------------------------------- dispatcher
# model_type -> (model class, config converter, state-dict converter).
# Mistral is the Llama recipe with a sliding window, which the Llama
# converter carries from the config.
_FAMILIES = {
    "llama": (Llama, llama_config_from_hf, llama_params_from_hf),
    "mistral": (Llama, llama_config_from_hf, llama_params_from_hf),
    "gemma": (Llama, gemma_config_from_hf, gemma_params_from_hf),
    "gemma2": (Llama, gemma2_config_from_hf, gemma2_params_from_hf),
    "qwen2": (Llama, qwen2_config_from_hf, qwen2_params_from_hf),
    "qwen3": (Llama, qwen3_config_from_hf, qwen3_params_from_hf),
    "phi3": (Llama, phi3_config_from_hf, phi3_params_from_hf),
    "mixtral": (MoELlama, mixtral_config_from_hf, mixtral_params_from_hf),
    "bert": (BertForSequenceClassification, bert_config_from_hf, bert_params_from_hf),
    "gpt2": (GPT2, gpt2_config_from_hf, gpt2_params_from_hf),
    # The classic-GPT trio behind the reference's BASELINE.md inference tables.
    "gpt_neox": (GPTX, gpt_neox_config_from_hf, gpt_neox_params_from_hf),
    "gptj": (GPTX, gptj_config_from_hf, gptj_params_from_hf),
    "opt": (GPTX, opt_config_from_hf, opt_params_from_hf),
}


def from_hf(hf_model, dtype=torch.float32, device=None):
    """Convert a live Hugging Face model (any object with ``.config``, whose
    ``model_type`` names the family, and ``.state_dict()``): returns
    ``(model, params)`` with ``model.params`` set, on ``device`` (the card
    unless the caller asks for the CPU)."""
    cls, config_fn, params_fn = _get_family(getattr(hf_model.config, "model_type", None))
    config = config_fn(hf_model.config)
    model = cls(config, device=device)
    model.params = params_fn(hf_model.state_dict(), config, dtype=dtype, device=model.device)
    return model, model.params


def from_hf_checkpoint(model_type: str, checkpoint: str, hf_config, dtype=torch.float32,
                       device=None):
    """Convert safetensors file(s) without ``transformers``: ``checkpoint``
    is a file, a folder or a sharded index (``utils/modeling``), read
    through memory maps; ``hf_config`` the ``config.json`` as a dict or a
    config object. Returns ``(model, params)`` as :func:`from_hf` does."""
    from ..utils.modeling import _resolve_checkpoint_files, load_state_dict

    cls, config_fn, params_fn = _get_family(model_type)
    config = config_fn(hf_config)
    model = cls(config, device=device)
    sd = {}
    for f in _resolve_checkpoint_files(checkpoint):
        sd.update(load_state_dict(f))
    model.params = params_fn(sd, config, dtype=dtype, device=model.device)
    return model, model.params


# model_type -> config converter (the config half's table).
_CONVERTERS = {k: v[1] for k, v in _FAMILIES.items()}
