"""``accelerate-tpu-torch estimate-memory`` — parameter, gradient and
optimizer bytes per dtype; the counterpart of
``accelerate_tpu/commands/estimate.py``.

The bytes come from the port's own models built on the ``meta`` device
under ``big_modeling.init_empty_weights`` (the JAX package's
``jax.eval_shape``): shapes only, no memory, no device. A model is named by
a zoo preset (the JAX package's Llama, BERT and classic-GPT presets
``gpt-j-6b``, ``gpt-neox-20b`` and ``opt-30b``, and ``llama-3-8b`` and
``gemma-2-9b`` at their published widths), a local Hugging Face
``config.json`` of a family the port has (Llama, Mistral, Gemma, Gemma-2,
Qwen2, Qwen3, Phi-3, Mixtral as ``MoELlama``, BERT, GPT-2, and GPT-NeoX,
GPT-J and OPT as ``GPTX``), or a Hub id whose ``config.json`` is in the
local Hugging Face cache: nothing is fetched from the network. The JAX
package's t5 presets, and configs of t5, whisper and vit, raise
``NotImplementedError``: those models are not ported yet.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..utils.modeling import calculate_maximum_sizes
from ..utils.other import convert_bytes

# name -> (family, config fields). The Llama, BERT and classic-GPT sizes are
# the JAX package's presets; llama-3-8b is LlamaConfig.llama3_8b's and
# gemma-2-9b the published google/gemma-2-9b config.json.
PRESETS = {
    "tiny": ("llama", dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, max_position_embeddings=128)),
    "llama-7b": ("llama", dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                               num_hidden_layers=32, num_attention_heads=32,
                               num_key_value_heads=32)),
    "llama-13b": ("llama", dict(vocab_size=32000, hidden_size=5120, intermediate_size=13824,
                                num_hidden_layers=40, num_attention_heads=40,
                                num_key_value_heads=40)),
    "llama-70b": ("llama", dict(vocab_size=32000, hidden_size=8192, intermediate_size=28672,
                                num_hidden_layers=80, num_attention_heads=64,
                                num_key_value_heads=8)),
    "llama-3-8b": ("llama", dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                                 num_hidden_layers=32, num_attention_heads=32,
                                 num_key_value_heads=8, rope_theta=500000.0,
                                 max_position_embeddings=8192)),
    "gemma-2-9b": ("gemma2", dict(vocab_size=256000, hidden_size=3584, intermediate_size=14336,
                                  num_hidden_layers=42, num_attention_heads=16,
                                  num_key_value_heads=8, head_dim=256,
                                  max_position_embeddings=8192, rms_norm_eps=1e-6,
                                  rope_theta=10000.0, sliding_window=4096,
                                  query_pre_attn_scalar=256, attn_logit_softcapping=50.0,
                                  final_logit_softcapping=30.0,
                                  hidden_activation="gelu_pytorch_tanh")),
    # The reference's BASELINE.md big-model-inference trio (models/gptx.py).
    "gpt-j-6b": ("gptx", dict(vocab_size=50400, hidden_size=4096, intermediate_size=16384,
                              num_hidden_layers=28, num_attention_heads=16,
                              position_style="rotary_gptj", rotary_dim=64,
                              shared_layernorm=True, attention_bias=False, lm_head_bias=True)),
    "gpt-neox-20b": ("gptx", dict(vocab_size=50432, hidden_size=6144, intermediate_size=24576,
                                  num_hidden_layers=44, num_attention_heads=64,
                                  position_style="rotary_neox", rotary_dim=24)),
    "opt-30b": ("gptx", dict(vocab_size=50272, hidden_size=7168, intermediate_size=28672,
                             num_hidden_layers=48, num_attention_heads=56,
                             position_style="learned", position_offset=2,
                             parallel_residual=False, hidden_act="relu",
                             tie_word_embeddings=True)),
    "bert-base": ("bert", dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                               num_attention_heads=12, intermediate_size=3072)),
    "bert-large": ("bert", dict(vocab_size=30522, hidden_size=1024, num_hidden_layers=24,
                                num_attention_heads=16, intermediate_size=4096)),
}
# The JAX package's presets of families the port has no model for yet.
UNPORTED_PRESETS = {"t5-small": "t5", "t5-base": "t5", "t5-large": "t5"}
_UNPORTED_FAMILIES = {"t5": "item 8", "whisper": "item 8", "vit": "item 8"}
# config.json "architectures" names -> model_type (the JAX package's list).
_ARCHITECTURES = (("mixtral", "mixtral"), ("gemma2", "gemma2"), ("gemma", "gemma"),
                  ("qwen2", "qwen2"), ("mistral", "mistral"), ("llama", "llama"),
                  ("gptneox", "gpt_neox"), ("gptj", "gptj"), ("gpt2", "gpt2"), ("opt", "opt"),
                  ("qwen3", "qwen3"), ("phi3", "phi3"), ("whisper", "whisper"), ("vit", "vit"),
                  ("bert", "bert"), ("t5", "t5"))

DTYPE_BYTES = {"float32": 4, "bf16": 2, "int8": 1, "int4": 0.5}


def _unported(what: str, family: str):
    item = _UNPORTED_FAMILIES.get(family, "item 8")
    return NotImplementedError(f"estimate-memory: {what} is a {family} model, which the "
                               f"PyTorch port has not ported yet (ROADMAP.md, Queue 1 {item})")


def _model_from_hf_config(hf: dict):
    """An unbuilt model of the port from a Hugging Face config dict, through
    the config converters; a Llama-family config that its converter refuses
    for a feature the shapes do not need (an activation, a rope recipe) is
    sized from its size keys alone, as in the JAX package."""
    from ..models import Llama, LlamaConfig
    from ..models.convert import _get_family

    model_type = hf.get("model_type")
    if model_type is None:
        arch = (hf.get("architectures") or [""])[0].lower()
        model_type = next((mtype for known, mtype in _ARCHITECTURES if known in arch), None)
    if model_type in _UNPORTED_FAMILIES:
        raise _unported("this config", model_type)
    cls, config_fn, _ = _get_family(model_type)
    try:
        return cls(config_fn(hf), device="cpu")
    except (ValueError, KeyError) as exc:
        size_keys = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                     "num_attention_heads")
        if not all(k in hf for k in size_keys):
            raise
        if "num_local_experts" in hf or "num_experts" in hf:
            raise ValueError(
                "MoE config rejected by its converter and the dense-Llama size fallback would "
                "silently drop the expert FFNs (Mixtral-8x7B would read ~3.6x small) — fix "
                f"the config feature the converter flagged: {exc}") from exc
        return Llama(LlamaConfig(
            **{k: hf[k] for k in size_keys},
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            tie_word_embeddings=hf.get("tie_word_embeddings", False)), device="cpu")


def _hub_config(model_name: str) -> dict:
    """``config.json`` of a Hub id from the local Hugging Face cache
    (``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
    ``~/.cache/huggingface/hub``): the snapshot ``refs/main`` names, else
    any snapshot that has one. Nothing is fetched."""
    cache = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME", os.path.join(os.path.expanduser("~"), ".cache",
                                               "huggingface")), "hub")
    repo = os.path.join(cache, "models--" + model_name.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if os.path.isfile(ref):
        with open(ref, encoding="utf-8") as f:
            snapshots = [os.path.join(repo, "snapshots", f.read().strip())]
    else:
        snapshots = sorted(glob.glob(os.path.join(repo, "snapshots", "*")))
    for snapshot in snapshots:
        path = os.path.join(snapshot, "config.json")
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                return json.load(f)
    raise ValueError(
        f"Could not resolve {model_name!r}: not a local file, not a zoo preset "
        f"({sorted(PRESETS)}), not in the local HF cache, and the Hub is unreachable. "
        "Download the model's config.json and pass its path instead.")


def create_empty_model(model_name: str):
    """The parameter tree on ``meta`` of a preset, a local ``config.json``
    or a cached Hub id (module docstring)."""
    from ..big_modeling import init_empty_weights
    from ..models import GPTX, BertConfig, BertForSequenceClassification, GPTXConfig, Llama, \
        LlamaConfig
    from ..models.convert import gemma2_config_from_hf

    if os.path.isfile(model_name):
        with open(model_name, encoding="utf-8") as f:
            model = _model_from_hf_config(json.load(f))
    elif model_name in PRESETS:
        family, kw = PRESETS[model_name]
        if family == "llama":
            model = Llama(LlamaConfig(**kw), device="cpu")
        elif family == "gemma2":
            model = Llama(gemma2_config_from_hf(kw), device="cpu")
        elif family == "gptx":
            model = GPTX(GPTXConfig(**kw), device="cpu")
        else:
            model = BertForSequenceClassification(BertConfig(**kw), device="cpu")
    elif model_name in UNPORTED_PRESETS:
        raise _unported(f"preset {model_name!r}", UNPORTED_PRESETS[model_name])
    else:
        model = _model_from_hf_config(_hub_config(model_name))
    with init_empty_weights():
        return model.init_params()


def abstract_param_bytes(model_name: str) -> int:
    """f32 parameter bytes of a preset, config or cached Hub id: what the
    table is built on (the JAX package's ``abstract_param_bytes``)."""
    total, _ = calculate_maximum_sizes(create_empty_model(model_name))
    return int(total)


def estimate_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = "Estimate model memory per dtype (params / gradients / optimizer states)"
    if subparsers is not None:
        parser = subparsers.add_parser("estimate-memory", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch estimate-memory",
                                         description=description)
    parser.add_argument("model_name",
                        help="Zoo preset (e.g. llama-3-8b), path to a config.json, or a Hub "
                             "model id in the local Hugging Face cache")
    parser.add_argument("--dtypes", nargs="+", default=list(DTYPE_BYTES),
                        choices=list(DTYPE_BYTES), help="Dtypes to include in the table")
    if subparsers is not None:
        parser.set_defaults(func=estimate_command)
    return parser


def estimate_training_usage(total_fp32: int, dtype: str) -> int:
    """Adam training's footprint: parameters and gradients in ``dtype``, the
    f32 masters and the two moments."""
    scale = DTYPE_BYTES[dtype] / 4
    return int(total_fp32 * scale * 2 + total_fp32 * 3)


def gather_data(args):
    """``([dtype, largest block bytes, total bytes, training bytes], ...),
    (largest block bytes in f32, its name)``."""
    total_size, largest_layer = calculate_maximum_sizes(create_empty_model(args.model_name))
    rows = []
    for dtype in args.dtypes:
        scale = DTYPE_BYTES[dtype] / 4
        rows.append([dtype, int(largest_layer[0] * scale), int(total_size * scale),
                     estimate_training_usage(total_size, dtype)])
    return rows, largest_layer


def estimate_command(args) -> None:
    rows, largest_layer = gather_data(args)
    header = ["dtype", "Largest Layer", "Total Size", "Training w/ Adam"]
    widths = [max(len(header[i]), 14) for i in range(4)]
    print(f"Memory estimate for {args.model_name} (largest layer: {largest_layer[1]})")
    print("  ".join(h.ljust(w) for h, w in zip(header, widths)))
    for row in rows:
        cells = [row[0]] + [convert_bytes(v) for v in row[1:]]
        print("  ".join(str(c).ljust(w) for c, w in zip(cells, widths)))


def main() -> None:
    estimate_command(estimate_command_parser().parse_args())


if __name__ == "__main__":
    main()
