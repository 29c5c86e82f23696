"""The port's Hugging Face state-dict converters against the JAX package's.

For each of the thirteen families the port converts, a tiny ``transformers``
model is built once per module, its parameters perturbed from a seed so no
leaf is a constant (biases and norms included: a mislaid leaf shows), and
its state dict goes through both packages' ``*_params_from_hf``. Pins:

- converted leaves: bitwise equal, leaf for leaf, in f32 and in bf16 (both
  converters round through f32 to the asked dtype);
- logits of the converted model: within ``atol=2e-4, rtol=1e-3`` of
  ``transformers``' (the JAX tests' own pin: a different summation order in
  another framework) and within ``atol=rtol=1e-4`` of the JAX package's
  converted model (f32 on the CPU in both);
- ``from_hf_checkpoint`` from sharded safetensors and a plain-dict config:
  the same leaves as ``from_hf``, bitwise;
- every refusal of the JAX converters raises in the port, and T5, Whisper
  and ViT raise ``NotImplementedError``.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import convert as J
from accelerate_tpu_torch.models import convert as T
from accelerate_tpu_torch.utils.safetensors_io import save_file

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, max_position_embeddings=64, attn_implementation="eager")
LLAMA_LIKE = dict(SMALL, num_key_value_heads=2, tie_word_embeddings=False)
GEMMA_LIKE = dict(SMALL, num_key_value_heads=2)  # Gemma always ties

# family -> (config class, model class, config kwargs); the JAX tests' shapes.
BUILDERS = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", LLAMA_LIKE),
    "mistral": ("MistralConfig", "MistralForCausalLM", dict(LLAMA_LIKE, sliding_window=8)),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", LLAMA_LIKE),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(LLAMA_LIKE, head_dim=16)),
    "phi3": ("Phi3Config", "Phi3ForCausalLM",
             dict(LLAMA_LIKE, pad_token_id=0, bos_token_id=1, eos_token_id=2)),
    "gemma": ("GemmaConfig", "GemmaForCausalLM",
              dict(GEMMA_LIKE, head_dim=32, hidden_act="gelu_pytorch_tanh")),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM",
               dict(GEMMA_LIKE, num_hidden_layers=4, head_dim=16, sliding_window=4,
                    query_pre_attn_scalar=32.0, attn_logit_softcapping=50.0,
                    final_logit_softcapping=30.0, hidden_activation="gelu_pytorch_tanh")),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(LLAMA_LIKE, intermediate_size=96, num_local_experts=4,
                     num_experts_per_tok=2, sliding_window=None)),
    "bert": ("BertConfig", "BertForSequenceClassification", dict(SMALL, num_labels=3)),
    "gpt2": ("GPT2Config", "GPT2LMHeadModel",
             dict(vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
                  attn_implementation="eager")),
    "gpt_neox": ("GPTNeoXConfig", "GPTNeoXForCausalLM", dict(SMALL, rotary_pct=0.25)),
    "gptj": ("GPTJConfig", "GPTJForCausalLM",
             dict(vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
                  rotary_dim=8, attn_implementation="eager")),
    "opt": ("OPTConfig", "OPTForCausalLM",
            dict(vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=64,
                 attn_implementation="eager")),
}
FAMILIES = list(BUILDERS)
SEED = 20


@functools.lru_cache(maxsize=None)
def hf_model(family):
    """The family's tiny model, every parameter perturbed from a seed."""
    cfg_cls, model_cls, kw = BUILDERS[family]
    cfg = getattr(transformers, cfg_cls)(**kw)
    torch.manual_seed(SEED + FAMILIES.index(family))
    model = getattr(transformers, model_cls)(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    return model


@pytest.fixture(scope="module", autouse=True)
def _built_once_per_module():
    """The tiny models are built once for this module and freed after it."""
    yield
    hf_model.cache_clear()
    jax_converted.cache_clear()


def _state_dict(family):
    return {k: v.detach().clone() for k, v in hf_model(family).state_dict().items()}


@functools.lru_cache(maxsize=None)
def jax_converted(family):
    """The JAX package's ``from_hf`` model and parameters."""
    return J.from_hf(hf_model(family))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _bits(t):
    """A leaf's bytes as an integer array (bf16 viewed as uint16)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy().view(np.int32 if t.element_size() == 4 else np.int16)
    a = np.asarray(t)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def assert_trees_bitwise(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b)), path
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=path)


def _ids(family, seed=3, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(np.int32)


def _inputs(family):
    ids = _ids(family)
    mask = np.ones_like(ids)
    if family == "bert":
        mask[1, 10:] = 0
        types = np.random.default_rng(4).integers(0, 2, ids.shape).astype(np.int32)
        return dict(input_ids=ids, attention_mask=mask, token_type_ids=types)
    return dict(input_ids=ids)


# ------------------------------------------------------------- the leaves
@pytest.mark.parametrize("family", FAMILIES)
def test_params_from_hf_bitwise_equal_jax(family):
    cls, jcfg_fn, jparams_fn = J._get_converter(family)
    tcls, tcfg_fn, tparams_fn = T._get_family(family)
    assert tparams_fn.__name__ == jparams_fn.__name__
    hf = hf_model(family)
    jcfg, tcfg = jcfg_fn(hf.config), tcfg_fn(hf.config)
    sd = _state_dict(family)
    want = jax.tree_util.tree_map(np.asarray, jparams_fn(sd, jcfg))
    got = tparams_fn(sd, tcfg, device="cpu")
    assert_trees_bitwise(got, want)


@pytest.mark.parametrize("family", ["llama", "gemma", "gpt2", "gpt_neox", "opt"])
def test_params_from_hf_bf16_bitwise_equal_jax(family):
    _, jcfg_fn, jparams_fn = J._get_converter(family)
    _, tcfg_fn, tparams_fn = T._get_family(family)
    hf = hf_model(family)
    sd = _state_dict(family)
    want = jparams_fn(sd, jcfg_fn(hf.config), dtype=jnp.bfloat16)
    got = tparams_fn(sd, tcfg_fn(hf.config), dtype=torch.bfloat16, device="cpu")
    for _, leaf in _leaves(got):
        assert leaf.dtype == torch.bfloat16
    assert_trees_bitwise(got, jax.tree_util.tree_map(np.asarray, want))


def test_neox_fused_qkv_is_deinterleaved_per_head():
    """NeoX stores ``query_key_value`` as ``[q_h, k_h, v_h]`` rows per head;
    distinct values per head and per role pin the ``[q | k | v]`` columns."""
    nh, hd, h = 4, 16, 64
    cfg = T.gpt_neox_config_from_hf(hf_model("gpt_neox").config)
    sd = _state_dict("gpt_neox")
    w = np.zeros((nh, 3, hd, h), np.float32)
    b = np.zeros((nh, 3, hd), np.float32)
    for head in range(nh):
        for role in range(3):
            w[head, role] = 100 * head + 10 * role + np.arange(hd)[:, None] / 100.0
            b[head, role] = 100 * head + 10 * role + np.arange(hd) / 100.0
    for i in range(2):
        sd[f"gpt_neox.layers.{i}.attention.query_key_value.weight"] = torch.tensor(
            w.reshape(3 * nh * hd, h))
        sd[f"gpt_neox.layers.{i}.attention.query_key_value.bias"] = torch.tensor(b.reshape(-1))
    params = T.gpt_neox_params_from_hf(sd, cfg, device="cpu")
    got_w = params["layers"]["attn"]["w_qkv"][0].numpy()  # (h, 3h)
    got_b = params["layers"]["attn"]["b_qkv"][0].numpy()
    for role in range(3):
        for head in range(nh):
            cols = slice(role * h + head * hd, role * h + (head + 1) * hd)
            np.testing.assert_array_equal(got_w[:, cols], w[head, role].T)
            np.testing.assert_array_equal(got_b[cols], b[head, role])


def test_bert_backbone_checkpoint_gets_the_jax_fresh_head():
    """A bare backbone (no pooler, no classifier) gets the JAX converter's
    fresh head: numpy ``default_rng(0)``, std 0.02, pooler drawn first, zero
    biases; bitwise equal in f32."""
    hf = hf_model("bert")
    sd = {k: v for k, v in _state_dict("bert").items()
          if not k.startswith(("classifier", "bert.pooler"))}
    want = jax.tree_util.tree_map(np.asarray, J.bert_params_from_hf(sd, J.bert_config_from_hf(
        hf.config)))
    got = T.bert_params_from_hf(sd, T.bert_config_from_hf(hf.config), device="cpu")
    assert_trees_bitwise(got, want)
    assert got["classifier"]["w"].shape == (64, 3)
    assert abs(float(got["pooler"]["w"].std()) - 0.02) < 2e-3
    assert not got["classifier"]["b"].any()


# ------------------------------------------------------------- the logits
def _port_logits(model, params, inputs):
    return model.apply(params, **{k: torch.as_tensor(v) for k, v in inputs.items()})[
        "logits"].detach().numpy()


@pytest.mark.parametrize("family", FAMILIES)
def test_from_hf_logits_match_transformers_and_jax(family):
    hf = hf_model(family)
    model, params = T.from_hf(hf, device="cpu")
    assert model.device.type == "cpu"
    inputs = _inputs(family)
    ours = _port_logits(model, params, inputs)
    with torch.no_grad():
        theirs = hf(**{k: torch.as_tensor(v, dtype=torch.long) for k, v in inputs.items()}
                    ).logits.float().numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=1e-3)
    jmodel, jparams = jax_converted(family)
    ref = np.asarray(jmodel.apply(jparams, **{k: jnp.asarray(v) for k, v in inputs.items()})[
        "logits"])
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------- from_hf_checkpoint
def _write_sharded(sd, folder):
    """``sd`` as two safetensors shards and the Hugging Face index."""
    names = list(sd)
    half = len(names) // 2
    weight_map = {}
    for shard, part in ((1, names[:half]), (2, names[half:])):
        fname = f"model-{shard:05d}-of-00002.safetensors"
        save_file({k: sd[k].contiguous() for k in part}, str(folder / fname))
        weight_map.update({k: fname for k in part})
    with open(folder / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


@pytest.mark.parametrize("family", ["gpt_neox", "opt", "gpt2", "llama"])
def test_from_hf_checkpoint_sharded_safetensors_with_a_dict_config(family, tmp_path):
    hf = hf_model(family)
    sd = _state_dict(family)
    if family == "opt":  # a tied checkpoint may omit the head
        sd.pop("lm_head.weight")
    _write_sharded(sd, tmp_path)
    config = hf.config.to_dict()
    model, params = T.from_hf_checkpoint(family, str(tmp_path), config, device="cpu")
    _, want = T.from_hf(hf, device="cpu")
    assert_trees_bitwise(params, want)
    assert model.params is params
    one, _ = T.from_hf_checkpoint(family, str(tmp_path / "model.safetensors.index.json"),
                                  config, dtype=torch.bfloat16, device="cpu")
    assert all(leaf.dtype == torch.bfloat16 for _, leaf in _leaves(one.params))


# --------------------------------------------------------------- refusals
OPT_BASE = dict(vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=64)
NEOX_BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4)
GPT2_BASE = dict(vocab_size=128, n_embd=64, n_layer=2, n_head=4)
REFUSALS = {
    "opt_post_ln": ("opt_config_from_hf", dict(OPT_BASE, do_layer_norm_before=False),
                    "do_layer_norm_before"),
    "opt_project_in": ("opt_config_from_hf", dict(OPT_BASE, word_embed_proj_dim=32),
                       "word_embed_proj_dim"),
    "opt_no_bias": ("opt_config_from_hf", dict(OPT_BASE, enable_bias=False), "enable_bias"),
    "opt_no_final_norm": ("opt_config_from_hf", dict(OPT_BASE, _remove_final_layer_norm=True),
                          "_remove_final_layer_norm"),
    "opt_no_affine": ("opt_config_from_hf", dict(OPT_BASE, layer_norm_elementwise_affine=False),
                      "layer_norm_elementwise_affine"),
    "opt_act": ("opt_config_from_hf", dict(OPT_BASE, activation_function="silu"),
                "activation"),
    "gptj_no_rotary_dim": ("gptj_config_from_hf", dict(GPT2_BASE, rotary_dim=None),
                           "rotary_dim"),
    "neox_dynamic": ("gpt_neox_config_from_hf",
                     dict(NEOX_BASE, rotary_pct=0.5,
                          rope_scaling={"rope_type": "dynamic", "factor": 2.0}), "rope_type"),
    "neox_odd_rotary": ("gpt_neox_config_from_hf", dict(NEOX_BASE, rotary_pct=0.1875),
                        "odd rotary_dim"),
    "gpt2_act": ("gpt2_config_from_hf", dict(GPT2_BASE, activation_function="relu"),
                 "activation_function"),
    "gpt2_unscaled": ("gpt2_config_from_hf", dict(GPT2_BASE, scale_attn_weights=False),
                      "scale_attn_weights"),
    "gpt2_layer_idx": ("gpt2_config_from_hf",
                       dict(GPT2_BASE, scale_attn_by_inverse_layer_idx=True), "scale_attn"),
    "phi3_partial_rotary": ("phi3_config_from_hf",
                            dict(LLAMA_LIKE, partial_rotary_factor=0.75),
                            "partial_rotary_factor"),
    "phi3_longrope": ("phi3_config_from_hf",
                      dict(LLAMA_LIKE, rope_scaling={"rope_type": "longrope",
                                                     "long_factor": [1.0],
                                                     "short_factor": [1.0]}), "rope_type"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_of_the_jax_converters_raise(case):
    fn, cfg, match = REFUSALS[case]
    for module in (J, T):
        with pytest.raises(ValueError, match=match):
            getattr(module, fn)(cfg)


@pytest.mark.parametrize("model_type", ["t5", "whisper", "vit"])
def test_unported_families_raise_not_implemented(model_type, tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        T._get_family(model_type)
    with pytest.raises(NotImplementedError, match=model_type):
        T.from_hf_checkpoint(model_type, str(tmp_path), {}, device="cpu")


def test_classic_gpt_configs_match_jax_field_by_field():
    import dataclasses

    for family in ("gpt2", "gpt_neox", "gptj", "opt", "phi3"):
        cfg = hf_model(family).config
        _, jfn, _ = J._get_converter(family)
        want = dataclasses.asdict(jfn(cfg))
        got = dataclasses.asdict(T._get_converter(family)(cfg))
        assert got == want, family
