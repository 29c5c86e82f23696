"""Parity of the PyTorch port's Llama and ``generate`` with the JAX reference.

Weights are initialized by the JAX package from a fixed key and carried into
the port with ``models/from_jax.llama_params_from_numpy``; token ids come
from numpy with a stated seed. Tolerances, with their reasons:

- logits, uncached and cached: fp32 on the CPU in both frameworks, but
  matmul and softmax sums run in another order, ``atol=rtol=1e-4`` (the
  logits are O(1) after a few layers of random weights);
- greedy ``generate``: token-identical (argmax of logits that agree to
  ~1e-6);
- ``left_align``, ``mask_positions``, the logits warpers: exact (integer or
  selection arithmetic).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.generation import (
    _warp_scores as j_warp,
    generate as jgenerate,
    left_align as j_left_align,
    mask_positions as j_mask_positions,
)
from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
from accelerate_tpu.models.llama import apply_rope as j_apply_rope, rope_tables as j_rope_tables
from accelerate_tpu_torch import generation as tgen
from accelerate_tpu_torch.models import Llama, LlamaConfig, llama_params_from_numpy
from accelerate_tpu_torch.models.llama import apply_rope, rms_norm, rope_tables

torch.set_num_threads(2)

SEED = 7

CONFIGS = {
    "llama": dict(),
    # Gemma-2 recipe: tied head, sandwich norms, softcaps, GeGLU, scaled
    # embedding, query scalar, alternating local/global windows.
    "gemma2-like": dict(tie_word_embeddings=True, sandwich_norms=True,
                        attn_logit_softcap=20.0, final_logit_softcap=10.0,
                        hidden_act="gelu_tanh", embedding_multiplier=8.0,
                        query_pre_attn_scalar=16.0, layer_windows=(3, None)),
    # Qwen recipe + Llama-3.1 rope scaling: QKV biases, QK norm, windows.
    "qwen-like": dict(attention_bias=True, qk_norm=True, sliding_window=4,
                      rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                    "original_max_position_embeddings": 64}),
    # YaRN: blended frequencies and the attention factor on cos and sin.
    "yarn": dict(rope_scaling={"rope_type": "yarn", "factor": 4.0,
                               "original_max_position_embeddings": 8}),
    # Dynamic NTK past a 4-token window: the base stretches with the length
    # (the forward's, or the cache's under cached decode).
    "dynamic": dict(max_position_embeddings=4,
                    rope_scaling={"rope_type": "dynamic", "factor": 2.0}),
}


def _models(name):
    kw = CONFIGS[name]
    jm = JLlama(JConfig.tiny(**kw))
    jm.init_params(jax.random.key(0))
    if "bq" in jm.params["layers"]["attn"]:
        # Non-zero biases so the bias path is exercised.
        rng = np.random.default_rng(SEED)
        attn = dict(jm.params["layers"]["attn"])
        for b in ("bq", "bk", "bv"):
            attn[b] = jnp.asarray(rng.standard_normal(attn[b].shape).astype(np.float32) * 0.1)
        jm.params = {**jm.params, "layers": {**jm.params["layers"], "attn": attn}}
    tm = Llama(LlamaConfig.tiny(**kw), device="cpu")
    tm.params = llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                        tm.config, device="cpu")
    return jm, tm


@pytest.mark.parametrize("name", list(CONFIGS))
def test_uncached_logits_match_jax(name):
    jm, tm = _models(name)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(1, 256, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, -3:] = 0
    ref = jm.apply(jm.params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    got = tm.apply(tm.params, input_ids=torch.as_tensor(ids), attention_mask=torch.as_tensor(mask))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(ref["logits"]),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cached_prefill_and_decode_match_jax(name):
    jm, tm = _models(name)
    rng = np.random.default_rng(SEED + 1)
    ids = rng.integers(1, 256, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.int32)
    mask[0, :2] = 0  # left padding
    pos = np.clip(np.cumsum(mask, -1) - 1, 0, None).astype(np.int32)
    jc = jm.init_cache(2, 10, dtype=jnp.float32)
    tc = tm.init_cache(2, 10, dtype=torch.float32)
    jo = jm.apply(jm.params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                  cache=jc, positions=jnp.asarray(pos))
    to = tm.apply(tm.params, input_ids=torch.as_tensor(ids), attention_mask=torch.as_tensor(mask),
                  cache=tc, positions=torch.as_tensor(pos))
    np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]), atol=1e-4, rtol=1e-4)
    step = rng.integers(1, 256, (2, 1)).astype(np.int32)
    spos = pos[:, -1:] + 1
    jo = jm.apply(jm.params, input_ids=jnp.asarray(step), cache=jo["cache"],
                  positions=jnp.asarray(spos))
    to = tm.apply(tm.params, input_ids=torch.as_tensor(step), cache=to["cache"],
                  positions=torch.as_tensor(spos))
    np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]), atol=1e-4, rtol=1e-4)
    assert to["cache"]["pos"] == int(jo["cache"]["pos"]) == 7
    np.testing.assert_array_equal(to["cache"]["kv_mask"].numpy(), np.asarray(jo["cache"]["kv_mask"]))
    np.testing.assert_allclose(to["cache"]["k"].numpy(), np.asarray(jo["cache"]["k"]),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["llama", "qwen-like", "dynamic"])
def test_greedy_generate_token_identical_to_jax(name):
    jm, tm = _models(name)
    rng = np.random.default_rng(SEED + 2)
    ids = rng.integers(1, 256, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, 4:] = 0
    mask[2, 6:] = 0
    eos = int(ids[0, 3])
    ref = jgenerate(jm, jnp.asarray(ids), attention_mask=jnp.asarray(mask), max_new_tokens=8,
                    cache_dtype=jnp.float32, eos_token_id=eos, pad_token_id=0)
    got = tgen.generate(tm, ids, attention_mask=mask, max_new_tokens=8, cache_dtype=torch.float32,
                        eos_token_id=eos, pad_token_id=0, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sampled_generate_reproducible_and_topk1_is_greedy():
    _, tm = _models("llama")
    ids = np.random.default_rng(SEED + 3).integers(1, 256, (2, 5)).astype(np.int32)

    def run(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return tgen.generate(tm, ids, max_new_tokens=6, cache_dtype=torch.float32,
                             generator=g, device="cpu", **kw).numpy()

    a, b = run(3, temperature=0.9, top_p=0.9), run(3, temperature=0.9, top_p=0.9)
    np.testing.assert_array_equal(a, b)
    greedy = tgen.generate(tm, ids, max_new_tokens=6, cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(run(5, temperature=1.3, top_k=1), greedy.numpy())
    assert run(5, do_sample=True, num_return_sequences=2).shape == (4, 11)


def test_left_align_mask_positions_and_warpers_match_jax():
    rng = np.random.default_rng(SEED + 4)
    ids = rng.integers(1, 256, (3, 6)).astype(np.int32)
    mask = (np.arange(6)[None] < np.array([[6], [3], [1]])).astype(np.int32)
    ji, jmk = j_left_align(jnp.asarray(ids), jnp.asarray(mask))
    ti, tmk = tgen.left_align(torch.as_tensor(ids), torch.as_tensor(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tmk.numpy(), np.asarray(jmk))
    np.testing.assert_array_equal(tgen.mask_positions(tmk).numpy(),
                                  np.asarray(j_mask_positions(jmk)))
    scores = rng.standard_normal((4, 50)).astype(np.float32) * 3
    for kw in (dict(temperature=0.7), dict(top_k=5), dict(top_p=0.8), dict(top_k=9, top_p=0.5)):
        ref = np.asarray(j_warp(jnp.asarray(scores), **kw))
        got = tgen._warp_scores(torch.as_tensor(scores), **kw).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        np.testing.assert_allclose(got[~np.isinf(got)], ref[~np.isinf(ref)], rtol=1e-6)


@pytest.mark.parametrize("scaling", [None, {"rope_type": "linear", "factor": 4.0},
                                     {"rope_type": "llama3", "factor": 8.0}])
def test_rope_and_rms_norm_match_jax(scaling):
    rng = np.random.default_rng(SEED + 5)
    pos = rng.integers(0, 9000, (2, 5)).astype(np.int32)
    jc, js = j_rope_tables(jnp.asarray(pos), 128, 5e5, scaling)
    tc, ts = rope_tables(torch.as_tensor(pos), 128, 5e5, scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    x = rng.standard_normal((2, 5, 3, 128)).astype(np.float32)
    np.testing.assert_allclose(apply_rope(torch.as_tensor(x), tc, ts).numpy(),
                               np.asarray(j_apply_rope(jnp.asarray(x), jc, js)), atol=1e-5)
    from accelerate_tpu.models.llama import rms_norm as j_rms_norm

    w = rng.standard_normal((128,)).astype(np.float32)
    np.testing.assert_allclose(rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-5).numpy(),
                               np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
                               atol=1e-5, rtol=1e-5)


def test_unported_rope_types_and_model_options_raise():
    # yarn and dynamic are ported: their tables match JAX's at a length past
    # the window (dynamic's stretch) and at one inside it.
    rng = np.random.default_rng(SEED + 6)
    pos = rng.integers(0, 9000, (2, 5)).astype(np.int32)
    for scaling in ({"rope_type": "yarn", "factor": 2.0},
                    {"rope_type": "yarn", "factor": 8.0, "mscale": 1.0, "mscale_all_dim": 0.5,
                     "original_max_position_embeddings": 4096, "truncate": False},
                    {"rope_type": "dynamic", "factor": 2.0}):
        for seq_len in (16384, 1024):
            jc, js = j_rope_tables(jnp.asarray(pos), 128, 5e5, scaling, seq_len=seq_len,
                                   max_position_embeddings=8192)
            tc, ts = rope_tables(torch.as_tensor(pos), 128, 5e5, scaling, seq_len=seq_len,
                                 max_position_embeddings=8192)
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    with pytest.raises(ValueError, match="Unsupported rope_type"):
        rope_tables(torch.zeros((1, 2), dtype=torch.int32), 16, 1e4, {"rope_type": "ntk-x"})
    # Labels are ported now: the head adds the shifted-label loss.
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.init_params(0)
    ids = torch.ones((1, 4), dtype=torch.int32)
    out = tm.apply(tm.params, input_ids=ids, labels=ids)
    assert out["loss"].dim() == 0 and bool(torch.isfinite(out["loss"]))
    # Ulysses is ported: without an sp group it is the plain attention, as
    # JAX's is without an sp axis. The pipeline schedule is ported: a spec
    # of 2 stages on this process gives the plain forward's loss.
    um = Llama(LlamaConfig.tiny(attention_impl="ulysses"), device="cpu")
    assert torch.equal(um.apply(tm.params, input_ids=ids, labels=ids)["loss"], out["loss"])
    from accelerate_tpu_torch.parallel.pipeline import PipelineSpec

    piped = tm.apply(tm.params, input_ids=ids, labels=ids,
                     pipeline=PipelineSpec(stages=2, num_microbatches=1))
    torch.testing.assert_close(piped["loss"], out["loss"], rtol=1e-6, atol=0)


def test_llama3_8b_preset_and_param_count_match_jax():
    assert LlamaConfig.llama3_8b() == LlamaConfig(**vars(JConfig.llama3_8b()))
    cfg = LlamaConfig.llama3_8b()
    assert Llama(cfg, device="cpu").num_params() == JLlama(JConfig.llama3_8b()).num_params()


def test_from_jax_rejects_mismatched_trees():
    jm, tm = _models("llama")
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    bad = {**tree, "final_norm": {"weight": np.ones((3,), np.float32)}}
    with pytest.raises(ValueError, match="final_norm"):
        llama_params_from_numpy(bad, tm.config, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="tree mismatch"):
        llama_params_from_numpy(missing, tm.config, device="cpu")
    bf16 = llama_params_from_numpy(tree, tm.config, device="cpu", dtype=torch.bfloat16)
    assert bf16["layers"]["attn"]["wq"].dtype == torch.bfloat16
