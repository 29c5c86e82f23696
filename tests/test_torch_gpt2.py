"""GPT-2 in the port against the JAX package's, in f32 on the CPU: the
contract of ``tests/test_models.py:151-215``, ``tests/test_serving.py:72``
and ``tests/test_generation.py:161`` (the logits, the loss and the
gradients are held in ``tests/test_torch_gptx.py``, whose variants include
GPT-2).

- The paged engine's hard case: a request admitted mid-stream at a large
  pool offset still reads ``wpe`` rows 0..len-1; each request's tokens
  equal ``generate`` of it alone, in the port and in the JAX package
  (token-identical).
- A sequence or a cache past the position table raises.
- ``prepare_pippy`` in 2 stages of 2 chunks: the logits of the unsplit
  model (``atol=rtol=1e-5``: the same ops on the same weights, split by
  rows).
- Stacked weights are drawn with std 1/sqrt(fan_in) (within 0.02, the JAX
  test's pin).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.generation import generate as jgenerate
from accelerate_tpu.models.gpt2 import GPT2 as JGPT2, GPT2Config as JGPT2Config
import accelerate_tpu_torch as T

torch.set_num_threads(2)


def _pair(**kw):
    """(JAX GPT-2, port GPT-2) on the JAX package's weights from key 3."""
    jm = JGPT2(JGPT2Config(**kw))
    jm.init_params(jax.random.key(3))
    tm = T.GPT2(T.GPT2Config(**kw), device="cpu")
    tm.params = T.gpt2_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                         tm.config, device="cpu")
    return jm, tm


def test_continuous_batching_gpt2_absolute_positions():
    """JAX ``tests/test_serving.py:72``: one slot, three requests; the later
    ones start at large offsets of the pool and still see positions
    0..len-1."""
    jm, tm = _pair(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                   max_position_embeddings=64)
    rng = np.random.default_rng(82)
    prompts = [rng.integers(1, 128, (n,)).astype(np.int32) for n in (6, 3, 5)]
    engine = T.ContinuousBatcher(tm, batch_slots=1, max_new_tokens=5, max_cache_len=64,
                                 cache_dtype=torch.float32, bucket_sizes=(8,), block_size=4,
                                 device="cpu")
    rids = [engine.submit(p) for p in prompts]
    outs = engine.run()
    for rid, p in zip(rids, prompts):
        solo = T.generate(tm, torch.as_tensor(p[None]), max_new_tokens=5,
                          cache_dtype=torch.float32, include_prompt=False,
                          device="cpu").numpy()[0]
        jsolo = np.asarray(jgenerate(jm, p[None], max_new_tokens=5, temperature=0.0,
                                     cache_dtype=jnp.float32))[0, len(p):]
        np.testing.assert_array_equal(solo, jsolo)
        np.testing.assert_array_equal(outs[rid], solo[:len(outs[rid])], err_msg=f"rid {rid}")


def test_gpt2_generate_with_cache_matches_jax():
    jm, tm = _pair(**vars(JGPT2Config.tiny()))
    prompt = np.random.default_rng(0).integers(1, 256, (2, 8)).astype(np.int32)
    want = np.asarray(jgenerate(jm, prompt, max_new_tokens=6, temperature=0.0,
                                cache_dtype=jnp.float32))
    got = T.generate(tm, torch.as_tensor(prompt), max_new_tokens=6, cache_dtype=torch.float32,
                     device="cpu").numpy()
    assert got.shape == (2, 14)
    np.testing.assert_array_equal(got, want)


def test_gpt2_rejects_positions_past_table():
    """JAX ``tests/test_models.py:205``: no silent clamp to the last row."""
    model = T.GPT2(T.GPT2Config.tiny(max_position_embeddings=16), device="cpu")
    model.init_params(0)
    ids = torch.zeros((1, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model.apply(model.params, input_ids=ids)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model.init_cache(1, 32)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        T.generate(model, ids[:, :8], max_new_tokens=16, device="cpu")


def test_gpt2_prepare_pippy_equals_the_unsplit_model():
    """JAX ``tests/test_models.py:179-190``: 4 layers in 2 stages, 2
    chunks."""
    model = T.GPT2(T.GPT2Config.tiny(num_hidden_layers=4), device="cpu")
    model.init_params(1)
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (4, 16)))
    piped = T.prepare_pippy(model, split_points=2, num_chunks=2)
    out = piped(input_ids=ids)
    want = model.apply(model.params, input_ids=ids)["logits"]
    assert np.isfinite(out.logits.numpy()).all()
    np.testing.assert_allclose(out.logits.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_stacked_init_uses_fan_in_not_layer_count():
    model = T.GPT2(T.GPT2Config.tiny(hidden_size=64, num_hidden_layers=2), device="cpu")
    params = model.init(0)
    std = float(params["layers"]["attn"]["w_qkv"].std())
    assert abs(std - 1.0 / np.sqrt(64)) < 0.02, std
    assert "lm_head" not in params  # tied to wte
    assert T.GPT2Config.gpt2_xl().intermediate_size == 6400


def test_gpt2_xl_parameter_count_equals_jax():
    """``openai-community/gpt2-xl``'s published widths: 1,557,611,200
    parameters by both packages' count (chip_smoke.py phase 21, arm D)."""
    cfg = T.GPT2Config.gpt2_xl()
    n = T.GPT2(cfg, device="cpu").num_params()
    jcfg = JGPT2Config(**{k: getattr(cfg, k) for k in vars(JGPT2Config())})
    assert n == JGPT2(jcfg).num_params() == 1_557_611_200
