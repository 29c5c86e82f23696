"""``train_steps.py`` (GPT, BERT, T5 and regression train steps) against the
JAX package's.

Each step's ``get_batch`` cuts a raw example dict to the same batch, and its
``loss_fn`` gives the same loss on the same model outputs (numpy from a
seed: logits with padding masks, sequence logits, a next-sentence head,
predictions), in f32 on the CPU: ``atol=1e-6`` (sums of the same terms in
another order; the losses are about 1 to 5). ``build_train_step(loss_fn=
GPTTrainStep().loss_fn)`` trains the tiny Llama from the JAX package's
weights as JAX's does, at ``tests/test_torch_train.py``'s f32 pins (losses
``atol=1e-5``, parameters ``atol=5e-5``; 8 rows for the 8-device mesh).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu import train_steps as J
from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig

import accelerate_tpu_torch as T
from accelerate_tpu_torch import train_steps as P
from accelerate_tpu_torch.utils.tree import tree_leaves

ATOL = 1e-6
RAW_KEYS = ("input_ids", "attention_mask", "token_type_ids", "labels", "next_sentence_label",
            "decoder_input_ids", "decoder_attention_mask", "x", "y", "extra")


def _raw(seed=0, B=3, S=7, V=11):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, S), np.int32)
    mask[1, 4:] = 0
    mask[2, 2:] = 0
    return {"input_ids": rng.integers(0, V, (B, S)).astype(np.int32), "attention_mask": mask,
            "token_type_ids": np.zeros((B, S), np.int32),
            "labels": rng.integers(0, V, (B, S)).astype(np.int32),
            "next_sentence_label": rng.integers(0, 2, (B,)).astype(np.int32),
            "decoder_input_ids": rng.integers(0, V, (B, S)).astype(np.int32),
            "decoder_attention_mask": mask, "x": rng.standard_normal((B, 4)).astype(np.float32),
            "y": rng.standard_normal((B, 4)).astype(np.float32), "extra": np.zeros((1,))}


def _outputs(name, seed=1, B=3, S=7, V=11):
    rng = np.random.default_rng(seed)
    if name == "gpt":
        return {"logits": rng.standard_normal((B, S, V)).astype(np.float32)}
    if name == "bert":
        return {"logits": rng.standard_normal((B, S, V)).astype(np.float32),
                "seq_logits": rng.standard_normal((B, 2)).astype(np.float32)}
    if name == "t5":
        return {"logits": rng.standard_normal((B, S, V)).astype(np.float32)}
    return {"prediction": rng.standard_normal((B, 4)).astype(np.float32)}


def _torch(tree):
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in tree.items()}


@pytest.mark.parametrize("name", ["gpt", "bert", "t5", "regression"])
def test_batch_and_loss_match_jax(name):
    pstep, jstep = T.get_train_step(name), J.get_train_step(name)
    assert type(pstep).__name__ == type(jstep).__name__ and pstep.batch_keys == jstep.batch_keys
    raw = _raw()
    pbatch, jbatch = pstep.get_batch(raw), jstep.get_batch(raw)
    assert sorted(pbatch) == sorted(jbatch)
    for k in pbatch:
        assert np.array_equal(np.asarray(pbatch[k]), np.asarray(jbatch[k])), k
    outs = _outputs(name)
    got = pstep.loss_fn(_torch(outs), _torch(pbatch))
    want = jstep.loss_fn(_jax(outs), _jax(jbatch))
    assert got.dtype == torch.float32 and abs(float(got) - float(want)) <= ATOL
    # A model's own loss passes through.
    own = {**outs, "loss": torch.tensor(2.5)}
    assert float(pstep.loss_fn(own, _torch(pbatch))) == 2.5


def test_gpt_regularizers_and_the_bert_classification_head_match_jax():
    raw = _raw(2)
    outs = _outputs("gpt", 3)
    for kw in (dict(z_loss=1e-3), dict(label_smoothing=0.1), dict(z_loss=1e-4,
                                                                   label_smoothing=0.2)):
        got = P.GPTTrainStep(**kw).loss_fn(_torch(outs), _torch(raw))
        want = J.GPTTrainStep(**kw).loss_fn(_jax(outs), _jax(raw))
        assert abs(float(got) - float(want)) <= ATOL
        with pytest.raises(ValueError, match="in-graph"):
            P.GPTTrainStep(**kw).loss_fn({**_torch(outs), "loss": torch.tensor(1.0)},
                                         _torch(raw))
    no_labels = {k: v for k, v in raw.items() if k != "labels"}
    assert np.array_equal(P.GPTTrainStep().get_batch(no_labels)["labels"], raw["input_ids"])
    seq = {"logits": np.random.default_rng(4).standard_normal((3, 2)).astype(np.float32)}
    batch = {"labels": np.array([0, 1, 1], np.int32), "attention_mask": raw["attention_mask"]}
    got = P.BertTrainStep().loss_fn(_torch(seq), _torch(batch))
    want = J.BertTrainStep().loss_fn(_jax(seq), _jax(batch))
    assert abs(float(got) - float(want)) <= ATOL
    with pytest.raises(ValueError, match="Unknown train step"):
        T.get_train_step("llama")


def test_build_train_step_with_a_train_step_loss_matches_jax():
    widths = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2)
    jm = JLlama(JConfig.tiny(**widths))
    jm.init_params(jax.random.key(0))
    tm = T.Llama(T.LlamaConfig.tiny(attention_impl="flash", **widths), device="cpu")
    tm.params = T.llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                          tm.config, device="cpu")
    jacc = JAccelerator()
    jpm, jpo = jacc.prepare(jm, optax.adamw(3e-4))
    jdef = J.GPTTrainStep()
    jstep = jacc.build_train_step(jpm, jpo, loss_fn=jdef.loss_fn)
    acc = T.Accelerator(device="cpu")
    pm, po = acc.prepare(tm, T.adamw(3e-4, device="cpu"))
    pdef = T.GPTTrainStep()
    step = acc.build_train_step(pm, po, loss_fn=pdef.loss_fn)
    rng = np.random.default_rng(5)
    for _ in range(3):
        raw = {"input_ids": rng.integers(0, 256, (8, 32)).astype(np.int32), "extra": 1}
        got, want = step(pdef.get_batch(raw), clip_norm=1.0), jstep(jdef.get_batch(raw),
                                                                  clip_norm=1.0)
        assert abs(float(got) - float(want)) <= 1e-5
    for a, b in zip(jax.tree_util.tree_leaves(jpm.handle.params), tree_leaves(pm.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-5, rtol=0)
