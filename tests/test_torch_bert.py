"""The port's BERT (``models/bert.py``) and ``ops/norms.layer_norm`` against
the JAX package's.

Weights come from the JAX package's init and cross with
``bert_params_from_numpy``; inputs are numpy from a seed, with padding in
``attention_mask`` (one row padded from position 9, one from position 5)
and both token types. Tolerances, with their reasons:

- f32 logits, loss and every parameter gradient: ``atol=1e-5``. Both sides
  compute in f32 on the CPU, with sums (matmuls, softmax, LayerNorm means)
  in another order; the logits are about 0.1 and the gradients about 1e-2.
- the bf16-compute forward (parameters cast to bf16, scores, softmax and
  LayerNorm in f32, as both packages do): logits within ``5e-2`` of JAX's
  bf16 forward and of the port's own f32 forward. bf16 keeps 8 bits, and
  each of the 2 layers rounds its activations to bf16 several times
  (relative 2**-9 each); the logits are about 0.1 to 1.
- ``layer_norm`` in f32: ``atol=1e-6`` (values about 1; the mean and the
  variance are sums of 64 terms in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models.bert import BertConfig as JConfig
from accelerate_tpu.models.bert import BertForSequenceClassification as JBert
from accelerate_tpu.models.convert import bert_config_from_hf as j_bert_config_from_hf
from accelerate_tpu.ops.norms import layer_norm as j_layer_norm

import accelerate_tpu_torch as T
from accelerate_tpu_torch.models.convert import _get_converter
from accelerate_tpu_torch.ops.norms import layer_norm
from accelerate_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

ATOL = 1e-5
BF16_ATOL = 5e-2
B, S = 4, 16


def _models(**kw):
    jm = JBert(JConfig.tiny(hidden_dropout_prob=0.0, **kw))
    jm.init_params(jax.random.key(3))
    tm = T.BertForSequenceClassification(T.BertConfig.tiny(hidden_dropout_prob=0.0, **kw),
                                         device="cpu")
    tm.params = T.bert_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                         tm.config, device="cpu")
    return jm, tm


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 9:] = 0
    mask[3, 5:] = 0
    token_type = np.zeros((B, S), np.int32)
    token_type[:, S // 2:] = 1
    labels = rng.integers(0, 2, (B,)).astype(np.int32)
    return dict(input_ids=ids, attention_mask=mask, token_type_ids=token_type, labels=labels)


def _as_torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def test_forward_and_loss_match_jax_in_f32():
    jm, tm = _models()
    batch = _inputs()
    want = jm.apply(jm.params, **{k: jnp.asarray(v) for k, v in batch.items()})
    got = tm.apply(tm.params, **_as_torch(batch))
    assert got["logits"].dtype == torch.float32 and got["logits"].shape == (B, 2)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL,
                               rtol=0)
    assert abs(float(got["loss"]) - float(want["loss"])) <= ATOL


def test_gradients_match_jax_in_f32():
    jm, tm = _models()
    batch = _inputs(1)

    def jloss(p):
        return jm.apply(p, **{k: jnp.asarray(v) for k, v in batch.items()})["loss"]

    jgrads = jax.jit(jax.grad(jloss))(jm.params)
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tm.params)]
    from accelerate_tpu_torch.utils.tree import tree_unflatten

    loss = tm.apply(tree_unflatten(tm.params, leaves), **_as_torch(batch))["loss"]
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads) == 25
    for a, b in zip(jleaves, grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)


def test_bf16_compute_forward_matches_jax():
    jm, tm = _models()
    batch = _inputs(2)
    jparams = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), jm.params)
    want = jm.apply(jparams, **{k: jnp.asarray(v) for k, v in batch.items()})["logits"]
    tparams = {k: v for k, v in tm.params.items()}
    from accelerate_tpu_torch.utils.tree import tree_map

    got = tm.apply(tree_map(lambda p: p.to(torch.bfloat16), tparams), **_as_torch(batch))
    f32 = tm.apply(tm.params, **_as_torch(batch))["logits"]
    assert got["logits"].dtype == torch.float32
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(got["logits"].numpy(), f32.numpy(), atol=BF16_ATOL, rtol=0)


def test_masked_keys_do_not_reach_the_output():
    """A padded key's token changes nothing of the unpadded rows' logits."""
    _, tm = _models()
    batch = _as_torch(_inputs())
    out = tm.apply(tm.params, **batch)["logits"]
    batch["input_ids"][1, 12] = (batch["input_ids"][1, 12] + 1) % 512
    again = tm.apply(tm.params, **batch)["logits"]
    assert torch.equal(out, again)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = j_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-12)
    got = layer_norm(torch.tensor(x), torch.tensor(scale), torch.tensor(bias), 1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    half = layer_norm(torch.tensor(x).to(torch.bfloat16), torch.tensor(scale),
                      torch.tensor(bias), 1e-12)
    assert half.dtype == torch.bfloat16


def test_dropout_draws_from_the_generator():
    _, tm = _models()
    tm.config = dataclasses.replace(tm.config, hidden_dropout_prob=0.3)
    batch = _as_torch(_inputs())
    outs = []
    for seed in (1, 1, 2):
        g = torch.Generator().manual_seed(seed)
        outs.append(tm.apply(tm.params, train=True, generator=g, **batch)["logits"])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    plain = tm.apply(tm.params, **batch)["logits"]
    assert torch.equal(plain, tm.apply(tm.params, train=False,
                                       generator=torch.Generator(), **batch)["logits"])


HF_BERT_BASE_CASED = dict(vocab_size=28996, hidden_size=768, num_hidden_layers=12,
                          num_attention_heads=12, intermediate_size=3072, hidden_act="gelu",
                          hidden_dropout_prob=0.1, max_position_embeddings=512,
                          type_vocab_size=2, layer_norm_eps=1e-12,
                          position_embedding_type="absolute", model_type="bert")


@pytest.mark.parametrize("hf", [HF_BERT_BASE_CASED, dict(HF_BERT_BASE_CASED, num_labels=3),
                                dict(HF_BERT_BASE_CASED, hidden_act="relu"),
                                dict(HF_BERT_BASE_CASED, position_embedding_type="relative_key")],
                         ids=["base-cased", "three-labels", "relu", "relative"])
def test_config_converter_matches_jax(hf):
    try:
        want = dataclasses.asdict(j_bert_config_from_hf(hf))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:30]):
            T.bert_config_from_hf(hf)
        return
    assert dataclasses.asdict(T.bert_config_from_hf(hf)) == want
    assert _get_converter("bert") is T.bert_config_from_hf
    model = T.BertForSequenceClassification(T.bert_config_from_hf(hf), device="cpu")
    assert model.num_params() == 108311810 + (hf.get("num_labels", 2) - 2) * 769


def test_params_from_numpy_refuses_a_wrong_tree():
    jm, tm = _models()
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    bad = dict(tree, pooler={"w": tree["pooler"]["w"]})
    with pytest.raises(ValueError, match="pooler"):
        T.bert_params_from_numpy(bad, tm.config, device="cpu")
    bad = dict(tree, classifier={"w": tree["classifier"]["w"][:, :1], "b": tree["classifier"]["b"]})
    with pytest.raises(ValueError, match="expected shape"):
        T.bert_params_from_numpy(bad, tm.config, device="cpu")
    counted = sum(int(np.prod(np.shape(x))) for x in jax.tree_util.tree_leaves(tree))
    assert counted == tm.num_params()


@pytest.mark.parametrize("option", [dict(remat=True)])
def test_unported_bert_options_raise(option):
    # remat is ported: the model builds, and its gradients with dropout on
    # are the plain model's, bitwise (the recompute draws the forward's
    # masks). The pipeline schedule still raises.
    _, plain = _models()
    model = T.BertForSequenceClassification(T.BertConfig.tiny(hidden_dropout_prob=0.3,
                                                              **option), device="cpu")
    model.params = plain.params
    plain.config = dataclasses.replace(plain.config, hidden_dropout_prob=0.3)
    batch = _as_torch(_inputs(5))
    grads = []
    for m in (model, plain):
        leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(m.params)]
        from accelerate_tpu_torch.utils.tree import tree_unflatten

        g = torch.Generator().manual_seed(11)
        loss = m.apply(tree_unflatten(m.params, leaves), train=True, generator=g,
                       **batch)["loss"]
        grads.append((loss, torch.autograd.grad(loss, leaves), g.get_state()))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][2], grads[1][2])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))
    _, tm = _models()
    with pytest.raises(NotImplementedError, match="pipeline"):
        tm.apply(tm.params, **_as_torch(_inputs()), pipeline=object())


def test_remat_step_is_bitwise_the_plain_step_and_matches_jax():
    """Three fused AdamW steps with dropout 0.1: ``BertConfig(remat=True)``
    gives the plain step's losses and parameters bitwise; without dropout
    the remat forward and gradients match JAX's remat (``jax.checkpoint`` of
    the layer scan) at the f32 pins."""
    from accelerate_tpu_torch.utils.tree import tree_unflatten

    def run(remat):
        _, tm = _models()
        model = T.BertForSequenceClassification(
            T.BertConfig.tiny(hidden_dropout_prob=0.1, remat=remat), device="cpu")
        model.params = tm.params
        acc = T.Accelerator(cpu=True)
        pm, po = acc.prepare(model, T.adamw(1e-3, device="cpu"))
        step = acc.build_train_step(pm, po)
        losses = [step(_inputs(seed), clip_norm=1.0) for seed in range(3)]
        return losses, tree_leaves(pm.params)

    (l0, p0), (l1, p1) = run(False), run(True)
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    jm, tm = _models(remat=True)
    batch = _inputs(1)

    def jloss(p):
        return jm.apply(p, **{k: jnp.asarray(v) for k, v in batch.items()})["loss"]

    jgrads = jax.jit(jax.grad(jloss))(jm.params)
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tm.params)]
    loss = tm.apply(tree_unflatten(tm.params, leaves), train=True, **_as_torch(batch))["loss"]
    assert abs(float(loss.detach()) - float(jloss(jm.params))) <= ATOL
    for a, b in zip(jax.tree_util.tree_leaves(jgrads), torch.autograd.grad(loss, leaves)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)
