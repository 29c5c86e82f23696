"""Parity of the port's training step with the JAX package's.

The slice as a whole: ``Accelerator.prepare(model, adamw)`` →
``build_train_step`` → ``step(batch, clip_norm)``, on a small Llama with
head_dim 64 and GQA (``tiny(hidden_size=256, num_attention_heads=4,
num_key_value_heads=2)``) at S=128, ``mixed_precision="no"``, ``adamw(3e-4)``,
``clip_norm=1.0`` and accumulation 2 over 4 micro-steps. Weights start from
the JAX package's init and are carried across with
``llama_params_from_numpy``; batches are numpy token ids from a seed. The
port runs ``attention_impl="flash"`` (the plain flash version on the CPU);
the JAX package's ``flash`` resolves to dense off the TPU, and the two agree
to 1e-5 (``tests/test_torch_flash_attention.py``). The batch is 8 rows
because the JAX side trains on the 8-device CPU mesh of
``tests/conftest.py`` (dp = 8).

Tolerances, with their reasons. Both sides compute in fp32 on the CPU, but
sums run in another order (and JAX reduces the gradient across the 8 dp
shards), so gradients agree to about 1e-6 relative:

- per-step losses: ``atol=1e-5`` (losses are about 6);
- final parameters: ``atol=5e-5``, a sixth of one learning-rate step. Adam
  divides by sqrt(v), which magnifies a relative gradient difference where
  a gradient element is near zero; the largest difference seen is 2.7e-5;
- moments: ``atol`` of 1e-4 times each leaf's largest magnitude;
- the update count and the accumulation bookkeeping: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
from accelerate_tpu.ops.losses import cross_entropy_loss as j_cross_entropy_loss
from accelerate_tpu.optimizer import _global_norm as j_global_norm

import accelerate_tpu_torch as T
from accelerate_tpu_torch.accelerator import global_norm
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.ops.losses import cross_entropy_loss
from accelerate_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

torch.set_num_threads(2)

SEED = 5
WIDTHS = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2)
LOSS_ATOL, PARAM_ATOL, MOMENT_RTOL = 1e-5, 5e-5, 1e-4


def _models():
    jm = JLlama(JConfig.tiny(**WIDTHS))
    jm.init_params(jax.random.key(0))
    tm = T.Llama(T.LlamaConfig.tiny(attention_impl="flash", **WIDTHS), device="cpu")
    tm.params = T.llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                          tm.config, device="cpu")
    return jm, tm


def _batches(n, B=8, S=128):
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 256, (B, S)).astype(np.int32)
        out.append({"input_ids": ids, "labels": ids})
    return out


def test_train_step_matches_jax():
    jm, tm = _models()
    jacc = JAccelerator(mixed_precision="no", gradient_accumulation_steps=2)
    jpm, jpo = jacc.prepare(jm, optax.adamw(3e-4))
    jstep = jacc.build_train_step(jpm, jpo)
    acc = T.Accelerator(mixed_precision="no", gradient_accumulation_steps=2, device="cpu")
    pm, po = acc.prepare(tm, T.adamw(3e-4, device="cpu"))
    step = acc.build_train_step(pm, po)
    for batch in _batches(4):
        want = float(jstep(batch, clip_norm=1.0))
        got = step(batch, clip_norm=1.0)
        assert isinstance(got, torch.Tensor) and got.dim() == 0
        assert abs(float(got) - want) <= LOSS_ATOL
    for a, b in zip(jax.tree_util.tree_leaves(jpm.handle.params), tree_leaves(pm.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=PARAM_ATOL, rtol=0)
    jstate, state = jpo.opt_state[0], po.opt_state[0]
    assert int(state.count) == int(jstate.count) == 2
    for jtree, tree in ((jstate.mu, state.mu), (jstate.nu, state.nu)):
        for a, b in zip(jax.tree_util.tree_leaves(jtree), tree_leaves(tree)):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                       atol=MOMENT_RTOL * float(np.abs(a).max()))
    assert all(bool((g == 0).all()) for g in tree_leaves(po.grads))


def test_leaves_walk_in_sorted_key_order_as_jax():
    """The global-norm sum adds leaf terms in ``jax.tree_util`` order, which
    sorts dict keys; the port's trees walk the same way, whatever the
    insertion order of its dicts."""
    jm, tm = _models()
    jleaves = jax.tree_util.tree_leaves(jm.params)
    tleaves = tree_leaves(tm.params)
    assert len(jleaves) == len(tleaves) == 12
    for a, b in zip(jleaves, tleaves):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert list(tm.params) != sorted(tm.params)  # insertion order is not sorted
    shuffled = {k: tm.params[k] for k in reversed(list(tm.params))}
    assert [id(x) for x in tree_leaves(shuffled)] == [id(x) for x in tleaves]
    rebuilt = tree_unflatten(tm.params, tleaves)
    assert [id(x) for x in tree_leaves(rebuilt)] == [id(x) for x in tleaves]
    got = float(global_norm(tm.params))
    want = float(j_global_norm(jm.params))
    assert abs(got - want) <= 1e-6 * want


def test_accumulation_updates_only_on_boundaries():
    _, tm = _models()
    acc = T.Accelerator(gradient_accumulation_steps=2, device="cpu")
    pm, po = acc.prepare(tm, T.adamw(3e-4, device="cpu"))
    step = acc.build_train_step(pm, po)
    start = [p.clone() for p in tree_leaves(pm.params)]
    batches = _batches(4, B=2, S=16)
    registry.reset_launch_counts()
    step(batches[0], clip_norm=1.0)
    assert int(po.opt_state[0].count) == 0
    assert all(torch.equal(a, b) for a, b in zip(start, tree_leaves(pm.params)))
    assert any(bool((g != 0).any()) for g in tree_leaves(po.grads))
    step(batches[1], clip_norm=1.0)
    assert int(po.opt_state[0].count) == 1
    assert all(bool((g == 0).all()) for g in tree_leaves(po.grads))
    assert not all(torch.equal(a, b) for a, b in zip(start, tree_leaves(pm.params)))
    step(batches[2])
    step(batches[3])
    assert int(po.opt_state[0].count) == 2
    assert registry.launch_counts == {}  # CPU tensors: plain versions only
    # A new build drops a half-filled buffer and counts micro-steps from 0.
    step(batches[0])
    assert any(bool((g != 0).any()) for g in tree_leaves(po.grads))
    step = acc.build_train_step(pm, po)
    assert all(bool((g == 0).all()) for g in tree_leaves(po.grads))
    step(batches[1])
    assert int(po.opt_state[0].count) == 2
    step(batches[2])
    assert int(po.opt_state[0].count) == 3
    with pytest.raises(AttributeError):
        acc.gradient_accumulation_steps = 4


def test_bf16_mixed_precision_keeps_f32_masters_and_grads():
    _, tm = _models()
    acc = T.Accelerator(mixed_precision="bf16", device="cpu")
    pm, po = acc.prepare(tm, T.adamw(3e-4, device="cpu"))
    step = acc.build_train_step(pm, po)
    loss = step(_batches(1, B=2, S=16)[0], clip_norm=1.0)
    assert torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in tree_leaves(pm.params))
    assert all(m.dtype == torch.float32 for m in tree_leaves(po.opt_state[0].mu))
    with pytest.raises(NotImplementedError, match="fp16"):
        T.Accelerator(mixed_precision="fp16", device="cpu")
    with pytest.raises(ValueError, match="Unknown mixed_precision"):
        T.Accelerator(mixed_precision="fp7", device="cpu")


def test_loss_and_flops_match_jax():
    jm, tm = _models()
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, 256, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, -4:] = 0
    mask[0, :2] = 0
    jcfg = JConfig.tiny(**WIDTHS)
    want = jm.apply(jm.params, input_ids=jnp.asarray(ids), labels=jnp.asarray(ids),
                    attention_mask=jnp.asarray(mask))["loss"]
    got = tm.apply(tm.params, input_ids=torch.tensor(ids), labels=torch.tensor(ids),
                   attention_mask=torch.tensor(mask))["loss"]
    assert abs(float(got) - float(want)) <= LOSS_ATOL
    shifted = T.Llama._shift_labels(torch.tensor(ids), torch.tensor(mask)).numpy()
    assert np.array_equal(shifted, np.asarray(JLlama._shift_labels(jnp.asarray(ids),
                                                                   jnp.asarray(mask))))
    logits = rng.standard_normal((3, 5, 17)).astype(np.float32)
    labels = rng.integers(0, 17, (3, 5))
    labels[0, 1] = labels[2, 4] = -100
    for kw in ({}, {"z_loss": 1e-3}, {"label_smoothing": 0.1}):
        a = float(cross_entropy_loss(torch.tensor(logits), torch.tensor(labels), **kw))
        b = float(j_cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), **kw))
        assert abs(a - b) <= 1e-6
    assert tm.flops_per_token() == JLlama(jcfg).flops_per_token()
    # The card's training cell: Llama-3-8B widths cut to 4 layers.
    cut = dict(num_hidden_layers=4, max_position_embeddings=2048)
    big = T.Llama(T.LlamaConfig.llama3_8b(**cut), device="cpu")
    jbig = JLlama(JConfig.llama3_8b(**cut))
    assert big.num_params() == jbig.num_params() == 1_923_125_248
    assert big.flops_per_token() == jbig.flops_per_token()


def test_tree_map_checks_structure():
    with pytest.raises(ValueError, match="structures differ"):
        tree_map(lambda a, b: a, {"a": 1}, {"b": 1})
