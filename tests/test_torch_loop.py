"""The canonical Accelerate loop of the port against the JAX package's.

``examples/nlp_example.py``'s loop, driven the same way on both sides:
``prepare(train_dl)``, then ``prepare(model, optimizer, schedule)``, and per
batch ``with accumulate(model): model(**batch); backward(loss);
clip_grad_norm_ (on sync steps); optimizer.step(); scheduler.step();
zero_grad()``. A tiny BERT (the JAX package's weights, carried across with
``bert_params_from_numpy``), the example's key-match data (sequence 16,
vocabulary 128), 13 batches of 8 an epoch over two epochs (the JAX side
trains on the 8-device CPU mesh of ``tests/conftest.py``, so the batch
divides 8), accumulation 2 (the 13th batch of an epoch closes its window on
its own: the loader's end syncs), clip 1.0. Both loaders draw the torch
``RandomSampler`` order from the same torch seed, so they see the same
indices.

- The example as written, ``inject_hyperparams(adamw)`` with a
  ``linear_schedule``: the reference chain on both sides (no plan).
- A constant ``adamw``: the JAX package's imperative path runs its
  reference chain (no kernel spec), the port's runs the fused update's plain
  version (a CPU tensor), which is optax's op order.

Tolerances, with their reasons. f32 on the CPU on both sides, sums in
another order, and JAX's update is one jitted program that XLA fuses:

- per-step losses: ``atol=1e-5`` (losses are about 0.7);
- the learning rate after every scheduler step: bitwise (the schedule's f32
  value, read on the host by both);
- final parameters: ``atol=5e-5`` (Adam divides by ``sqrt(v)``, which
  magnifies a rounding difference where a gradient element is near zero);
- the count of applied updates and ``step_was_skipped``: exact.
"""


import numpy as np
import pytest
import torch

import jax
import optax

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models.bert import BertConfig as JConfig
from accelerate_tpu.models.bert import BertForSequenceClassification as JBert

import accelerate_tpu_torch as T
from accelerate_tpu_torch.examples import nlp_example
from accelerate_tpu_torch.examples.nlp_example import get_dataloaders
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

LOSS_ATOL, PARAM_ATOL = 1e-5, 5e-5
VOCAB, BATCH, TRAIN, EPOCHS, ACCUM, LR = 128, 8, 104, 2, 2, 1e-3


def _jax_model():
    jm = JBert(JConfig.tiny(vocab_size=VOCAB, max_position_embeddings=16,
                            hidden_dropout_prob=0.0))
    jm.init_params(jax.random.key(11))
    return jm


def _loop(acc, model, optimizer, make_schedule, steps_of):
    """The loop, on either package; returns losses, learning rates, the
    prepared model and optimizer."""
    train_dl, _ = get_dataloaders(BATCH, VOCAB, train_size=TRAIN, eval_size=8)
    train_dl = acc.prepare(train_dl)
    schedule = make_schedule(EPOCHS * len(train_dl))
    prepared = acc.prepare(model, optimizer, schedule) if schedule is not None else (
        *acc.prepare(model, optimizer), None)
    pm, po, sched = prepared
    losses, lrs, syncs = [], [], []
    for epoch in range(EPOCHS):
        pm.train()
        train_dl.set_epoch(epoch)
        torch.manual_seed(500 + epoch)  # the shuffle order
        for batch in train_dl:
            with acc.accumulate(pm):
                out = pm(**batch)
                acc.backward(out["loss"])
                if acc.sync_gradients:
                    acc.clip_grad_norm_(pm, 1.0)
                po.step()
                if sched is not None:
                    sched.step()
                po.zero_grad()
            syncs.append(acc.sync_gradients)
            losses.append(float(np.asarray(steps_of(out["loss"]))))
            lrs.append(po.learning_rate)
    return losses, lrs, syncs, pm, po


def _both(jax_tx, port_tx, make_schedule):
    jm = _jax_model()
    tm = T.BertForSequenceClassification(
        T.BertConfig.tiny(vocab_size=VOCAB, max_position_embeddings=16, hidden_dropout_prob=0.0),
        device="cpu")
    tm.params = T.bert_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                         tm.config, device="cpu")
    jacc = JAccelerator(mixed_precision="no", gradient_accumulation_steps=ACCUM)
    want = _loop(jacc, jm, jax_tx, make_schedule(optax), lambda x: x)
    acc = T.Accelerator(cpu=True, gradient_accumulation_steps=ACCUM)
    registry.reset_launch_counts()
    got = _loop(acc, tm, port_tx, make_schedule(T), lambda x: x.detach())
    return want, got


def _check(want, got):
    wl, wlr, wsync, jpm, jpo = want
    gl, glr, gsync, pm, po = got
    assert gsync == wsync and gsync.count(True) == EPOCHS * 7
    np.testing.assert_allclose(gl, wl, atol=LOSS_ATOL, rtol=0)
    assert glr == wlr
    jleaves = jax.tree_util.tree_leaves(jpm.handle.params)
    assert len(jleaves) == 25
    for a, b in zip(jleaves, tree_leaves(pm.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=PARAM_ATOL, rtol=0)
    assert po._step_count == jpo._step_count == EPOCHS * 7
    assert po.step_was_skipped is jpo.step_was_skipped is False
    assert registry.launch_counts == {}  # CPU tensors run the plain versions


def test_example_loop_with_inject_hyperparams_and_linear_schedule_matches_jax():
    want, got = _both(optax.inject_hyperparams(optax.adamw)(learning_rate=LR),
                      T.inject_hyperparams(T.adamw)(learning_rate=LR, device="cpu"),
                      lambda m: lambda n: m.linear_schedule(LR, 0.1 * LR, n // ACCUM + 1))
    _check(want, got)
    assert got[4].plan is None
    assert len(set(got[1])) > 10  # the learning rate moved every update


def test_constant_adamw_loop_runs_the_fused_update_plain_version_and_matches_jax():
    want, got = _both(optax.adamw(LR), T.adamw(LR, device="cpu"), lambda m: lambda n: None)
    _check(want, got)
    assert got[4].plan is not None and got[4].plan.describe() == "adamw"
    assert got[1] == [None] * len(got[1])  # no inject_hyperparams state to read


def test_port_example_learns_on_the_cpu(capsys):
    """The port's example, as ``tests/test_examples.py::test_nlp_example``
    runs the JAX package's: five epochs, accuracy > 0.8 (the example
    asserts it)."""
    acc = nlp_example.main(["--cpu", "--num_epochs", "5"])
    assert acc > 0.8
    assert "epoch 4: accuracy" in capsys.readouterr().out


def _tiny(device="cpu"):
    model = T.BertForSequenceClassification(T.BertConfig.tiny(hidden_dropout_prob=0.0),
                                            device=device)
    model.init_params(0)
    return model


def test_prepare_classifies_as_jax_does():
    acc = T.Accelerator(cpu=True)
    assert acc.device.type == "cpu"
    loader = torch.utils.data.DataLoader(list(range(8)), batch_size=4)
    thing = object()
    pm, po, dl, sched, other = acc.prepare(_tiny(), T.adamw(1e-3, device="cpu"), loader,
                                           T.linear_schedule(1e-3, 0.0, 10), thing)
    assert po.handle is pm.handle and sched.optimizers == [po] and other is thing
    assert isinstance(dl, T.data_loader.DataLoaderShard) and len(dl) == 2
    assert acc.prepare(dl) is dl
    with pytest.raises(TypeError, match="does not look like an LR schedule"):
        acc.prepare(lambda outputs, batch: 0.0)
    with pytest.raises(NotImplementedError, match="torch.nn.Module"):
        acc.prepare(torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="contradicts"):
        T.Accelerator(cpu=True, device="cuda")


def test_backward_and_step_bookkeeping():
    acc = T.Accelerator(cpu=True, gradient_accumulation_steps=2)
    pm, po = acc.prepare(_tiny(), T.adamw(1e-3, device="cpu"))
    ids = np.random.default_rng(0).integers(0, 512, (2, 8)).astype(np.int32)
    batch = {"input_ids": ids, "labels": np.array([0, 1], np.int32)}
    with pytest.raises(RuntimeError, match="found no gradients"):
        acc.backward(torch.zeros(()))
    before = [p.clone() for p in tree_leaves(pm.params)]
    with acc.accumulate(pm):
        out = pm(**batch)
        acc.backward(out["loss"])
        po.step()  # not a sync step: no update
    assert not acc.sync_gradients and po.grads is not None
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(pm.params)))
    with acc.accumulate(pm):
        acc.backward(pm(**batch)["loss"])
        norm = acc.clip_grad_norm_(pm, 0.5)
        po.step()
        po.zero_grad()
    assert acc.sync_gradients and po.grads is None and po._step_count == 1
    assert float(norm) > 0 and not po.step_was_skipped
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(pm.params)))
    pm.eval()
    out = pm(**batch)
    assert out["logits"].grad_fn is None and pm.handle.pending is None
    assert acc.unwrap_model(pm) is pm.module


def test_non_finite_norm_skips_the_update_as_jax_does():
    acc = T.Accelerator(cpu=True)
    pm, po = acc.prepare(_tiny(), T.adamw(1e-3, device="cpu"))
    ids = np.random.default_rng(1).integers(0, 512, (2, 8)).astype(np.int32)
    acc.backward(pm(input_ids=ids, labels=np.array([1, 0], np.int32))["loss"])
    tree_leaves(po.grads)[0].view(-1)[0] = float("nan")
    before = [p.clone() for p in tree_leaves(pm.params)]
    po.step()
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(pm.params)))
    # As in the JAX package without the fp16 scaler: counted, not flagged.
    assert po._step_count == 1 and po.step_was_skipped is False


def test_imperative_path_refuses_sequence_parallelism():
    """Under sp the imperative path trains (tests/test_torch_ulysses.py runs
    it over gloo) and refuses what the JAX package refuses at ``prepare``
    (``accelerator.py:850-876``): a logit softcap, a sliding window, per-layer
    windows. Loaders prepare under sp."""
    from accelerate_tpu import ParallelismConfig as JParallelismConfig
    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JLlamaConfig
    from accelerate_tpu.state import AcceleratorState, GradientState

    refused = [(dict(attn_logit_softcap=50.0), "softcap"), (dict(sliding_window=4), "sliding"),
               (dict(layer_windows=(4, None)), "per-layer")]
    for kw, match in refused:
        acc = T.Accelerator(cpu=True, sp_plugin=T.SequenceParallelPlugin(2),
                            loopback=T.LoopbackShards(2))
        model = T.Llama(T.LlamaConfig.tiny(**kw), device="cpu")
        model.init_params(0)
        with pytest.raises(ValueError, match=match):
            acc.prepare(model, T.adamw(1e-3, device="cpu"))
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        try:
            jacc = JAccelerator(parallelism_config=JParallelismConfig(sp_size=2, dp_size=4))
            jm = JLlama(JLlamaConfig.tiny(**kw))
            jm.init_params(jax.random.key(0))
            with pytest.raises(ValueError, match=match):
                jacc.prepare(jm, optax.adamw(1e-3))
        finally:
            AcceleratorState._reset_state(reset_partial_state=True)
            GradientState._reset_state()
    acc = T.Accelerator(cpu=True, sp_plugin=T.SequenceParallelPlugin(2),
                        loopback=T.LoopbackShards(2))
    model = T.Llama(T.LlamaConfig.tiny(), device="cpu")
    model.init_params(0)
    pm, _ = acc.prepare(model, T.adamw(1e-3, device="cpu"))
    assert pm.module.config.attention_impl == "ring"
    with pytest.raises(NotImplementedError, match="build_train_step"):
        pm(input_ids=np.ones((1, 4), np.int32))  # a loopback holds every rank
    dl = acc.prepare(torch.utils.data.DataLoader(list(range(4)), batch_size=2))
    assert [b.tolist() for b in dl] == [[0, 1], [2, 3]]


def test_gather_for_metrics_trims_the_padded_tail_on_one_rank():
    acc = T.Accelerator(cpu=True)
    _, eval_dl = get_dataloaders(16, VOCAB, train_size=16, eval_size=40, eval_drop_last=False)
    eval_dl = acc.prepare(eval_dl)
    sizes = [len(acc.gather_for_metrics(batch["labels"].numpy())) for batch in eval_dl]
    assert sizes == [16, 16, 8] and eval_dl.remainder == 8
