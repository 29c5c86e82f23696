"""The fp16 loss scaler (``optimizer.GradScalerState``) and fp16 training
against the JAX package's.

The model is ``tests/test_torch_train.py``'s small Llama (head_dim 64, GQA)
at 8 x 128 (the JAX side trains on the 8-device CPU mesh), weights from the
JAX package's init, batches numpy ids from a seed, ``adamw(3e-4)``, clip
1.0. Both sides run ``mixed_precision="fp16"`` from a scale of 2**24 with a
growth interval of 2, so the first steps overflow and are skipped, the scale
halves to 2**20, where steps apply and the scale grows. Tolerances, with
their reasons:

- skip decisions and scales: exact (the scale is a host float, halved or
  doubled by the same rule on the same decisions);
- losses: ``atol=2e-4`` (about 6; both compute in fp16 on the CPU, XLA and
  PyTorch rounding the fp16 products and activations at other places, each
  a relative 2**-11; 1.4e-4 seen);
- parameters: ``atol`` of two learning-rate steps per applied update: Adam
  divides by sqrt(v), so an element whose gradient sits at the fp16
  rounding level can take a step of the other sign (up to 2 lr apart; 9.8e-4
  seen after 2 updates); and 99% of the elements within ``1e-5`` (a
  thirtieth of one step; 3.7e-6 seen), so the sign flips stay rare;
- the imperative loop against the fused step of the port: bitwise (one
  computation, two schedules).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import optax

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
from accelerate_tpu.optimizer import GradScalerState as JScaler

import accelerate_tpu_torch as T
from accelerate_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

SEED = 5
WIDTHS = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2)
LR, INIT_SCALE, GROWTH = 3e-4, 2.0**24, 2
LOSS_ATOL = 2e-4


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


def _set_scaler(scaler):
    scaler.scale, scaler.growth_interval = INIT_SCALE, GROWTH


def test_scaler_backoff_and_growth_match_jax():
    flags = [True, False, False, False, True, False, False, False, False, True]
    for kw in ({}, dict(init_scale=8.0, growth_factor=3.0, backoff_factor=0.25,
                        growth_interval=3)):
        want, got = JScaler(**kw), T.GradScalerState(**kw)
        assert got.scale == want.scale == kw.get("init_scale", 2.0**15)
        for found_inf in flags:
            want.update(found_inf)
            got.update(found_inf)
            assert got.scale == want.scale and got._good_steps == want._good_steps
        assert float(got.inv_scale("cpu")) == np.float32(1.0 / want.scale)


def _port_loop(tm, fused: bool):
    acc = T.Accelerator(mixed_precision="fp16", device="cpu")
    pm, po = acc.prepare(tm, T.adamw(LR, device="cpu"))
    _set_scaler(acc.scaler)
    step = acc.build_train_step(pm, po) if fused else None
    losses, record = [], []
    for batch in _batches(6):
        if fused:
            loss = step(batch, clip_norm=1.0)
        else:
            out = pm(**batch)
            acc.backward(out["loss"])
            acc.clip_grad_norm_(pm, 1.0)
            po.step()
            po.zero_grad()
            loss = out["loss"].detach()
        losses.append(float(loss))
        record.append((po.step_was_skipped, acc.scaler.scale))
    return losses, record, pm, po


def test_fp16_run_matches_jax_over_6_steps():
    """JAX's fp16 imperative loop (the one with the scaler) against the
    port's loop and the port's fused step: the same skips and scales, and
    the losses and parameters at the pins."""
    jm, tm = _models()
    jacc = JAccelerator(mixed_precision="fp16")
    jpm, jpo = jacc.prepare(jm, optax.adamw(LR))
    _set_scaler(jacc.scaler)
    want_losses, want_record = [], []
    for batch in _batches(6):
        out = jpm(**batch)
        jacc.backward(out["loss"])
        jacc.clip_grad_norm_(jpm, 1.0)
        jpo.step()
        jpo.zero_grad()
        want_losses.append(float(out["loss"]))
        want_record.append((jpo.step_was_skipped, jacc.scaler.scale))
    skipped = [s for s, _ in want_record]
    assert skipped[:2] == [True, True] and not skipped[-1]  # both regimes are exercised
    applied = skipped.count(False)
    loop = _port_loop(tm, fused=False)
    _, tm2 = _models()
    fused = _port_loop(tm2, fused=True)
    for losses, record, pm, po in (loop, fused):
        assert record == want_record
        np.testing.assert_allclose(losses, want_losses, atol=LOSS_ATOL, rtol=0)
        assert po.skipped_steps == skipped.count(True)
        diffs = np.concatenate([
            np.abs(b.numpy() - np.asarray(a)).ravel()
            for a, b in zip(jax.tree_util.tree_leaves(jpm.handle.params), tree_leaves(pm.params))])
        assert diffs.max() <= 2 * LR * applied
        assert np.quantile(diffs, 0.99) <= 1e-5
    assert loop[0] == fused[0]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loop[2].params),
                                                 tree_leaves(fused[2].params)))
    assert int(loop[3].opt_state[0].count) == int(jpo.opt_state[0].count) == applied


@pytest.mark.parametrize("fused", [False, True])
def test_overflow_step_is_skipped_and_the_scale_halves(fused):
    """A step whose scaled gradients overflow fp16 changes no parameter and
    no moment, counts as skipped, drops the buffer and halves the scale;
    the next step at the halved scale applies."""
    _, tm = _models()
    acc = T.Accelerator(mixed_precision="fp16", device="cpu")
    pm, po = acc.prepare(tm, T.adamw(LR, device="cpu"))
    acc.scaler.scale = 2.0**60  # every fp16 gradient overflows
    step = acc.build_train_step(pm, po) if fused else None
    before = [p.clone() for p in tree_leaves(pm.params)]
    batch = _batches(1)[0]
    if fused:
        loss = step(batch, clip_norm=1.0)
    else:
        out = pm(**batch)
        acc.backward(out["loss"])
        po.step()
        loss = out["loss"]
    assert bool(torch.isfinite(loss))  # the loss is f32; only the fp16 gradients overflow
    assert po.step_was_skipped and po.skipped_steps == 1 and acc.scaler.scale == 2.0**59
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(pm.params)))
    assert int(po.opt_state[0].count) == 0 and po._step_count == 0
    assert all(bool((m == 0).all()) for m in tree_leaves(po.opt_state[0].mu))
    if fused:
        assert all(bool((g == 0).all()) for g in tree_leaves(po.grads))
    else:
        assert po.grads is None
    acc.scaler.scale = 2.0**10
    if fused:
        step(batch, clip_norm=1.0)
    else:
        po.zero_grad()
        out = pm(**batch)
        acc.backward(out["loss"])
        po.step()
    assert not po.step_was_skipped and int(po.opt_state[0].count) == 1
    assert not all(torch.equal(a, b) for a, b in zip(before, tree_leaves(pm.params)))


def test_scale_round_trips_through_save_state_and_a_jax_meta(tmp_path):
    """The scale goes to ``optimizer.meta.pkl`` as the JAX package writes
    it and comes back from the port's file and from one the JAX package
    wrote (its ``save_state`` of a fp16 accelerator)."""
    jm, tm = _models()
    acc = T.Accelerator(mixed_precision="fp16", device="cpu")
    pm, po = acc.prepare(tm, T.adamw(LR, device="cpu"))
    acc.scaler.scale = 512.0
    path = acc.save_state(str(tmp_path / "port"))
    with open(os.path.join(path, "optimizer.meta.pkl"), "rb") as f:
        assert pickle.load(f) == {"step_count": 0, "scale": 512.0}
    assert po.state_dict()["scale"] == 512.0
    acc.scaler.scale = 1.0
    acc.load_state(path)
    assert acc.scaler.scale == 512.0
    jacc = JAccelerator(mixed_precision="fp16")
    jpm, jpo = jacc.prepare(jm, optax.adamw(LR))
    jacc.scaler.scale = 2048.0
    jpath = str(tmp_path / "jax")
    jacc.save_state(jpath)
    jacc.wait_for_everyone()
    with open(os.path.join(jpath, "optimizer.meta.pkl"), "rb") as f:
        jmeta = pickle.load(f)
    assert jmeta["scale"] == 2048.0
    with open(os.path.join(path, "optimizer.meta.pkl"), "wb") as f:
        pickle.dump(jmeta, f)
    acc.load_state(path)
    assert acc.scaler.scale == 2048.0
    # A state dict carries the scale too.
    po.load_state_dict(dict(po.state_dict(), scale=4096.0))
    assert acc.scaler.scale == 4096.0
