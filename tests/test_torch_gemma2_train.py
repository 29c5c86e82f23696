"""Parity of Gemma-2 training in the port with the JAX package's: the slice as a whole.

A small Gemma-2 goes through both packages' ``gemma2_config_from_hf`` from
one dict: 2 layers (one local, window 64, and one global), width 64, 4 heads
over 2 KV heads of 128, ``max_position_embeddings`` 256, vocabulary 500,
softcaps 50 and 30, ``query_pre_attn_scalar`` 128; then
``attention_impl="splash"`` and ``fused_loss=True`` with a chunk of 128
(three full chunks and a ragged tail of 116). Weights start from the JAX
package's init and cross with ``llama_params_from_numpy``. Both packages
take three ``adamw(3e-4)`` steps with ``clip_norm=1.0`` on the same batches
of 8 x 256 seeded ids (8 rows for the JAX side's 8-device CPU mesh of
``tests/conftest.py``), the second batch with right padding.

The JAX side's splash attention is its real path: ``attention`` routes to
``splash_attention``, which builds the library kernel with
``make_splash_mha``. The test lets it run on the CPU by patching, in the
test only, ``_splash_available`` (it asks for a TPU backend) and
``make_splash_mha`` (to ``interpret=True``). The port runs its plain splash
version on the CPU; ``ACCELERATE_FUSED_LOSS_*`` variables are cleared so the
JAX side takes its config's fused-loss fields, as the port does.

Tolerances, with their reasons (the train test's pins): fp32 on the CPU in
both, sums in another order, so ``atol=1e-5`` on the losses (about 6.3) and
``atol=5e-5`` on the parameters after three steps (Adam divides by sqrt(v),
which magnifies relative gradient differences where a gradient element is
near zero).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import optax
from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_kernel as sk

import accelerate_tpu.ops.attention as j_attention
from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models.convert import gemma2_config_from_hf as j_gemma2_config_from_hf
from accelerate_tpu.models.llama import Llama as JLlama

import accelerate_tpu_torch as T
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

SEED = 23
LOSS_ATOL, PARAM_ATOL = 1e-5, 5e-5
TINY_GEMMA2 = dict(
    model_type="gemma2", vocab_size=500, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=128,
    max_position_embeddings=256, rms_norm_eps=1e-6, rope_theta=10000.0, sliding_window=64,
    query_pre_attn_scalar=128, attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
    hidden_activation="gelu_pytorch_tanh",
)
TRAIN = dict(attention_impl="splash", fused_loss=True, fused_loss_chunk=128)


@pytest.fixture
def jax_splash_on_cpu(monkeypatch):
    """Returns the names of the masks the library kernel was built with."""
    built = []
    interpret = functools.partial(sk.make_splash_mha, interpret=True)

    def make_splash_mha(mask, **kw):
        built.append(type(mask.masks[0]).__name__)
        return interpret(mask, **kw)

    monkeypatch.setattr(j_attention, "_splash_available", lambda: True)
    monkeypatch.setattr(sk, "make_splash_mha", make_splash_mha)
    for knob in ("CHUNK", "DTYPE", "UNROLL", "BACKWARD"):
        monkeypatch.delenv(f"ACCELERATE_FUSED_LOSS_{knob}", raising=False)
    return built


def _batches():
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(3):
        ids = rng.integers(0, TINY_GEMMA2["vocab_size"], (8, 256)).astype(np.int32)
        batch = {"input_ids": ids, "labels": ids}
        if i == 1:
            mask = np.ones_like(ids)
            mask[::2, -40:] = 0
            batch["attention_mask"] = mask
        out.append(batch)
    return out


def test_gemma2_train_steps_match_jax(jax_splash_on_cpu):
    jcfg = dataclasses.replace(j_gemma2_config_from_hf(TINY_GEMMA2), **TRAIN)
    cfg = dataclasses.replace(T.gemma2_config_from_hf(TINY_GEMMA2), **TRAIN)
    assert cfg.layer_windows == jcfg.layer_windows == (64, None)
    jm = JLlama(jcfg)
    jm.init_params(jax.random.key(0))
    tm = T.Llama(cfg, device="cpu")
    tm.params = T.llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params), cfg,
                                          device="cpu")

    jacc = JAccelerator(mixed_precision="no")
    jpm, jpo = jacc.prepare(jm, optax.adamw(3e-4))
    jstep = jacc.build_train_step(jpm, jpo)
    acc = T.Accelerator(mixed_precision="no", device="cpu")
    pm, po = acc.prepare(tm, T.adamw(3e-4, device="cpu"))
    step = acc.build_train_step(pm, po)
    registry.reset_launch_counts()
    for batch in _batches():
        want = float(jstep(batch, clip_norm=1.0))
        got = float(step(batch, clip_norm=1.0))
        assert abs(got - want) <= LOSS_ATOL, (got, want)
    assert registry.launch_counts == {}  # CPU tensors: plain versions only
    assert set(jax_splash_on_cpu) == {"LocalMask", "CausalMask"}  # the JAX side ran splash
    jleaves, leaves = jax.tree_util.tree_leaves(jpm.handle.params), tree_leaves(pm.params)
    assert len(jleaves) == len(leaves) == 13
    for a, b in zip(jleaves, leaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=PARAM_ATOL, rtol=0)


def test_gemma2_fused_head_matches_unfused_head():
    """The fused head returns the loss without logits; the loss equals the
    unfused head's, which returns the softcapped logits."""
    cfg = T.gemma2_config_from_hf(TINY_GEMMA2)
    tm = T.Llama(dataclasses.replace(cfg, attention_impl="dense"), device="cpu")
    tm.init_params(SEED)
    fused = T.Llama(dataclasses.replace(cfg, attention_impl="dense", fused_loss=True,
                                        fused_loss_chunk=128), device="cpu")
    ids = torch.tensor(_batches()[0]["input_ids"][:2, :64])
    plain = tm.apply(tm.params, input_ids=ids, labels=ids)
    out = fused.apply(tm.params, input_ids=ids, labels=ids)
    assert "logits" not in out and "logits" in plain
    assert plain["logits"].abs().max() <= 30.0
    torch.testing.assert_close(out["loss"], plain["loss"], atol=1e-5, rtol=0)
