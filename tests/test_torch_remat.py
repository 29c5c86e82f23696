"""Remat (``LlamaConfig(remat=True)``) against the plain step and JAX's.

The port wraps each block in ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)`` with the JAX package's three policies: plain
checkpointing (``nothing_saveable``), the weight products kept
(``dots_with_no_batch_dims_saveable``), the tagged block outputs kept
(``names_saveable``). On the CPU, with the harness of
``tests/test_torch_train.py`` (its model, its batches, accumulation 2 over 4
micro-steps, and its pins: losses ``atol`` 1e-5, parameters ``atol`` 5e-5):

- each policy's step equals the plain step bitwise (a recomputed value
  equals the kept one);
- each agrees with JAX's step under the same ``remat_policy``;
- under fsdp 4 on ``LoopbackShards(4)``, remat (the layer gathered again
  inside the recomputed region) and ``reshard_after_forward`` (gathered
  weights dropped after the forward and gathered again for the backward)
  change no bit of the step, and the regathers happen;
- an unported policy name raises ``NotImplementedError`` naming ROADMAP.
"""

import numpy as np
import pytest
import torch

import jax
import optax

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig

import accelerate_tpu_torch as T
from accelerate_tpu_torch.parallel.fsdp import ShardedModel
from accelerate_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

SEED = 5
WIDTHS = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2)
LOSS_ATOL, PARAM_ATOL = 1e-5, 5e-5
POLICIES = ("nothing_saveable", "dots_with_no_batch_dims_saveable", "names_saveable")


def _start():
    jm = JLlama(JConfig.tiny(**WIDTHS))
    jm.init_params(jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, jm.params)


def _batches(n=4, B=8, S=128):
    rng = np.random.default_rng(SEED)
    return [{"input_ids": ids, "labels": ids} for ids in
            (rng.integers(0, 256, (B, S)).astype(np.int32) for _ in range(n))]


def _port_run(start, cfg_kw, acc_kw=None):
    acc = T.Accelerator(mixed_precision="no", device="cpu", gradient_accumulation_steps=2,
                        **(acc_kw or {}))
    model = T.Llama(T.LlamaConfig.tiny(attention_impl="flash", **WIDTHS, **cfg_kw), device="cpu")
    model.params = T.llama_params_from_numpy(start, model.config, device="cpu")
    pm, po = acc.prepare(model, T.adamw(3e-4, device="cpu"))
    step = acc.build_train_step(pm, po)
    losses = [step(b, clip_norm=1.0) for b in _batches()]
    engine = pm.handle.sharded
    params = ([engine.full_leaf(i) for i in range(len(engine.layouts))] if engine is not None
              else [p.clone() for p in tree_leaves(pm.params)])
    return torch.stack(losses), params


@pytest.fixture(scope="module")
def start():
    return _start()


@pytest.fixture(scope="module")
def plain(start):
    return _port_run(start, {})


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_step_equals_plain_step_bitwise(start, plain, policy):
    losses, params = _port_run(start, dict(remat=True, remat_policy=policy))
    assert torch.equal(losses, plain[0])
    assert all(torch.equal(a, b) for a, b in zip(params, plain[1]))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_step_matches_jax_remat_step(start, policy):
    jm = JLlama(JConfig.tiny(remat=True, remat_policy=policy, **WIDTHS))
    jm.init_params(jax.random.key(0))
    jacc = JAccelerator(mixed_precision="no", gradient_accumulation_steps=2)
    jpm, jpo = jacc.prepare(jm, optax.adamw(3e-4))
    jstep = jacc.build_train_step(jpm, jpo)
    want = [float(jstep(b, clip_norm=1.0)) for b in _batches()]
    losses, params = _port_run(start, dict(remat=True, remat_policy=policy))
    np.testing.assert_allclose(losses.numpy(), want, atol=LOSS_ATOL, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(jpm.handle.params), params):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=PARAM_ATOL, rtol=0)


@pytest.fixture(scope="module")
def fsdp_runs(start):
    """Loopback fsdp 4 with and without remat and reshard, and how many
    gathers each ran."""
    out = {}
    real_gather = ShardedModel.gather
    for name, cfg_kw, reshard in (("plain", {}, False), ("reshard", {}, True),
                                  ("remat", dict(remat=True), False)):
        calls = []

        def counting(self, *args, **kwargs):
            calls.append(args)
            return real_gather(self, *args, **kwargs)

        ShardedModel.gather = counting
        try:
            plugin = T.FullyShardedDataParallelPlugin(fsdp_size=4, reshard_after_forward=reshard)
            out[name] = _port_run(start, cfg_kw, dict(fsdp_plugin=plugin,
                                                      loopback=T.LoopbackShards(4)))
        finally:
            ShardedModel.gather = real_gather
        out[name] += (len(calls),)
    return out


@pytest.mark.parametrize("name", ["reshard", "remat"])
def test_fsdp_remat_and_reshard_change_no_bit(fsdp_runs, plain, name):
    losses, params, _ = fsdp_runs[name]
    assert torch.equal(losses, fsdp_runs["plain"][0])
    assert all(torch.equal(a, b) for a, b in zip(params, fsdp_runs["plain"][1]))
    # Sharded and unsharded agree as the JAX layouts do.
    np.testing.assert_allclose(losses.numpy(), plain[0].numpy(), atol=LOSS_ATOL, rtol=0)
    for a, b in zip(params, plain[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PARAM_ATOL, rtol=0)


def test_fsdp_gathers_again_for_the_backward(fsdp_runs):
    """Without reshard each rank gathers the 7 sharded block leaves a layer
    and the 2 vocab tables once a forward; reshard and remat gather the
    layers again for the backward."""
    ranks, layers, steps = 4, 2, 4
    once = steps * ranks * (7 * layers + 2)
    assert fsdp_runs["plain"][2] == once
    assert fsdp_runs["reshard"][2] > once
    assert fsdp_runs["remat"][2] == once + steps * ranks * 7 * layers


def test_unported_remat_policy_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.Llama(T.LlamaConfig.tiny(remat=True, remat_policy="everything_saveable"), device="cpu")
    with pytest.raises(ValueError, match="remat_save_names"):
        T.Llama(T.LlamaConfig.tiny(remat=True, remat_policy="names_saveable",
                                   remat_save_names=()), device="cpu")
    # Host offload of the optimizer state is ported: the plugin takes it.
    assert T.FullyShardedDataParallelPlugin(cpu_offload=True).cpu_offload
