"""Host offload of the optimizer state
(``FullyShardedDataParallelPlugin(cpu_offload=True)``).

Between imperative steps the state lies in host memory (pinned on a card;
on the CPU a copy of its own) and goes to the device only for the update,
so a run with offload is the same computation as one without: the tests
hold it bitwise. The model is the tiny Llama with the JAX package's
weights, batches numpy ids from a seed (8 x 16), ``adamw(3e-4)``, clip 1.0;
the offloaded loop is also held to the JAX package's offloaded loop (its
``host_offload``) on the 8-device CPU mesh at ``tests/test_torch_loop.py``'s
f32 pins (losses ``atol=1e-5``; parameters ``atol=5e-5``, Adam dividing by
sqrt(v) magnifies a sum-order difference where a gradient is near 0). One
gloo case runs the loop under fsdp 2 in two processes, offload against
none, bitwise.

This module imports JAX only inside the test that compares with it: the
ranks ``debug_launcher`` spawns import their worker from here.
"""

from pathlib import Path

import numpy as np
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.utils.tree import flatten_with_paths, tree_leaves

LOSS_ATOL, PARAM_ATOL = 1e-5, 5e-5
CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=2,
           num_key_value_heads=2, num_hidden_layers=2)


def _batches(n=4, B=8, S=16, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32)
        out.append({"input_ids": ids, "labels": ids})
    return out


def _start_params():
    model = T.Llama(T.LlamaConfig.tiny(**CFG), device="cpu")
    model.init_params(0)
    return {k: v.numpy() for k, v in flatten_with_paths(model.params)}


def _prepared(params, offload: bool, fsdp_size: int = 1, **acc_kw):
    acc = T.Accelerator(device="cpu", fsdp_plugin=T.FullyShardedDataParallelPlugin(
        fsdp_size=fsdp_size, cpu_offload=offload), **acc_kw)
    model = T.Llama(T.LlamaConfig.tiny(**CFG), device="cpu")
    model.init_params(0)
    for path, leaf in flatten_with_paths(model.params):
        leaf.copy_(torch.from_numpy(np.array(params[path])))
    pm, po = acc.prepare(model, T.adamw(3e-4, device="cpu"))
    return acc, pm, po


def _loop(acc, pm, po, batches, rows=slice(None)):
    losses = []
    for b in batches:
        out = pm(**{k: v[rows] for k, v in b.items()})
        acc.backward(out["loss"])
        acc.clip_grad_norm_(pm, 1.0)
        po.step()
        po.zero_grad()
        losses.append(out["loss"].detach().clone())
    return torch.stack(losses)


def _state_tensors(po):
    return [t for _, t in flatten_with_paths(po.opt_state) if isinstance(t, torch.Tensor)]


def test_offloaded_state_trains_bitwise_and_lives_apart():
    params = _start_params()
    acc, pm, po = _prepared(params, offload=False)
    want = _loop(acc, pm, po, _batches())
    acc2, pm2, po2 = _prepared(params, offload=True)
    assert po2.host_offload and not po.host_offload
    got = _loop(acc2, pm2, po2, _batches())
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pm.params), tree_leaves(pm2.params)))
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(po), _state_tensors(po2)))
    # Between steps the state lies in its own host buffers, which every step
    # refills in place (no new allocation a step).
    assert po2._on_host and not po._on_host
    held = [t.data_ptr() for t in _state_tensors(po2)]
    _loop(acc2, pm2, po2, _batches(1, seed=9))
    assert [t.data_ptr() for t in _state_tensors(po2)] == held
    # The fused step moves the state to the device once and keeps it there.
    step = acc2.build_train_step(pm2, po2)
    assert not po2._on_host
    step(_batches(1, seed=10)[0], clip_norm=1.0)
    assert not po2._on_host


def test_offloaded_resume_through_load_state_dict_is_bitwise():
    params, batches = _start_params(), _batches(4)
    acc, pm, po = _prepared(params, offload=True)
    want = _loop(acc, pm, po, batches)
    acc2, pm2, po2 = _prepared(params, offload=True)
    first = _loop(acc2, pm2, po2, batches[:2])
    saved_params = [p.clone() for p in tree_leaves(pm2.params)]
    sd = po2.state_dict()
    sd = dict(sd, opt_state=T.utils.tree.map_with_paths(
        lambda _, t: t.clone() if isinstance(t, torch.Tensor) else t, sd["opt_state"]))
    acc3, pm3, po3 = _prepared(params, offload=True)
    for leaf, src in zip(tree_leaves(pm3.params), saved_params):
        leaf.copy_(src)
    po3._ensure_initialized()
    po3.load_state_dict(sd)
    assert po3._on_host and po3._step_count == 2
    rest = _loop(acc3, pm3, po3, batches[2:])
    assert torch.equal(torch.cat([first, rest]), want)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pm.params), tree_leaves(pm3.params)))


def test_offloaded_loop_matches_jax_host_offload():
    import jax
    import optax

    from accelerate_tpu import Accelerator as JAccelerator
    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
    from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JPlugin

    jm = JLlama(JConfig.tiny(**CFG))
    jm.init_params(jax.random.key(0))
    params = {k.replace("/", "."): np.asarray(v) for k, v in _jax_paths(jm.params)}
    jacc = JAccelerator(fsdp_plugin=JPlugin(fsdp_size=1, cpu_offload=True))
    jpm, jpo = jacc.prepare(jm, optax.adamw(3e-4))
    assert jpo.host_offload
    want = []
    for b in _batches():
        out = jpm(**b)
        jacc.backward(out["loss"])
        jacc.clip_grad_norm_(jpm, 1.0)
        jpo.step()
        jpo.zero_grad()
        want.append(float(out["loss"]))
    acc, pm, po = _prepared(params, offload=True)
    got = _loop(acc, pm, po, _batches())
    np.testing.assert_allclose(got.numpy(), want, atol=LOSS_ATOL, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(jpm.handle.params), tree_leaves(pm.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=PARAM_ATOL, rtol=0)


def _jax_paths(tree):
    import jax

    from accelerate_tpu.parallel.sharding import path_str

    return [(path_str(p), v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def offload_worker(out_dir: str, params, batches):
    """One of 2 gloo ranks: the imperative loop under fsdp 2 on its rows,
    with and without offload; saves both runs' losses and whether its
    parameter shards and state agree bitwise."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    rows = slice(4 * rank, 4 * rank + 4)
    runs = []
    for offload in (False, True):
        acc, pm, po = _prepared(params, offload=offload, fsdp_size=2)
        losses = _loop(acc, pm, po, batches, rows)
        runs.append((losses, [p.clone() for p in tree_leaves(pm.params)],
                     [t.clone() for t in _state_tensors(po)], po._on_host))
    (l0, p0, s0, h0), (l1, p1, s1, h1) = runs
    np.savez(Path(out_dir) / f"rank{rank}.npz", losses=l1.numpy(),
             same=np.asarray(torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(p0, p1))
                             and all(torch.equal(a, b) for a, b in zip(s0, s1))),
             placed=np.asarray([h0, h1]), shard=np.asarray(len(p1)))


def test_offload_under_fsdp_over_two_gloo_ranks_is_bitwise(tmp_path):
    T.debug_launcher(offload_worker, args=(str(tmp_path), _start_params(), _batches(3)),
                     num_processes=2)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for saved in ranks:
        assert bool(saved["same"]) and saved["placed"].tolist() == [False, True]
        assert np.isfinite(saved["losses"]).all()


def test_new_entry_points_default_to_the_card():
    """Without ``device="cpu"`` this slice's entry points take the card and
    raise on a host without one; never a quiet fall to the CPU."""
    import types

    import pytest

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the defaults would run on it")
    for build in (
            lambda: T.Accelerator(mixed_precision="fp16"),
            lambda: T.Accelerator(mixed_precision="fp8", kwargs_handlers=[T.Fp8RecipeKwargs()]),
            lambda: T.Accelerator(fsdp_plugin=T.FullyShardedDataParallelPlugin(
                fsdp_size=1, cpu_offload=True)),
            lambda: T.DataLoaderDispatcher([{"x": np.zeros(2)}]),
            lambda: T.prepare_data_loader([{"x": np.zeros(2)}], dispatch_batches=True),
            lambda: T.DeviceBatchPrefetcher([{"x": np.zeros(2)}], window=2),
            lambda: T.Llama(T.LlamaConfig.tiny(rope_scaling={"rope_type": "yarn",
                                                             "factor": 2.0})),
            lambda: T.BertForSequenceClassification(T.BertConfig.tiny(remat=True)),
            # The tp and Ulysses entry points (the tp and Megatron plugins,
            # the mesh shape from the environment, Ulysses on a loopback).
            lambda: T.Accelerator(tp_plugin=T.TensorParallelPlugin(2),
                                  loopback=T.LoopbackShards(2)),
            lambda: T.Accelerator(megatron_plugin=T.MegatronStylePlugin(tp_size=2, fsdp_size=2),
                                  loopback=T.LoopbackShards(4)),
            lambda: T.Accelerator(sp_plugin=T.SequenceParallelPlugin(2, ring_attention=False),
                                  loopback=T.LoopbackShards(2)),
            # The pp entry points: the pipeline plugin and prepare_pippy's model.
            lambda: T.Accelerator(pp_plugin=T.PipelineParallelPlugin(pp_size=2)),
            lambda: T.prepare_pippy(T.Llama(T.LlamaConfig.tiny())),
            # The classic-GPT models and the Hugging Face state-dict converters.
            lambda: T.GPT2(T.GPT2Config.tiny()),
            lambda: T.GPTX(T.GPTXConfig.tiny()),
            lambda: T.opt_params_from_hf({}, T.GPTXConfig.tiny(position_style="learned")),
            lambda: T.from_hf(types.SimpleNamespace(config=types.SimpleNamespace(
                model_type="gpt2", vocab_size=128, n_embd=64, n_layer=2, n_head=4),
                state_dict=dict)),
            lambda: T.from_hf_checkpoint("gpt_neox", "missing", dict(
                vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_cpu_offload_from_the_environment(monkeypatch):
    """``ACCELERATE_FSDP_CPU_OFFLOAD`` turns offload on without a plugin (JAX
    ``accelerator.py:361-373``); on one process the axis stays 1."""
    monkeypatch.setenv("ACCELERATE_FSDP_CPU_OFFLOAD", "1")
    acc = T.Accelerator(device="cpu")
    assert acc.fsdp_plugin.cpu_offload and acc._offload_opt_state
    assert acc.mesh_sizes == {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1}
    model = T.Llama(T.LlamaConfig.tiny(**CFG), device="cpu")
    model.init_params(0)
    _, po = acc.prepare(model, T.adamw(3e-4, device="cpu"))
    assert po.host_offload
    monkeypatch.delenv("ACCELERATE_FSDP_CPU_OFFLOAD")
    assert not T.Accelerator(device="cpu")._offload_opt_state
