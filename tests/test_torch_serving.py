"""Parity of the PyTorch port's paged ``ContinuousBatcher`` with the JAX engine.

The same seeded wave goes through the JAX ``ContinuousBatcher(paged=True,
kernels="interpret")`` (its Pallas gather kernel run by the interpreter, as
tests/test_kernels.py runs it) and through the port on the CPU (the plain
gather), on ``LlamaConfig.tiny()`` weights carried across with
``models/from_jax``: fp32 cache, block_size 4, a shared prefix, and a prompt
longer than the prefill chunk. Greedy outputs must be token-identical for
every request — the logits agree to ~1e-6, far below any argmax margin of
this wave — with both the fp32 pool and ``kv_quant="int8"`` (whose
quantizer is bitwise equal across the two packages). The remaining tests pin
the port's own contracts: the engine equals per-request ``generate()``,
eos/stop/per-request lengths, and traffic-independent sampled streams.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig
from accelerate_tpu.serving import ContinuousBatcher as JBatcher
from accelerate_tpu_torch import ContinuousBatcher, generate
from accelerate_tpu_torch.models import Llama, LlamaConfig, llama_params_from_numpy

torch.set_num_threads(2)

SEED = 2024
ENGINE = dict(batch_slots=2, max_new_tokens=6, max_cache_len=256, bucket_sizes=(8, 16),
              sync_every=2, block_size=4, max_tokens_per_request=64)


@pytest.fixture(scope="module")
def models():
    jm = JLlama(JConfig.tiny())
    jm.init_params(jax.random.key(0))
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.params = llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                        tm.config, device="cpu")
    return jm, tm


def _wave(seed=SEED):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 256, (10,)).astype(np.int32)
    # 10 + 20 tokens is longer than the 16-token prefill chunk.
    prompts = [rng.integers(1, 256, (n,)).astype(np.int32) for n in (20, 5, 3, 12, 7)]
    return prefix, prompts


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp32-pool", "int8-pool"])
def test_paged_engine_token_identical_to_jax_engine(models, kv_quant):
    jm, tm = models
    prefix, prompts = _wave()
    je = JBatcher(jm, paged=True, kernels="interpret", cache_dtype=jnp.float32,
                  kv_quant=kv_quant, **ENGINE)
    je.set_prefix(prefix)
    jr = [je.submit(p) for p in prompts]
    jout = je.run()
    te = ContinuousBatcher(tm, cache_dtype=torch.float32, kv_quant=kv_quant, device="cpu",
                           **ENGINE)
    te.set_prefix(prefix)
    tr = [te.submit(p) for p in prompts]
    tout = te.run()
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(tout[b], jout[a])
    stats = te.pool_stats()
    assert stats["blocks_free"] == stats["num_blocks"] == te.num_blocks
    assert stats["kv_quant"] == kv_quant
    decisions = te.slo_report()["decisions"]
    assert decisions["chunked_prefills"] >= 1
    assert decisions["aliased_blocks"] == je.slo_report()["decisions"]["aliased_blocks"] > 0
    assert te._dispatch_log == je._dispatch_log


def test_paged_engine_equals_per_request_generate(models):
    _, tm = models
    prefix, prompts = _wave(SEED + 1)
    te = ContinuousBatcher(tm, cache_dtype=torch.float32, device="cpu", **ENGINE)
    te.set_prefix(prefix)
    rids = [te.submit(p) for p in prompts]
    out = te.run()
    for rid, p in zip(rids, prompts):
        ref = generate(tm, np.concatenate([prefix, p])[None], max_new_tokens=6,
                       cache_dtype=torch.float32, include_prompt=False, device="cpu")
        np.testing.assert_array_equal(out[rid], ref[0].numpy())
    # A second wave on the same engine reuses the freed pool.
    rid = te.submit(prompts[1])
    assert np.array_equal(te.run()[rid], out[rids[1]])
    assert te.pool_stats()["blocks_free"] == te.num_blocks


def test_eos_stop_sequences_and_per_request_lengths(models):
    _, tm = models
    _, prompts = _wave(SEED + 2)
    te = ContinuousBatcher(tm, cache_dtype=torch.float32, device="cpu", **ENGINE)
    full = {te.submit(p): p for p in prompts[:3]}
    base = te.run()
    (r0, p0), (r1, p1), (r2, p2) = full.items()
    eos = int(base[r0][2])
    stop = base[r1][1:3]
    a = te.submit(p0, eos_token_id=eos)
    b = te.submit(p1, stop_sequences=[stop])
    c = te.submit(p2, max_new_tokens=3)
    out = te.run()
    cut = int(np.argmax(base[r0] == eos)) + 1
    np.testing.assert_array_equal(out[a], base[r0][:cut])
    np.testing.assert_array_equal(out[b], base[r1][:3])
    np.testing.assert_array_equal(out[c], base[r2][:3])


def test_sampled_streams_depend_only_on_seed_and_request_id(models):
    _, tm = models
    _, prompts = _wave(SEED + 3)

    def run(order, seed=0):
        te = ContinuousBatcher(tm, cache_dtype=torch.float32, device="cpu", seed=seed,
                               temperature=1.0, top_k=20, **ENGINE)
        for i in order:
            te.submit(prompts[i], request_id=10 + i)
        return te.run()

    a, b = run([0, 1, 2, 3]), run([3, 1, 0])
    for i in (0, 1, 3):
        np.testing.assert_array_equal(a[10 + i], b[10 + i])
    assert any(not np.array_equal(a[10 + i], run([i], seed=1)[10 + i]) for i in (0, 1))


def test_capacity_and_submit_validation(models):
    _, tm = models
    te = ContinuousBatcher(tm, cache_dtype=torch.float32, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="max_tokens_per_request"):
        te.submit(np.ones(70, np.int32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        te.submit(np.ones(3, np.int32), max_new_tokens=7)
    te.submit(np.ones(3, np.int32), request_id=5)
    with pytest.raises(ValueError, match="already in use"):
        te.submit(np.ones(3, np.int32), request_id=5)
    small = ContinuousBatcher(tm, cache_dtype=torch.float32, device="cpu",
                              **{**ENGINE, "max_cache_len": 16})
    small.submit(np.ones(12, np.int32))
    with pytest.raises(RuntimeError, match="capacity exhausted"):
        small.run()
