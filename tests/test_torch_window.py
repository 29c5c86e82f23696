"""``Accelerator.build_train_window`` and ``DeviceBatchPrefetcher`` (the
port's ``tests/test_window.py``).

The model is a tiny Llama from a seed, batches numpy ids from a seed
(4 x 16), ``adamw(3e-4)``, clip 1.0. A window of K steps is K calls of the
``build_train_step`` step on the K slices of a stacked batch, so windows of
1 and 8 are held bitwise to the unwindowed steps (losses, parameters,
moments), with accumulation 1 and 2; one case holds the windowed run to the
JAX package's ``build_train_window`` on the 8-device CPU mesh at
``tests/test_torch_train.py``'s f32 pins (losses ``atol=1e-5``,
parameters ``atol=5e-5``). The prefetcher cases are the JAX package's
(``tests/test_window.py:212-453``) on the CPU, where every leaf is a host
leaf: zero blocking waits when the producer keeps ahead, counted waits when
it starves, windows stacked and the tail dropped, the consumer's position
and epoch identity in ``state_dict`` (resume bitwise mid-epoch, at an epoch
tail, after a stale identity), a quiet exit when abandoned.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.data_loader import DeviceBatchPrefetcher, prepare_data_loader
from accelerate_tpu_torch.utils.tree import flatten_with_paths, tree_leaves

torch.set_num_threads(2)

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=2,
           num_key_value_heads=2, num_hidden_layers=2)


def _batch(step, B=4, S=16):
    ids = np.random.default_rng(100 + step).integers(0, CFG["vocab_size"], (B, S))
    ids = ids.astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _build(accum: int = 1, **model_kw):
    acc = T.Accelerator(device="cpu", gradient_accumulation_steps=accum)
    model = T.Llama(T.LlamaConfig.tiny(**CFG, **model_kw), device="cpu")
    model.init_params(0)
    pm, po = acc.prepare(model, T.adamw(3e-4, device="cpu"))
    return acc, pm, po


def _state(pm, po):
    return ([p.clone() for p in tree_leaves(pm.params)],
            [t.clone() for _, t in flatten_with_paths(po.opt_state)
             if isinstance(t, torch.Tensor)])


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("window", [1, 8])
def test_window_is_bitwise_the_unwindowed_steps(window, accum):
    steps = 16
    acc, pm, po = _build(accum)
    step = acc.build_train_step(pm, po)
    want = torch.stack([step(_batch(s), clip_norm=1.0) for s in range(steps)])
    acc2, pm2, po2 = _build(accum)
    w = acc2.build_train_window(pm2, po2, window=window)
    assert w.window == window == acc2.train_window
    got = torch.cat([w(_stack([_batch(s) for s in range(i, i + window)]), clip_norm=1.0)
                     for i in range(0, steps, window)])
    assert got.shape == (steps,) and torch.equal(got, want)
    assert _same(_state(pm, po), _state(pm2, po2))
    assert int(po2.opt_state[0].count) == steps // accum


def test_window_matches_jax_build_train_window():
    import jax
    import optax

    from accelerate_tpu import Accelerator as JAccelerator
    from accelerate_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig

    jm = JLlama(JConfig.tiny(**CFG))
    jm.init_params(jax.random.key(0))
    jacc = JAccelerator()
    jpm, jpo = jacc.prepare(jm, optax.adamw(3e-4))
    jw = jacc.build_train_window(jpm, jpo, window=4)
    acc = T.Accelerator(device="cpu")
    model = T.Llama(T.LlamaConfig.tiny(**CFG), device="cpu")
    model.params = T.llama_params_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                             model.config, device="cpu")
    pm, po = acc.prepare(model, T.adamw(3e-4, device="cpu"))
    w = acc.build_train_window(pm, po, window=4)
    for i in range(2):
        batch = _stack([_batch(s, B=8) for s in range(4 * i, 4 * i + 4)])
        np.testing.assert_allclose(w(batch, clip_norm=1.0).numpy(),
                                   np.asarray(jw(batch, clip_norm=1.0)), atol=1e-5, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(jpm.handle.params), tree_leaves(pm.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-5, rtol=0)


def test_window_config_checks(monkeypatch):
    acc, pm, po = _build()
    w = acc.build_train_window(pm, po, window=2)
    with pytest.raises(ValueError, match="leading K axis"):
        w(_batch(0))
    acc.train_window = 3
    with pytest.raises(RuntimeError, match="train_window changed"):
        w(_stack([_batch(0), _batch(1)]))
    with pytest.raises(ValueError, match=">= 1"):
        acc.build_train_window(pm, po, window=0)
    monkeypatch.setenv("ACCELERATE_TRAIN_WINDOW", "4")
    assert T.Accelerator(device="cpu").train_window == 4
    monkeypatch.setenv("ACCELERATE_TRAIN_WINDOW", "x")
    with pytest.raises(ValueError, match="not an integer"):
        T.Accelerator(device="cpu").train_window
    # A rebuild drops a half-filled accumulation buffer.
    acc, pm, po = _build(accum=2)
    acc.build_train_step(pm, po)(_batch(0))
    assert any(bool((g != 0).any()) for g in tree_leaves(po.grads))
    acc.build_train_window(pm, po, window=2)
    assert all(bool((g == 0).all()) for g in tree_leaves(po.grads))


# ------------------------------------------------------------- prefetcher
def test_prefetcher_steady_state_has_no_blocking_wait():
    acc, pm, po = _build()
    w = acc.build_train_window(pm, po, window=2)
    loader = prepare_data_loader([_batch(s) for s in range(16)], device="cpu")
    feed = DeviceBatchPrefetcher(loader, prefetch=2, window=2)
    T.reset_transfer_stats()
    n = 0
    for window_batch in feed:
        losses = w(window_batch)
        n += 1
    stats = T.transfer_stats()
    assert n == 8 and stats["h2d_puts"] == 8
    assert stats["h2d_blocking"] == 0 and stats["input_wait_s"] == 0.0, stats
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    assert loader.put_on_device  # the prefetcher handed the shard its own feed back


def test_prefetcher_starved_consumer_counts_input_waits():
    def slow_stream():
        for s in range(6):
            time.sleep(0.05)
            yield _batch(s)

    feed = DeviceBatchPrefetcher(slow_stream(), prefetch=1, window=1, device="cpu")
    T.reset_transfer_stats()
    got = list(feed)
    stats = T.transfer_stats()
    assert len(got) == 6 and stats["h2d_puts"] == 6
    assert stats["h2d_blocking"] >= 4 and stats["input_wait_s"] > 0.0, stats
    assert isinstance(got[0]["input_ids"], torch.Tensor)


def test_prefetcher_window_stacks_and_drops_the_tail():
    loader = prepare_data_loader([_batch(s) for s in range(7)], device="cpu")
    feed = DeviceBatchPrefetcher(loader, prefetch=2, window=3)
    windows = list(feed)
    assert len(windows) == len(feed) == 2
    for i, wb in enumerate(windows):
        assert wb["input_ids"].shape == (3, 4, 16)
        for k in range(3):
            assert np.array_equal(wb["input_ids"][k].numpy(), _batch(3 * i + k)["input_ids"])
    with pytest.raises(ValueError, match="prefetch"):
        DeviceBatchPrefetcher([], prefetch=0, device="cpu")
    with pytest.raises(ValueError, match="window"):
        DeviceBatchPrefetcher([], window=0, device="cpu")


def test_midwindow_checkpoint_resume_is_bitwise(tmp_path):
    """A checkpoint at a window boundary mid-epoch (the prefetcher's
    consumer position registered with ``save_state``), everything rebuilt
    from disk, the epoch finished: bitwise the uninterrupted run."""
    K, total = 2, 6
    batches = [_batch(s) for s in range(K * total)]

    def run(until=None):
        acc, pm, po = _build()
        w = acc.build_train_window(pm, po, window=K)
        feed = DeviceBatchPrefetcher(prepare_data_loader(list(batches), device="cpu"),
                                     prefetch=2, window=K)
        for chunk, wb in enumerate(feed, start=1):
            w(wb)
            if chunk == until:
                break
        return acc, pm, po, feed

    reference = _state(*run()[1:3])
    acc, pm, po, feed = run(until=3)
    acc.register_for_checkpointing(feed)
    acc.save_state(str(tmp_path / "ckpt"))
    assert feed.state_dict()["num_batches_fetched"] == 3 * K  # the consumer's, not the producer's
    acc2, pm2, po2 = _build()
    w2 = acc2.build_train_window(pm2, po2, window=K)
    feed2 = DeviceBatchPrefetcher(prepare_data_loader(list(batches), device="cpu"),
                                  prefetch=2, window=K)
    acc2.register_for_checkpointing(feed2)
    acc2.load_state(str(tmp_path / "ckpt"))
    rest = 0
    for wb in feed2:
        w2(wb)
        rest += 1
    assert rest == total - 3
    assert _same(reference, _state(pm2, po2))


def test_epoch_tail_checkpoint_keeps_the_consumers_epoch():
    K, n = 2, 12
    batches = [_batch(s) for s in range(n)]
    loader = prepare_data_loader(list(batches), device="cpu")
    feed = DeviceBatchPrefetcher(loader, prefetch=8, window=K)
    it = iter(feed)
    for _ in range(3):
        next(it)
    deadline = time.monotonic() + 5.0
    while loader.iteration == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert loader.iteration == 1  # the producer ran the shard's epilogue...
    sd = feed.state_dict()
    assert sd["num_batches_fetched"] == 3 * K and sd["iteration"] == 0  # ...the consumer did not
    it.close()
    feed2 = DeviceBatchPrefetcher(prepare_data_loader(list(batches), device="cpu"),
                                  prefetch=8, window=K)
    feed2.load_state_dict(sd)
    rest = list(feed2)
    assert len(rest) == 3
    for wi, wb in enumerate(rest):
        for k in range(K):
            assert np.array_equal(wb["input_ids"][k].numpy(),
                                  batches[6 + wi * K + k]["input_ids"])


def test_load_state_dict_clears_a_stale_epoch_identity():
    feed = DeviceBatchPrefetcher(prepare_data_loader([_batch(s) for s in range(12)],
                                                     device="cpu"), prefetch=8, window=2)
    it = iter(feed)
    next(it)
    deadline = time.monotonic() + 5.0
    while feed._epoch_identity is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert feed._epoch_identity is not None
    it.close()
    feed.load_state_dict({"num_batches_fetched": 4, "iteration": 2})
    sd = feed.state_dict()
    assert sd["iteration"] == 2 and sd["num_batches_fetched"] == 4


def test_state_dict_drops_the_producers_base_state():
    class StatefulStub:
        def __init__(self, batches):
            self._batches, self.fetched = batches, 0

        def __iter__(self):
            for b in self._batches:
                self.fetched += 1
                yield b

        def __len__(self):
            return len(self._batches)

        def state_dict(self):
            return {"num_batches_fetched": self.fetched,
                    "base_state": {"producer_pos": self.fetched}, "sampler_rng": b"rng"}

        def load_state_dict(self, sd):
            pass

    feed = DeviceBatchPrefetcher(StatefulStub([_batch(s) for s in range(8)]), prefetch=4,
                                 window=2, device="cpu")
    it = iter(feed)
    next(it)
    sd = feed.state_dict()
    assert "base_state" not in sd and sd["num_batches_fetched"] == 2 and sd["sampler_rng"] == b"rng"
    for _ in it:
        pass


def test_abandoned_prefetcher_exits_quietly(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "abandon.py"
    script.write_text(
        "import numpy as np\n"
        "from accelerate_tpu_torch.data_loader import DeviceBatchPrefetcher\n"
        "batches = [{'x': np.ones((4,), np.float32)} for _ in range(32)]\n"
        "it = iter(DeviceBatchPrefetcher(batches, prefetch=2, window=1, device='cpu'))\n"
        "next(it)\n")
    result = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                            env={**os.environ, "PYTHONPATH": repo}, timeout=120)
    assert result.returncode == 0, result.stderr
    assert "Exception ignored" not in result.stderr, result.stderr
