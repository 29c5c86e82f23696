"""The distributed checks ``accelerate-tpu-torch test`` runs — the
counterpart of ``accelerate_tpu/test_utils/test_script.py:35-410``, every
check on the port's API, over the job's real processes (one per card, or
gloo ranks with ``--cpu``):

- state init (each rank on its own card) and the process controls
  (``on_*_process``, ``main_process_first``, ``local_main_process_first``);
- the random streams synchronised from rank 0;
- the shard and dispatcher loaders in both ``split_batches`` modes, and the
  seedable sampler;
- ``gather``, ``gather_object``, ``broadcast``, ``reduce`` and
  ``pad_across_processes``;
- ``split_between_processes`` on a list, an array and a dict, with padding;
- training: the imperative loop (each rank its rows) against
  ``build_train_step`` (the global batch) at ``ATOL`` in f32 with
  ``optim.sgd(0.05)`` (the fused sgd update on the card), and both against
  plain full-batch gradient descent; gradient accumulation: the sync flag
  on its boundaries, the banked gradients equal on every rank, and two
  accumulated micro-batches equal to one batch twice the size;
- ``set_trigger`` / ``check_trigger``.

It ends by printing "All distributed asserts passed." and, on the main
process, one JSON line of the kernel launches it made
(``{"test_script_launches": {...}}``). Run it with::

    accelerate-tpu-torch test
    accelerate-tpu-torch launch --cpu --num_processes 2 -m accelerate_tpu_torch.test_utils.test_script
"""

from __future__ import annotations

import io
import json
import socket
from contextlib import redirect_stdout

import numpy as np
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.data_loader import (
    BatchSamplerShard,
    DataLoaderDispatcher,
    SeedableRandomSampler,
)
from accelerate_tpu_torch.ops import registry
from accelerate_tpu_torch.test_utils.training import (
    RegressionDataset,
    RegressionModel,
    regression_batches,
)
from accelerate_tpu_torch.utils.operations import (
    broadcast,
    gather,
    gather_object,
    pad_across_processes,
    reduce,
)
from accelerate_tpu_torch.utils.random import synchronize_rng_states

ATOL = 1e-6


def init_state_check(accelerator):
    n, rank = accelerator.num_processes, accelerator.process_index
    assert n >= 1 and 0 <= rank < n
    device = accelerator.device
    card = None
    if device.type == "cuda":  # each rank on its own card: cuda:LOCAL_RANK
        card = torch.cuda.current_device()
        assert card == accelerator.local_process_index and device.index in (None, card), (
            card, accelerator.local_process_index, device)
    where = gather_object([(socket.gethostname(), str(device), card)])
    if device.type == "cuda":
        assert len({(host, c) for host, _, c in where}) == n, where
    if accelerator.is_main_process:
        print(f"state ok: {n} processes, {accelerator.mixed_precision} precision, ranks on "
              f"{[w[1] for w in where]}")


def process_execution_check(accelerator):
    buf = io.StringIO()
    with redirect_stdout(buf):
        accelerator.on_main_process(lambda: print("main"))()
        accelerator.on_local_main_process(lambda: print("local_main"))()
        accelerator.on_last_process(lambda: print("last"))()
        accelerator.on_process(lambda: print("process0"), process_index=0)()
        accelerator.on_local_process(lambda: print("local0"), local_process_index=0)()
    out = buf.getvalue().split()
    assert ("main" in out) == accelerator.is_main_process, out
    assert ("local_main" in out) == accelerator.is_local_main_process, out
    assert ("last" in out) == accelerator.is_last_process, out
    assert ("process0" in out) == (accelerator.process_index == 0), out
    assert ("local0" in out) == (accelerator.local_process_index == 0), out
    for ctx in (accelerator.main_process_first, accelerator.local_main_process_first):
        entered = []
        with ctx():
            entered.append(accelerator.process_index)
        assert entered == [accelerator.process_index]
    if accelerator.is_main_process:
        print("process execution ok")


def rng_sync_check(accelerator):
    T.set_seed(1234 + accelerator.process_index, device=accelerator.device)  # desynced
    synchronize_rng_states(["numpy", "torch"] + (["cuda"] if accelerator.device.type == "cuda"
                                                 else []))
    vals = gather_object([float(np.random.random())])
    assert all(v == vals[0] for v in vals), vals
    tvals = gather_object([float(torch.rand(1))])
    assert all(v == tvals[0] for v in tvals), tvals
    if accelerator.device.type == "cuda":
        cvals = gather_object([float(torch.rand(1, device=accelerator.device))])
        assert all(v == cvals[0] for v in cvals), cvals
    if accelerator.is_main_process:
        print("rng sync ok")


class _Batches:
    """A batch sampler of ``length`` indices in batches of ``batch_size``."""

    drop_last = False

    def __init__(self, length: int, batch_size: int):
        self.length, self.batch_size = length, batch_size

    def __iter__(self):
        yield from (list(range(i, min(i + self.batch_size, self.length)))
                    for i in range(0, self.length, self.batch_size))

    def __len__(self):
        return (self.length + self.batch_size - 1) // self.batch_size


def _roundtrip_shards(accelerator, length, batch_size, split_batches):
    """Every rank shards the same index stream; gathering the shards gives
    back every index."""
    shard = BatchSamplerShard(_Batches(length, batch_size),
                              num_processes=accelerator.num_processes,
                              process_index=accelerator.process_index,
                              split_batches=split_batches)
    everyone = gather_object([idx for batch in shard for idx in batch])
    assert sorted(set(everyone)) == list(range(length)), sorted(set(everyone))


def dl_preparation_check(accelerator):
    for split_batches in (False, True):
        bs = 8 if not split_batches else 8 * accelerator.num_processes
        _roundtrip_shards(accelerator, 96, bs, split_batches)
        _roundtrip_shards(accelerator, 90, bs, split_batches)
    if accelerator.is_main_process:
        print("dataloader sharding ok")


def central_dl_preparation_check(accelerator):
    """The dispatcher: rank 0 reads every batch, each rank receives its
    rows, and the rows gathered in rank order are the batch."""
    n = accelerator.num_processes
    batches = [{"x": np.arange(i * 8 * n, (i + 1) * 8 * n, dtype=np.float32)}
               for i in range(6)]
    for split_batches in (False, True):
        got = list(DataLoaderDispatcher(batches, device=accelerator.device,
                                        split_batches=split_batches))
        assert len(got) == len(batches), len(got)
        for want, have in zip(batches, got):
            rows = gather(have["x"].to(accelerator.device))
            np.testing.assert_array_equal(rows.cpu().numpy(), want["x"])
    if accelerator.is_main_process:
        print("central dataloader ok")


def check_seedable_sampler(accelerator):
    """The same permutation on every rank, another each epoch."""

    class _DS:
        def __len__(self):
            return 24

    sampler = SeedableRandomSampler(_DS(), seed=99)
    sampler.set_epoch(0)
    perm0 = list(iter(sampler))
    sampler.set_epoch(1)
    perm1 = list(iter(sampler))
    assert sorted(perm0) == list(range(24))
    assert perm0 != perm1, "epochs must reshuffle"
    perms = gather_object([tuple(perm0)])
    assert all(p == perms[0] for p in perms), "ranks disagree on the permutation"
    if accelerator.is_main_process:
        print("seedable sampler ok")


def collectives_check(accelerator):
    n, rank, dev = accelerator.num_processes, accelerator.process_index, accelerator.device
    x = torch.arange(4.0, device=dev) + rank
    g = gather(x)
    assert g.shape[0] == 4 * n, g.shape
    want = np.concatenate([np.arange(4.0) + r for r in range(n)])
    np.testing.assert_allclose(g.cpu().numpy(), want)
    r = reduce(x.clone(), reduction="sum")
    np.testing.assert_allclose(r.cpu().numpy(), np.arange(4.0) * n + sum(range(n)))
    b = broadcast(x.clone(), src=0)
    np.testing.assert_allclose(b.cpu().numpy(), np.arange(4.0))
    objs = gather_object([f"rank{rank}"])
    assert objs == [f"rank{i}" for i in range(n)], objs
    # Uneven shapes: each rank holds rank + 1 rows; padded, then gathered.
    uneven = torch.ones((rank + 1, 2), device=dev) * rank
    padded = pad_across_processes(uneven, dim=0)
    assert padded.shape[0] == n, padded.shape
    rows = gather(padded)
    assert rows.shape == (n * n, 2), rows.shape
    if accelerator.is_main_process:
        print("collectives ok")


def split_between_processes_check(accelerator):
    n = accelerator.num_processes
    items = list(range(n * 3 + 1))
    with accelerator.split_between_processes(items) as shard:
        assert len(shard) >= 1
        recombined = gather_object(list(shard))
    assert sorted(recombined) == items, recombined
    t = np.arange(n * 4, dtype=np.float32).reshape(n * 4, 1)
    with accelerator.split_between_processes(t) as shard:
        assert np.asarray(shard).shape[0] == 4
    nested = {"a": list(range(n * 2)), "b": torch.arange(n * 2)}
    with accelerator.split_between_processes(nested) as shard:
        assert len(shard["a"]) == 2 and shard["b"].shape[0] == 2
    odd = list(range(n + 1))
    with accelerator.split_between_processes(odd, apply_padding=True) as shard:
        lengths = gather_object([len(shard)])
    assert all(length == lengths[0] for length in lengths), lengths
    if accelerator.is_main_process:
        print("split_between_processes ok")


def _prepared(accelerator, lr: float):
    """A fresh regression model and ``sgd(lr)``, prepared to compute in f32
    whatever the launch's precision (``AutocastKwargs(enabled=False)``)."""
    model = RegressionModel(device=accelerator.device)
    model.init_params()
    with accelerator.autocast(T.AutocastKwargs(enabled=False)):
        return accelerator.prepare(model, T.sgd(lr, device=accelerator.device))


def training_check(accelerator):
    """The imperative loop against the fused step, and both against plain
    full-batch gradient descent (JAX ``training_check``)."""
    n, rank = accelerator.num_processes, accelerator.process_index
    batches = regression_batches(RegressionDataset(length=64, seed=0), batch_size=16)

    def run_imperative():
        pmodel, popt = _prepared(accelerator, 0.05)
        pmodel.train()
        for _ in range(3):
            for batch in batches:
                mine = {k: v[rank * len(v) // n:(rank + 1) * len(v) // n]
                        for k, v in batch.items()}
                accelerator.backward(pmodel(**mine)["loss"])
                popt.step()
                popt.zero_grad()
        sd = accelerator.get_state_dict(pmodel)
        return float(sd["a"]), float(sd["b"])

    def run_fused():
        pmodel, popt = _prepared(accelerator, 0.05)
        step = accelerator.build_train_step(pmodel, popt)
        for _ in range(3):
            for batch in batches:
                step(batch)
        sd = accelerator.get_state_dict(pmodel)
        return float(sd["a"]), float(sd["b"])

    def run_plain():
        a = torch.zeros((), dtype=torch.float32, requires_grad=True)
        b = torch.zeros((), dtype=torch.float32, requires_grad=True)
        for _ in range(3):
            for batch in batches:
                x, y = torch.from_numpy(batch["x"]), torch.from_numpy(batch["y"])
                ga, gb = torch.autograd.grad(torch.mean((a * x + b - y) ** 2), (a, b))
                with torch.no_grad():
                    a -= 0.05 * ga
                    b -= 0.05 * gb
        return float(a.detach()), float(b.detach())

    ia, ib = run_imperative()
    fa, fb = run_fused()
    pa, pb = run_plain()
    assert abs(ia - fa) < ATOL and abs(ib - fb) < ATOL, (
        f"imperative vs fused diverged: ({ia}, {ib}) vs ({fa}, {fb})")
    # The ranks' row means averaged over the ranks are the full batch's
    # gradient: the same descent up to f32 rounding.
    assert abs(ia - pa) < 1e-4 and abs(ib - pb) < 1e-4, (
        f"distributed vs plain full-batch descent diverged: ({ia}, {ib}) vs ({pa}, {pb})")
    if accelerator.is_main_process:
        print(f"training parity ok: a={ia:.5f} b={ib:.5f} (fused and plain match)")


def grad_sync_check(accelerator):
    """Accumulation over the real ranks: the sync flag on exact boundaries,
    the banked gradients equal on every rank at a boundary, and two
    accumulated micro-batches equal to one batch twice the size."""
    n, rank, dev = accelerator.num_processes, accelerator.process_index, accelerator.device
    acc = T.Accelerator(device=dev, gradient_accumulation_plugin=T.GradientAccumulationPlugin(
        num_steps=2, sync_with_dataloader=False))
    bs = 8 * n
    ds = RegressionDataset(length=4 * bs, seed=3)

    def mine(batch):
        return {k: v[rank * len(v) // n:(rank + 1) * len(v) // n] for k, v in batch.items()}

    pmodel, popt = _prepared(acc, 0.1)
    flags = []
    for batch in regression_batches(ds, batch_size=bs):
        with acc.accumulate(pmodel):
            flags.append(acc.sync_gradients)
            acc.backward(pmodel(**mine(batch))["loss"])
            if acc.sync_gradients:
                ga = float(popt.grads["a"])
                everyone = gather_object([ga])
                assert all(v == everyone[0] for v in everyone), everyone
            popt.step()
            popt.zero_grad()
    assert flags == [False, True, False, True], flags
    accumulated = {k: float(v) for k, v in acc.get_state_dict(pmodel).items()}

    acc2 = T.Accelerator(device=dev)
    pmodel2, popt2 = _prepared(acc2, 0.1)
    for batch in regression_batches(ds, batch_size=2 * bs):
        acc2.backward(pmodel2(**mine(batch))["loss"])
        popt2.step()
        popt2.zero_grad()
    onebatch = {k: float(v) for k, v in acc2.get_state_dict(pmodel2).items()}
    for k in accumulated:
        assert abs(accumulated[k] - onebatch[k]) < 1e-5, (k, accumulated[k], onebatch[k])
    if accelerator.is_main_process:
        print("grad sync ok")


def trigger_check(accelerator):
    """A flag set on the last rank is seen by every rank, once."""
    if accelerator.is_last_process:
        accelerator.set_trigger()
    assert accelerator.check_trigger() is True
    assert accelerator.check_trigger() is False
    if accelerator.is_main_process:
        print("trigger ok")


def main():
    registry.reset_launch_counts()
    accelerator = T.Accelerator()
    init_state_check(accelerator)
    process_execution_check(accelerator)
    rng_sync_check(accelerator)
    dl_preparation_check(accelerator)
    central_dl_preparation_check(accelerator)
    check_seedable_sampler(accelerator)
    collectives_check(accelerator)
    split_between_processes_check(accelerator)
    training_check(accelerator)
    grad_sync_check(accelerator)
    trigger_check(accelerator)
    accelerator.wait_for_everyone()
    if accelerator.is_main_process:
        print(json.dumps({"test_script_launches": dict(registry.launch_counts)}))
        print("All distributed asserts passed.")


if __name__ == "__main__":
    main()
