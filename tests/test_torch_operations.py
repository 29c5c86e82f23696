"""The port's collectives and helpers (``utils/operations.py``, ``utils/tqdm.py``,
``utils/memory.py``, ``utils/random.py``), and the canonical loop over two
ranks.

This file imports no JAX: the ranks that ``debug_launcher`` spawns import
their worker from here. The JAX contract it holds ``reduce`` to is
``accelerate_tpu/utils/operations.py:342-366``: ``reduction`` in ``sum``,
``mean`` (the default) and ``none`` (the input unchanged), the result times
``scale``.

One launch of 2 gloo ranks (one thread each, so CPU sums run in one order)
checks, in each rank:

- ``reduce``: the default mean, ``"sum"``, ``"none"`` and ``scale``; a
  nested container; ``gather`` (rank order along dim 0, 0-d tensors),
  ``gather_object``, ``broadcast_object_list`` and ``pad_across_processes``
  (at the back and at the front);
- ``tqdm`` draws on rank 0 only; ``synchronize_rng_states`` hands rank 0's
  torch stream to rank 1;
- the canonical loop of the port's ``nlp_example`` on a tiny BERT with
  accumulation 2 and clip 1.0, each rank a shard of every global batch: its
  global mean loss (the ranks' losses averaged) equals the single-rank
  loop's on the same global batches within ``atol=1e-5`` (f32, sums in
  another order: the ranks' gradients are averaged instead of taken over
  one batch), its final parameters within ``5e-5`` (Adam divides by
  ``sqrt(v)``, which magnifies a rounding difference of a gradient near
  zero), and ``gather_for_metrics`` returns exactly the eval set's 50 rows
  (the last global batch is padded by wrap-around and trimmed).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as T
from accelerate_tpu_torch.examples.nlp_example import get_dataloaders
from accelerate_tpu_torch.utils import operations as ops
from accelerate_tpu_torch.utils.memory import find_executable_batch_size, is_oom_exception
from accelerate_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

LOOP_LOSS_ATOL, LOOP_PARAM_ATOL = 1e-5, 5e-5
LOOP = dict(vocab=128, train=96, eval=50, per_rank_batch=4, epochs=2, accum=2, lr=1e-3)


def canonical_loop(acc, batch_size, seed=0):
    """The port's canonical loop (``examples/nlp_example.py``) on a tiny
    BERT for ``LOOP["epochs"]`` epochs; returns this rank's losses, the
    global mean losses, the learning rates after each scheduler step, the
    eval rows ``gather_for_metrics`` returned, and the final parameters."""
    cfg = T.BertConfig.tiny(vocab_size=LOOP["vocab"], max_position_embeddings=16,
                            hidden_dropout_prob=0.0)
    model = T.BertForSequenceClassification(cfg, device="cpu")
    model.init_params(seed)
    train_dl, eval_dl = get_dataloaders(batch_size, LOOP["vocab"], train_size=LOOP["train"],
                                        eval_size=LOOP["eval"], eval_drop_last=False)
    train_dl, eval_dl = acc.prepare(train_dl, eval_dl)
    steps = LOOP["epochs"] * len(train_dl) // LOOP["accum"]
    schedule = T.linear_schedule(LOOP["lr"], 0.1 * LOOP["lr"], steps)
    optimizer = T.inject_hyperparams(T.adamw)(learning_rate=LOOP["lr"], device="cpu")
    model, optimizer, scheduler = acc.prepare(model, optimizer, schedule)
    losses, global_losses, lrs = [], [], []
    for epoch in range(LOOP["epochs"]):
        model.train()
        train_dl.set_epoch(epoch)
        torch.manual_seed(1000 + epoch)  # the shuffle order, alike on every rank
        for batch in train_dl:
            with acc.accumulate(model):
                loss = model(**batch)["loss"]
                acc.backward(loss)
                if acc.sync_gradients:
                    acc.clip_grad_norm_(model, 1.0)
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad()
            losses.append(float(loss.detach()))
            global_losses.append(float(acc.reduce(loss.detach().clone(), reduction="mean")))
            lrs.append(optimizer.learning_rate)
    model.eval()
    rows = 0
    for batch in eval_dl:
        labels = batch.pop("labels")
        preds, refs = acc.gather_for_metrics((model(**batch)["logits"].argmax(-1), labels))
        assert preds.shape == refs.shape
        rows += len(refs)
    acc.end_training()
    return dict(losses=np.asarray(losses), global_losses=np.asarray(global_losses),
                lrs=np.asarray(lrs), rows=np.asarray(rows),
                **{f"param{i}": p.numpy() for i, p in enumerate(tree_leaves(model.params))})


def two_rank_worker(out_dir: str):
    import io
    from contextlib import redirect_stderr

    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    saved = {}
    x = torch.tensor([float(rank + 1), 2.0 * rank])
    saved["mean"] = ops.reduce(x.clone()).numpy()
    saved["sum"] = ops.reduce(x.clone(), "sum").numpy()
    saved["scaled"] = ops.reduce(x.clone(), "mean", scale=3.0).numpy()
    saved["none"] = ops.reduce(x.clone(), "none", scale=3.0).numpy()
    nested = ops.reduce({"a": [x.clone()], "b": (x.clone() * 2,)}, "sum")
    saved["nested"] = np.concatenate([nested["a"][0].numpy(), nested["b"][0].numpy()])
    saved["gather"] = ops.gather(torch.full((rank + 1, 2), float(rank))[:1]).numpy()
    saved["gather0d"] = ops.gather(torch.tensor(float(rank))).numpy()
    saved["objects"] = np.asarray(ops.gather_object([f"r{rank}"]) == ["r0", "r1"])
    objs = ops.broadcast_object_list([rank, {"from": rank}], from_process=1)
    saved["broadcast"] = np.asarray(objs == [1, {"from": 1}])
    ragged = torch.arange(rank + 2, dtype=torch.float32)[:, None].expand(rank + 2, 3)
    saved["pad"] = ops.gather(ops.pad_across_processes(ragged, pad_index=-1)).numpy()
    saved["pad_first"] = ops.gather(ops.pad_across_processes(ragged, pad_first=True)).numpy()
    err = io.StringIO()
    with redirect_stderr(err):
        for _ in T.tqdm(range(3), desc="drawn"):
            pass
    saved["tqdm_drew"] = np.asarray("drawn" in err.getvalue())
    torch.manual_seed(rank)
    T.utils.random.synchronize_rng_states(["torch"])
    saved["rng"] = torch.rand(4).numpy()

    acc = T.Accelerator(device="cpu", gradient_accumulation_steps=LOOP["accum"])
    saved["is_main"] = np.asarray(acc.is_main_process)
    saved.update(canonical_loop(acc, LOOP["per_rank_batch"]))
    np.savez(Path(out_dir) / f"rank{rank}.npz", **saved)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ops")
    T.debug_launcher(two_rank_worker, args=(str(out),), num_processes=2)
    return [dict(np.load(Path(out) / f"rank{r}.npz")) for r in range(2)]


def test_reduce_follows_the_jax_contract_on_two_ranks(two_ranks):
    for saved in two_ranks:
        assert saved["mean"].tolist() == [1.5, 1.0]
        assert saved["sum"].tolist() == [3.0, 2.0]
        assert saved["scaled"].tolist() == [4.5, 3.0]
        assert saved["nested"].tolist() == [3.0, 2.0, 6.0, 4.0]
    assert two_ranks[0]["none"].tolist() == [1.0, 0.0]
    assert two_ranks[1]["none"].tolist() == [2.0, 2.0]


def test_gather_and_object_collectives_on_two_ranks(two_ranks):
    for saved in two_ranks:
        assert saved["gather"].tolist() == [[0.0, 0.0], [1.0, 1.0]]
        assert saved["gather0d"].tolist() == [0.0, 1.0]
        assert bool(saved["objects"]) and bool(saved["broadcast"])
        assert saved["pad"][:, 0].tolist() == [0.0, 1.0, -1.0, 0.0, 1.0, 2.0]
        assert saved["pad_first"][:, 0].tolist() == [0.0, 0.0, 1.0, 0.0, 1.0, 2.0]
    assert [bool(s["is_main"]) for s in two_ranks] == [True, False]


def test_tqdm_and_rng_sync_on_two_ranks(two_ranks):
    assert [bool(s["tqdm_drew"]) for s in two_ranks] == [True, False]
    assert np.array_equal(two_ranks[0]["rng"], two_ranks[1]["rng"])
    torch.manual_seed(0)
    assert np.array_equal(two_ranks[0]["rng"], torch.rand(4).numpy())


def test_two_rank_loop_matches_the_single_rank_loop(two_ranks):
    torch.manual_seed(0)
    acc = T.Accelerator(device="cpu", gradient_accumulation_steps=LOOP["accum"])
    want = canonical_loop(acc, 2 * LOOP["per_rank_batch"])
    for saved in two_ranks:
        np.testing.assert_allclose(saved["global_losses"], want["losses"], atol=LOOP_LOSS_ATOL,
                                   rtol=0)
        assert np.array_equal(saved["lrs"], want["lrs"])
        assert int(saved["rows"]) == int(want["rows"]) == LOOP["eval"]
        params = sorted(k for k in want if k.startswith("param"))
        assert len(params) == 25
        for k in params:
            np.testing.assert_allclose(saved[k], want[k], atol=LOOP_PARAM_ATOL, rtol=0)
    # each rank saw its own shard: the ranks' own losses differ
    assert not np.array_equal(two_ranks[0]["losses"], two_ranks[1]["losses"])


def test_helpers_walk_nested_containers():
    data = {"a": [np.arange(6).reshape(3, 2), torch.ones(3)], "b": ("keep", torch.zeros(3, 1))}
    assert ops.find_batch_size(data) == 3
    moved = ops.send_to_device(data, "cpu", skip_keys="b")
    assert isinstance(moved["a"][0], torch.Tensor) and moved["b"][0] == "keep"
    assert moved["b"][1] is data["b"][1]
    doubled = ops.recursively_apply(lambda t: t * 2, data)
    assert doubled["b"][0] == "keep" and doubled["a"][1].tolist() == [2.0, 2.0, 2.0]
    cat = ops.concatenate([{"x": torch.ones(2)}, {"x": torch.zeros(3)}])
    assert cat["x"].tolist() == [1.0, 1.0, 0.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="batch size"):
        ops.find_batch_size({"a": "text"})
    with pytest.raises(ValueError, match="reduction"):
        ops.reduce(torch.ones(2), "max")
    # One rank: unchanged, and the mean of one rank times the scale.
    assert ops.reduce(torch.ones(2), scale=0.5).tolist() == [0.5, 0.5]
    assert ops.gather(torch.ones(2)).tolist() == [1.0, 1.0]
    assert ops.gather_object("x") == ["x"] and ops.gather_object(["x", "y"]) == ["x", "y"]


def test_find_executable_batch_size_retries_on_cuda_oom():
    tried = []

    @find_executable_batch_size(starting_batch_size=64)
    def train(batch_size, scale):
        tried.append(batch_size)
        if batch_size > 8:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return batch_size * scale

    assert train(3) == 24 and tried == [64, 32, 16, 8]
    assert is_oom_exception(RuntimeError("RESOURCE_EXHAUSTED: while allocating"))
    assert not is_oom_exception(ValueError("shape mismatch"))

    @find_executable_batch_size(starting_batch_size=4)
    def never(batch_size):
        raise torch.OutOfMemoryError("out of memory")

    with pytest.raises(RuntimeError, match="reached zero"):
        never()

    @find_executable_batch_size(starting_batch_size=4)
    def wrong(batch_size):
        raise ValueError("not an OOM")

    with pytest.raises(ValueError, match="not an OOM"):
        wrong()
    with pytest.raises(TypeError, match="first argument"):
        train(8, 3)
    assert T.release_memory(torch.ones(2), "x") == [None, None]
