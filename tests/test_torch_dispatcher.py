"""``DataLoaderDispatcher`` (rank 0 reads, every rank receives its rows)
against the JAX package's.

A stream of global batches (an ``IterableDataset`` of 6 rows a sample, 4
samples a batch, through a torch ``DataLoader``; and a plain iterable of
dict batches) is dispatched. On one process the batches, their order, the
``end_of_dataloader`` flag on the last one, the length and the resume state
equal the JAX package's dispatcher index for index (exact: integer data).
Over 2 and 4 gloo ranks (``debug_launcher``) rank i receives rows
``[i·B/n, (i+1)·B/n)`` of every global batch, which rank 0 broadcast,
exactly the one-process split. Skipping past the
end yields nothing; a loaded position resumes at the next batch.

This module imports JAX only inside the tests that compare with it: the
ranks ``debug_launcher`` spawns import their worker from here.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.utils.data as tud

import accelerate_tpu_torch as T
from accelerate_tpu_torch import data_loader as P


class Stream(tud.IterableDataset):
    """``n`` samples, each a dict of a (6,) int row and a scalar label."""

    def __init__(self, n=22):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield {"x": np.arange(6, dtype=np.int64) + 10 * i, "y": np.int64(i)}


def _torch_loader(n=22):
    return tud.DataLoader(Stream(n), batch_size=4)


def _dict_batches(n=5):
    rng = np.random.default_rng(0)
    return [{"ids": rng.integers(0, 100, (4, 3)).astype(np.int32), "tag": f"b{i}"}
            for i in range(n)]


def _np(batch):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in batch.items()}


def test_one_process_batches_match_jax_index_for_index():
    from accelerate_tpu import data_loader as J

    jdl = J.prepare_data_loader(_torch_loader(), put_on_device=False, dispatch_batches=True)
    pdl = P.prepare_data_loader(_torch_loader(), device="cpu", dispatch_batches=True)
    assert isinstance(jdl, J.DataLoaderDispatcher) and isinstance(pdl, P.DataLoaderDispatcher)
    got = [(_np(pb), pdl.end_of_dataloader) for pb in pdl]
    want = [({k: np.asarray(v) for k, v in jb.items()}, jdl.end_of_dataloader) for jb in jdl]
    assert len(got) == len(want) == 6  # 22 rows: 5 full batches and a tail of 2
    for (g, ge), (w, we) in zip(got, want):
        assert ge == we and sorted(g) == sorted(w)
        for k in g:
            assert np.array_equal(g[k], w[k]), k
    assert got[-1][1] and not got[-2][1]
    assert pdl.state_dict() == jdl.state_dict() == {"num_batches_fetched": 0, "iteration": 1}
    plain = P.prepare_data_loader(_dict_batches(), device="cpu", dispatch_batches=True)
    jplain = J.prepare_data_loader(_dict_batches(), put_on_device=False, dispatch_batches=True)
    assert len(plain) == len(jplain) == 5
    for pb, jb in zip(plain, jplain):
        assert np.array_equal(pb["ids"].numpy(), np.asarray(jb["ids"])) and pb["tag"] == jb["tag"]


def test_skip_past_the_end_and_resume_match_jax():
    from accelerate_tpu import data_loader as J

    for skip in (2, 6, 9):
        pdl = P.DataLoaderDispatcher(_torch_loader(), device="cpu", skip_batches=skip)
        jdl = J.DataLoaderDispatcher(_torch_loader(), put_on_device=False, skip_batches=skip)
        got = [b["y"].tolist() for b in pdl]
        assert got == [np.asarray(b["y"]).tolist() for b in jdl]
        assert len(got) == max(6 - skip, 0) and pdl.iteration == jdl.iteration == 1
    # Resume: 2 batches in, the state goes to a fresh dispatcher, which
    # yields the rest of the epoch.
    pdl = P.DataLoaderDispatcher(_torch_loader(), device="cpu")
    it = iter(pdl)
    seen = [next(it)["y"].tolist() for _ in range(2)]
    sd = pdl.state_dict()
    jdl = J.DataLoaderDispatcher(_torch_loader(), put_on_device=False)
    jit = iter(jdl)
    for _ in range(2):
        next(jit)
    assert sd == jdl.state_dict() == {"num_batches_fetched": 2, "iteration": 0}
    fresh = P.DataLoaderDispatcher(_torch_loader(), device="cpu")
    fresh.load_state_dict(sd)
    rest = [b["y"].tolist() for b in fresh]
    whole = [b["y"].tolist() for b in P.DataLoaderDispatcher(_torch_loader(), device="cpu")]
    assert seen + rest == whole and fresh.state_dict()["iteration"] == 1


def dispatch_worker(out_dir: str):
    """One gloo rank: the dispatched stream of both loaders, through
    ``Accelerator.prepare`` (``dispatch_batches`` on by default for an
    iterable dataset over several ranks)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    acc = T.Accelerator(device="cpu")
    dl = acc.prepare(_torch_loader())
    assert isinstance(dl, P.DataLoaderDispatcher)
    plain = acc.prepare_data_loader(_dict_batches())  # a plain iterable is sharded, not sent
    acc2 = T.Accelerator(device="cpu", dataloader_config=T.DataLoaderConfiguration(
        dispatch_batches=True))
    sent = acc2.prepare(_dict_batches())
    saved = {}
    for i, b in enumerate(dl):
        saved[f"x{i}"], saved[f"y{i}"] = b["x"].numpy(), b["y"].numpy()
        saved[f"end{i}"] = np.asarray(dl.end_of_dataloader)
    for i, b in enumerate(sent):
        saved[f"ids{i}"], saved[f"tag{i}"] = b["ids"].numpy(), np.asarray(b["tag"])
    saved["plain_kind"] = np.asarray(type(plain).__name__)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **saved)


@pytest.mark.parametrize("n", [2, 4])
def test_each_gloo_rank_receives_its_rows(tmp_path, n):
    T.debug_launcher(dispatch_worker, args=(str(tmp_path),), num_processes=n)
    whole = [_np(b) for b in P.DataLoaderDispatcher(_torch_loader(), device="cpu")]
    plain = _dict_batches()
    for r in range(n):
        saved = dict(np.load(tmp_path / f"rank{r}.npz"))
        assert str(saved["plain_kind"]) == "DataLoaderShard"
        assert sum(k.startswith("x") for k in saved) == len(whole)
        for i, b in enumerate(whole):
            per = b["x"].shape[0] // n
            rows = slice(r * per, (r + 1) * per)
            assert np.array_equal(saved[f"x{i}"], b["x"][rows])
            assert np.array_equal(saved[f"y{i}"], b["y"][rows])
            assert bool(saved[f"end{i}"]) == (i == len(whole) - 1)
        for i, b in enumerate(plain):
            per = 4 // n
            assert np.array_equal(saved[f"ids{i}"], b["ids"][r * per:(r + 1) * per])
            assert str(saved[f"tag{i}"]) == b["tag"]
