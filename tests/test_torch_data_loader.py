"""The port's data layer (``data_loader.py``) against the JAX package's.

The index logic is pure integer bookkeeping, so every comparison is exact:

- ``SeedableRandomSampler`` over three epochs (``seed + epoch`` reseeds);
- ``BatchSamplerShard`` over a grid: 1 to 4 ranks, every rank,
  ``split_batches``, ``even_batches``, ``drop_last``, dataset sizes that do
  and do not divide, under a sequential and a seedable shuffled sampler
  (lengths too);
- ``IterableDatasetShard`` over the same grid;
- the prepared ``DataLoaderShard``: each rank's batches (the padded tail),
  ``end_of_dataloader`` on exactly the last batch, and ``remainder``,
  against the JAX loader's host batches (``put_on_device=False``), with a
  torch ``RandomSampler`` whose order both sides draw from the same torch
  seed; ``skip_first_batches``.
"""

import itertools

import numpy as np
import pytest
import torch
import torch.utils.data as tud

from accelerate_tpu import data_loader as J
from accelerate_tpu.state import GradientState as JGradientState

from accelerate_tpu_torch import data_loader as P
from accelerate_tpu_torch.state import GradientState

torch.set_num_threads(2)

SIZES = (24, 26, 31)
GRID = [(n, i, split, even, drop, size)
        for n in (1, 2, 3, 4) for i in range(n)
        for split, even, drop in itertools.product((False, True), repeat=3)
        for size in SIZES]


def test_seedable_random_sampler_matches_jax():
    data = list(range(37))
    j, p = J.SeedableRandomSampler(data, seed=11), P.SeedableRandomSampler(data, seed=11)
    for _ in range(3):
        assert list(p) == list(j)
    p.set_epoch(7)
    j.set_epoch(7)
    assert list(p) == list(j) and len(p) == len(j) == 37


def _batch_sampler(kind, size, bs, drop):
    if kind == "sequential":
        return tud.BatchSampler(tud.SequentialSampler(range(size)), bs, drop)
    return tud.BatchSampler(P.SeedableRandomSampler(range(size), seed=3), bs, drop)


@pytest.mark.parametrize("kind", ["sequential", "seedable"])
def test_batch_sampler_shard_matches_jax_on_the_grid(kind):
    bs = 4
    for n, i, split, even, drop, size in GRID:
        if split and bs % n:
            for mod in (J, P):
                with pytest.raises(ValueError, match="divisible"):
                    mod.BatchSamplerShard(_batch_sampler(kind, size, bs, drop), n, i, True, even)
            continue
        j = J.BatchSamplerShard(_batch_sampler(kind, size, bs, drop), num_processes=n,
                                process_index=i, split_batches=split, even_batches=even)
        p = P.BatchSamplerShard(_batch_sampler(kind, size, bs, drop), num_processes=n,
                                process_index=i, split_batches=split, even_batches=even)
        case = (n, i, split, even, drop, size)
        assert [list(b) for b in p] == [list(b) for b in j], case
        assert len(p) == len(j) and p.total_length == j.total_length, case


def test_iterable_dataset_shard_matches_jax_on_the_grid():
    bs = 4
    for n, i, split, _, drop, size in GRID:
        if split and bs % n:
            continue
        data = list(range(100, 100 + size))
        j = J.IterableDatasetShard(data, batch_size=bs, drop_last=drop, num_processes=n,
                                   process_index=i, split_batches=split)
        p = P.IterableDatasetShard(data, batch_size=bs, drop_last=drop, num_processes=n,
                                   process_index=i, split_batches=split)
        assert list(p) == list(j) and len(p) == len(j), (n, i, split, drop, size)


class ArrayDataset:
    def __init__(self, size):
        rng = np.random.default_rng(size)
        self.x = rng.integers(0, 1000, (size, 3)).astype(np.int32)
        self.y = np.arange(size, dtype=np.int32)

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


def _collate(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _loader(size, bs, drop, shuffle):
    return tud.DataLoader(ArrayDataset(size), batch_size=bs, shuffle=shuffle, drop_last=drop,
                          collate_fn=_collate)


def _walk(loader, end_flag):
    """Each yielded batch as numpy, with the end flag seen on it; then the
    loader's remainder."""
    out = []
    for batch in loader:
        out.append(({k: np.asarray(v) for k, v in batch.items()}, end_flag()))
    return out, loader.remainder


LOADER_GRID = [(n, i, split, drop, size, shuffle)
               for n in (1, 2, 3) for i in range(n)
               for split in (False, True) for drop in (False, True)
               for size in (48, 53) for shuffle in (False, True)]


def test_prepared_loader_yields_what_jax_yields():
    bs = 6
    for n, i, split, drop, size, shuffle in LOADER_GRID:
        case = (n, i, split, drop, size, shuffle)
        jdl = J.prepare_data_loader(_loader(size, bs, drop, shuffle), num_processes=n,
                                    process_index=i, split_batches=split, put_on_device=False)
        gs = GradientState()
        pdl = P.prepare_data_loader(_loader(size, bs, drop, shuffle), device="cpu",
                                    num_processes=n, process_index=i, split_batches=split,
                                    gradient_state=gs)
        for epoch in range(2):
            jdl.set_epoch(epoch)
            pdl.set_epoch(epoch)
            torch.manual_seed(100 + epoch)
            want, want_rem = _walk(jdl, lambda: JGradientState().end_of_dataloader)
            torch.manual_seed(100 + epoch)
            got, got_rem = _walk(pdl, lambda: gs.end_of_dataloader)
            assert len(got) == len(want) == len(pdl) == len(jdl), case
            for (gb, gend), (wb, wend) in zip(got, want):
                assert gend == wend, case
                assert set(gb) == set(wb)
                for k in wb:
                    assert np.array_equal(gb[k], wb[k]), (case, k)
            assert [end for _, end in got] == [False] * (len(got) - 1) + [True], case
            assert got_rem == want_rem, case
            assert gs.active_dataloader is None  # unregistered at the end


def test_prepared_loader_places_tensors_and_pads_a_short_tail():
    gs = GradientState()
    dl = P.prepare_data_loader(_loader(20, 8, False, False), device="cpu", gradient_state=gs)
    batches = list(dl)
    assert [b["y"].tolist() for b in batches] == [list(range(8)), list(range(8, 16)),
                                                  [16, 17, 18, 19, 16, 17, 18, 19]]
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].dtype == torch.int32 for b in batches)
    assert dl.remainder == 4 and dl.total_batch_size == 8


def test_skip_first_batches_matches_jax():
    jdl = J.prepare_data_loader(_loader(40, 4, False, False), put_on_device=False)
    pdl = P.prepare_data_loader(_loader(40, 4, False, False), device="cpu")
    want = [b["y"].tolist() for b in J.skip_first_batches(jdl, 3)]
    got = [b["y"].tolist() for b in P.skip_first_batches(pdl, 3)]
    assert got == want and len(P.skip_first_batches(pdl, 3)) == 7
    plain = P.skip_first_batches([[1], [2], [3]], 2)
    assert list(plain) == [[3]] and len(plain) == 1
    sampler = P.SkipBatchSampler(tud.BatchSampler(tud.SequentialSampler(range(10)), 3, False), 2)
    assert list(sampler) == [[6, 7, 8], [9]] and len(sampler) == 2 and sampler.total_length == 4


def test_unported_loader_options_raise():
    with pytest.raises(NotImplementedError, match="DataLoaderDispatcher"):
        P.prepare_data_loader(_loader(8, 4, False, False), device="cpu", dispatch_batches=True)
    with pytest.raises(NotImplementedError, match="resume"):
        P.prepare_data_loader(_loader(8, 4, False, False), device="cpu",
                              use_stateful_dataloader=True)
