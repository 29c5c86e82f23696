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
  seed; ``skip_first_batches``;
- mid-epoch resume: a loader's ``state_dict`` written by either package
  resumes the other's loader at the same batch, index for index, for a
  plain ``RandomSampler``, a user ``generator=`` and the seedable sampler;
  and the JAX package's own resume cases, mirrored.
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
    # The dispatcher is ported. As in the JAX package, dispatch_batches only
    # reroutes an iterable dataset or a plain iterable; a map-style loader
    # is still sharded by index.
    jdl = J.prepare_data_loader(_loader(8, 4, False, False), put_on_device=False,
                                dispatch_batches=True)
    pdl = P.prepare_data_loader(_loader(8, 4, False, False), device="cpu", dispatch_batches=True)
    assert isinstance(pdl, P.DataLoaderShard) and isinstance(jdl, J.DataLoaderShard)
    assert [b["y"].tolist() for b in pdl] == [b["y"].tolist() for b in jdl]
    plain = P.prepare_data_loader([{"y": np.arange(4)}], device="cpu", dispatch_batches=True)
    assert isinstance(plain, P.DataLoaderDispatcher)
    assert [b["y"].tolist() for b in plain] == [[0, 1, 2, 3]]


def test_use_stateful_dataloader_is_accepted_as_jax_accepts_it():
    jdl = J.prepare_data_loader(_loader(8, 4, False, False), put_on_device=False,
                                use_stateful_dataloader=True)
    pdl = P.prepare_data_loader(_loader(8, 4, False, False), device="cpu",
                                use_stateful_dataloader=True)
    assert isinstance(pdl, P.DataLoaderShard) and isinstance(jdl, J.DataLoaderShard)
    assert [b["y"].tolist() for b in pdl] == [b["y"].tolist() for b in jdl]
    assert pdl.state_dict() == jdl.state_dict() == {"num_batches_fetched": 0, "iteration": 1}


# ----------------------------------------------------------- mid-epoch resume
# The sampler chains of the cross-package resume cases: a plain RandomSampler
# (the "torch_global" snapshot), a user generator= (the "generator"
# snapshot), and the seedable sampler (reseeded seed + epoch).
RESUME_KINDS = ("random", "generator", "seedable")


def _resume_loader(pkg, kind, size=30, bs=4):
    generator = torch.Generator().manual_seed(77) if kind == "generator" else None
    dl = tud.DataLoader(ArrayDataset(size), batch_size=bs, shuffle=True, collate_fn=_collate,
                        generator=generator)
    kw = dict(use_seedable_sampler=kind == "seedable", data_seed=5)
    if pkg == "jax":
        return J.prepare_data_loader(dl, put_on_device=False, **kw)
    return P.prepare_data_loader(dl, device="cpu", gradient_state=GradientState(), **kw)


def _ys(batches):
    return [np.asarray(b["y"]).tolist() for b in batches]


@pytest.mark.parametrize("kind", RESUME_KINDS)
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_sampler_state_resumes_the_other_packages_loader(writer, reader, kind):
    """A loader of one package, ``k`` batches into its second epoch: its
    ``state_dict`` (what ``sampler.bin`` holds, pickled) loads into a fresh
    loader of the other package, built with another ambient torch stream,
    which yields the writer's remaining batches index for index."""
    import pickle

    src = _resume_loader(writer, kind)
    torch.manual_seed(1234)
    list(src)  # epoch 0
    it = iter(src)
    head = _ys([next(it) for _ in range(3)])
    sd = pickle.loads(pickle.dumps(src.state_dict()))
    tail = _ys(it)
    assert sd["num_batches_fetched"] == 3 and sd["iteration"] == 1 and len(tail) == 5
    assert sd["sampler_rng"][0] == ("generator" if kind == "generator" else "torch_global")
    dst = _resume_loader(reader, kind)
    torch.manual_seed(999)  # the resume must not depend on the ambient stream
    dst.load_state_dict(sd)
    assert _ys(dst) == tail
    assert head + tail != sorted(head + tail)  # a shuffled epoch


def test_resume_state_dict_matches_jax_field_for_field():
    """After the same batches from the same torch stream, both packages'
    states are equal, snapshot bytes included."""
    states = {}
    for pkg in ("jax", "port"):
        dl = _resume_loader(pkg, "random")
        torch.manual_seed(42)
        it = iter(dl)
        next(it), next(it)
        states[pkg] = dl.state_dict()
    assert states["port"] == states["jax"]


def _seq(n=8):
    return [{"x": np.arange(4) + 4 * i} for i in range(n)]


def _firsts(loader):
    return [int(np.asarray(b["x"])[0]) for b in loader]


def test_skip_first_batches_does_not_compound_with_stateful_resume():
    """``load_state_dict`` then ``skip_first_batches`` skips once, and the
    source's next epoch starts at its top (as in the JAX package's test)."""
    got = {}
    for name, mod, kw in (("jax", J, dict(put_on_device=False)), ("port", P, dict(device="cpu"))):
        dl = mod.DataLoaderShard(_seq(), **kw)
        dl.load_state_dict({"num_batches_fetched": 3, "iteration": 0})
        got[name] = (_firsts(mod.skip_first_batches(dl, 3)), _firsts(dl))
    assert got["port"] == got["jax"] == ([12, 16, 20, 24, 28], [0, 4, 8, 12, 16, 20, 24, 28])


def test_set_epoch_invalidates_restored_position():
    dl = P.DataLoaderShard(_seq(3), device="cpu")
    dl.load_state_dict({"num_batches_fetched": 3, "iteration": 0})
    dl.set_epoch(1)
    assert len(list(dl)) == 3


def test_state_dict_idempotent_after_load():
    dl = P.DataLoaderShard(_seq(4), device="cpu")
    sd = {"num_batches_fetched": 2, "iteration": 0, "sampler_rng": ("torch_global", b"x")}
    dl.load_state_dict(sd)
    assert dl.state_dict() == sd


def test_resume_replays_plain_random_sampler_order():
    def make():
        torch.manual_seed(1234)
        ds = tud.TensorDataset(torch.arange(32))
        return P.prepare_data_loader(tud.DataLoader(ds, batch_size=4, shuffle=True),
                                     device="cpu")

    loader = make()
    list(loader)
    it = iter(loader)
    for _ in range(3):
        next(it)
    sd = loader.state_dict()
    tail_a = [b[0].tolist() for b in it]
    loader_b = make()
    torch.manual_seed(999)
    loader_b.load_state_dict(sd)
    assert [b[0].tolist() for b in loader_b] == tail_a and len(tail_a) == 5


class _StatefulBase:
    def __init__(self, n=6):
        self.data = [{"x": np.full((2,), i)} for i in range(n)]
        self.pos = 0

    def __iter__(self):
        while self.pos < len(self.data):
            item = self.data[self.pos]
            self.pos += 1
            yield item
        self.pos = 0

    def state_dict(self):
        return {"pos": self.pos}

    def load_state_dict(self, sd):
        self.pos = sd["pos"]


def test_resume_passes_through_stateful_base():
    loader = P.prepare_data_loader(_StatefulBase(), device="cpu")
    it = iter(loader)
    next(it), next(it)
    sd = loader.state_dict()
    assert sd["base_state"] == {"pos": 2}  # the batch held ahead is not lost
    loader2 = P.prepare_data_loader(_StatefulBase(), device="cpu")
    loader2.load_state_dict(sd)
    assert [int(b["x"][0]) for b in loader2] == [2, 3, 4, 5]


def test_resume_indexable_base_skips_by_index():
    class CountingSeq:
        def __init__(self):
            self.loads = []

        def __len__(self):
            return 8

        def __getitem__(self, i):
            self.loads.append(i)
            return {"x": np.full((2,), i)}

    seq = CountingSeq()
    loader = P.prepare_data_loader(seq, device="cpu")
    loader.load_state_dict({"num_batches_fetched": 5, "iteration": 0})
    assert [int(b["x"][0]) for b in loader] == [5, 6, 7]
    assert min(seq.loads) == 5


def test_between_epoch_checkpoint_does_not_replay_finished_epoch():
    def make(seed):
        torch.manual_seed(seed)
        dl = tud.DataLoader(tud.TensorDataset(torch.arange(16)), batch_size=4, shuffle=True)
        return P.prepare_data_loader(dl, device="cpu")

    loader = make(7)
    epoch0 = torch.cat([b[0] for b in loader])
    sd = loader.state_dict()
    epoch1 = torch.cat([b[0] for b in loader])
    loader2 = make(7)
    list(loader2)
    loader2.load_state_dict(sd)
    resumed = torch.cat([b[0] for b in loader2])
    assert torch.equal(resumed, epoch1) and not torch.equal(resumed, epoch0)


def test_set_epoch_clears_pending_resume_state():
    loader = P.prepare_data_loader(_StatefulBase(4), device="cpu")
    loader.load_state_dict({"num_batches_fetched": 2, "iteration": 3, "base_state": {"pos": 2}})
    loader.set_epoch(0)
    assert [int(b["x"][0]) for b in loader] == [0, 1, 2, 3]


def test_skip_first_batches_resume_via_state_dict():
    """The JAX package's ``test_checkpointing`` case: a position read from
    ``state_dict`` handed to ``Accelerator.skip_first_batches``."""
    from accelerate_tpu_torch import Accelerator

    acc = Accelerator(cpu=True)
    pdl = acc.prepare(_loader(64, 16, False, False))
    it = iter(pdl)
    next(it), next(it)
    sd = pdl.state_dict()
    assert sd["num_batches_fetched"] == 2
    assert len(list(acc.skip_first_batches(pdl, sd["num_batches_fetched"]))) == 2
