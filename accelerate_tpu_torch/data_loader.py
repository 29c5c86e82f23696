"""Sharded data loading — the counterpart of ``accelerate_tpu/data_loader.py``.

The index logic is the JAX package's, line for line (``data_loader.py:109-333,
390-657, 1117-1271``), so that both packages hand the same samples to the same
rank at the same step:

- :class:`SeedableRandomSampler`: a shuffle reseeded ``seed + epoch`` from
  numpy's ``default_rng`` every epoch;
- :class:`BatchSamplerShard`: a batch sampler dealt out over the ranks, either
  by slicing each batch (``split_batches``) or round robin, with
  ``even_batches`` completing the tail from the epoch's first batches;
- :class:`IterableDatasetShard`: an iterable dataset cut into rank slices;
- :class:`DataLoaderShard`: the prepared loader. It registers itself with the
  ``GradientState`` while it iterates, fetches one batch ahead so that
  ``end_of_dataloader`` is already true *on* the last batch, pads a short
  last batch by wrapping its own rows to the loader's batch size (static
  shapes, as the JAX package keeps them) and records the real global tail in
  ``remainder``, which ``Accelerator.gather_for_metrics`` trims to;
- :class:`SkipBatchSampler`, :func:`skip_first_batches` and
  :func:`prepare_data_loader`.

Where the JAX package yields one global array sharded over its mesh, the port
runs one process per rank: each rank's loader yields that rank's shard, numpy
leaves turned into tensors (``torch.as_tensor``) and placed on the rank's
device (asynchronously from pinned memory with ``non_blocking``).

Not ported yet: ``DataLoaderDispatcher`` (rank 0 reads, the others receive),
``DeviceBatchPrefetcher`` and mid-epoch resume (``state_dict``); they wait for
the checkpointing slice, and ``prepare_data_loader`` raises for them.
"""

from __future__ import annotations

import copy
import math
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.data as tud

from .state import GradientState
from .utils.device import resolve_device
from .utils.operations import recursively_apply, send_to_device
from .utils.random import synchronize_rng_states

_PYTORCH_DATALOADER_KWARGS = (
    "num_workers collate_fn pin_memory timeout worker_init_fn multiprocessing_context "
    "generator prefetch_factor persistent_workers pin_memory_device"
).split()


def _job() -> tuple:
    """``(num_processes, process_index)`` of the job's default group."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _to_tensor(batch):
    """Numpy leaves of a fetched batch as CPU tensors (no copy)."""
    return recursively_apply(torch.as_tensor, batch,
                             test_type=lambda x: isinstance(x, np.ndarray))


def _array_leaves(batch) -> list:
    """Leaves with a batch dimension, dict keys in sorted order (the JAX
    package's ``tree_leaves`` order)."""
    if isinstance(batch, Mapping):
        return [leaf for k in sorted(batch) for leaf in _array_leaves(batch[k])]
    if isinstance(batch, (list, tuple)):
        return [leaf for v in batch for leaf in _array_leaves(v)]
    return [batch] if isinstance(batch, torch.Tensor) and batch.dim() > 0 else []


class SeedableRandomSampler:
    """A shuffle that is the same on every rank, reseeded ``seed + epoch``
    each epoch from numpy's ``default_rng``; yields indices of
    ``data_source``."""

    def __init__(self, data_source, seed: int | None = None, epoch: int = 0, generator=None):
        self.data_source = data_source
        self.seed = seed if seed is not None else 42
        self.epoch = epoch
        self.generator = generator

    def __len__(self):
        return len(self.data_source)

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        yield from rng.permutation(len(self.data_source)).tolist()
        self.set_epoch(self.epoch + 1)

    def set_epoch(self, epoch: int):
        self.epoch = epoch


class BatchSamplerShard:
    """A batch sampler dealt out over ``num_processes`` ranks.

    ``split_batches=True``: each batch is sliced into equal rank parts (the
    batch size must divide by the ranks). ``False``: rank p takes batches p,
    p + n, ... ``even_batches`` completes the tail from the epoch's first
    samples or batches, so every rank sees as many batches."""

    def __init__(self, batch_sampler, num_processes: int = 1, process_index: int = 0,
                 split_batches: bool = False, even_batches: bool = True):
        if split_batches and getattr(batch_sampler, "batch_size", None) is not None:
            if batch_sampler.batch_size % num_processes != 0:
                raise ValueError(
                    f"batch_size {batch_sampler.batch_size} must be divisible by "
                    f"num_processes {num_processes} when split_batches=True")
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        if self.split_batches:
            return len(self.batch_sampler)
        length = len(self.batch_sampler) // self.num_processes
        rem = len(self.batch_sampler) % self.num_processes
        if rem == 0:
            return length
        if self.even_batches:
            return length + 1
        return length + 1 if self.process_index < rem else length

    def __iter__(self):
        return self._iter_with_split() if self.split_batches else self._iter_with_no_split()

    def _iter_with_split(self):
        initial_data = []
        full_size = self.batch_size
        for idx, batch in enumerate(self.batch_sampler):
            if idx == 0:
                initial_data = list(batch)
                if full_size is None:
                    full_size = len(batch)
            if len(batch) == full_size:
                batch_length = len(batch) // self.num_processes
                start = batch_length * self.process_index
                yield batch[start:start + batch_length]
            elif not self.even_batches:
                # A ragged split: a proportional slice of what is there.
                sizes = [len(batch) // self.num_processes] * self.num_processes
                for i in range(len(batch) % self.num_processes):
                    sizes[i] += 1
                start = sum(sizes[:self.process_index])
                shard = batch[start:start + sizes[self.process_index]]
                if len(shard):
                    yield shard
            else:
                # Complete from the epoch's first samples, then slice evenly.
                while len(batch) < full_size:
                    batch = list(batch) + initial_data[:full_size - len(batch)]
                per = full_size // self.num_processes
                start = per * self.process_index
                yield batch[start:start + per]

    def _iter_with_no_split(self):
        initial_batches = []
        group = []
        for idx, batch in enumerate(self.batch_sampler):
            if idx < self.num_processes:
                initial_batches.append(list(batch))
            group.append(batch)
            if len(group) == self.num_processes:
                yield group[self.process_index]
                group = []
        if len(group) > 0:
            if not self.even_batches:
                if self.process_index < len(group):
                    yield group[self.process_index]
            else:
                # Complete the group from the epoch's first batches; a short
                # final batch of this rank is also completed from the first
                # batch's samples, so every shard is rectangular.
                fill_idx = 0
                while len(group) < self.num_processes:
                    group.append(initial_batches[fill_idx % max(len(initial_batches), 1)])
                    fill_idx += 1
                batch = list(group[self.process_index])
                if (self.batch_size is not None and len(batch) < self.batch_size
                        and not self.drop_last):
                    fill = initial_batches[0] if initial_batches else batch
                    while len(batch) < self.batch_size and len(fill):
                        batch += fill[:self.batch_size - len(batch)]
                yield batch

    def set_epoch(self, epoch):
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)
        sampler = getattr(self.batch_sampler, "sampler", None)
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)


class IterableDatasetShard:
    """An iterable dataset cut into rank slices: buffer ``batch_size *
    num_processes`` items (``batch_size`` with ``split_batches``) and yield
    this rank's slice; a short last buffer is completed from the stream's
    first items."""

    def __init__(self, dataset, batch_size: int = 1, drop_last: bool = False,
                 num_processes: int = 1, process_index: int = 0, split_batches: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches

    def set_epoch(self, epoch):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        real = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        per = real // self.num_processes
        if self.drop_last:
            return (n // real) * per
        return math.ceil(n / real) * per

    def __iter__(self):
        real_batch_size = (self.batch_size if self.split_batches
                           else self.batch_size * self.num_processes)
        per_process = real_batch_size // self.num_processes
        start = per_process * self.process_index
        first_batch = None
        buffer = []
        for item in self.dataset:
            buffer.append(item)
            if len(buffer) == real_batch_size:
                yield from buffer[start:start + per_process]
                if first_batch is None:
                    first_batch = buffer.copy()
                buffer = []
        if len(buffer) > 0 and not self.drop_last:
            if first_batch is None:
                first_batch = buffer.copy()
            while len(buffer) < real_batch_size:
                buffer += first_batch[:real_batch_size - len(buffer)]
            yield from buffer[start:start + per_process]


class DataLoaderShard:
    """The prepared loader (module docstring): wraps a torch ``DataLoader``
    rebuilt over a sharded sampler, or any iterable of batches, and yields
    this rank's batches on ``device``."""

    def __init__(self, base_loader, device=None, rng_types=None, synchronized_generator=None,
                 skip_batches: int = 0, gradient_state: GradientState | None = None,
                 num_processes: int | None = None, put_on_device: bool = True,
                 _drop_last: bool = False, _non_blocking: bool = False):
        self.base_loader = base_loader
        self.device = resolve_device(device) if put_on_device else None
        self.rng_types = rng_types
        self.synchronized_generator = synchronized_generator
        self.skip_batches = skip_batches
        self.gradient_state = gradient_state if gradient_state is not None else GradientState()
        self.num_processes = num_processes if num_processes is not None else _job()[0]
        self.put_on_device = put_on_device
        self._drop_last = _drop_last
        self._non_blocking = _non_blocking
        self.iteration = 0
        self.end_of_dataloader = False
        self.remainder = -1

    # ------------------------------------------------------ gradient state
    def reset(self):
        self.end_of_dataloader = False
        self.remainder = -1

    def begin(self):
        self.reset()
        if self.batch_size is not None:
            # Known only for torch loaders; other iterables find their tail
            # while they iterate.
            try:
                length = getattr(self.dataset, "total_dataset_length", len(self.dataset))
                self.remainder = length % self.total_batch_size
            except Exception:
                pass
        self.gradient_state._add_dataloader(self)

    def end(self):
        self.gradient_state._remove_dataloader(self)

    # ---------------------------------------------------------- delegation
    @property
    def dataset(self):
        return getattr(self.base_loader, "dataset", self.base_loader)

    @property
    def batch_sampler(self):
        return getattr(self.base_loader, "batch_sampler", None)

    @property
    def batch_size(self):
        bs = getattr(self.base_loader, "batch_size", None)
        if bs is None and self.batch_sampler is not None:
            bs = getattr(self.batch_sampler, "batch_size", None)
        return bs

    @property
    def total_batch_size(self):
        """The global batch size over all ranks."""
        sampler = self.batch_sampler
        if isinstance(sampler, BatchSamplerShard):
            return (sampler.batch_size if sampler.split_batches
                    else (sampler.batch_size or 1) * sampler.num_processes)
        return (self.batch_size or 1) * self.num_processes

    @property
    def total_dataset_length(self):
        return getattr(self.dataset, "total_dataset_length", None) or len(self.dataset)

    def set_epoch(self, epoch: int):
        self.iteration = epoch
        if hasattr(self.base_loader, "set_epoch"):
            self.base_loader.set_epoch(epoch)
        if self.batch_sampler is not None and hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)
        sampler = getattr(self.base_loader, "sampler", None)
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        return max(len(self.base_loader) - self.skip_batches, 0)

    # ---------------------------------------------------------------- feed
    def _device_feed(self, batch):
        if not self.put_on_device:
            return batch
        return send_to_device(batch, self.device, non_blocking=self._non_blocking)

    @staticmethod
    def _pad_batch_to(batch, target: int):
        """A short last batch padded to ``target`` rows by wrapping its own
        rows."""

        def one(x):
            if x.dim() == 0 or x.shape[0] >= target:
                return x
            reps = math.ceil((target - x.shape[0]) / max(x.shape[0], 1))
            fill = torch.cat([x] * reps)[:target - x.shape[0]]
            return torch.cat([x, fill])

        return recursively_apply(one, batch, test_type=lambda x: isinstance(x, torch.Tensor))

    def __iter__(self):
        self.begin()
        if self.rng_types is not None:
            synchronize_rng_states(self.rng_types, self.synchronized_generator)
        self.set_epoch(self.iteration)
        effective_skip = self.skip_batches
        # Indexable iterables skip by indexing instead of loading and
        # dropping batches; torch loaders skip by counting.
        if (effective_skip > 0 and hasattr(self.base_loader, "__getitem__")
                and hasattr(self.base_loader, "__len__")
                and not isinstance(self.base_loader, tud.DataLoader)):
            n = len(self.base_loader)
            iterator = (self.base_loader[i] for i in range(min(effective_skip, n), n))
            effective_skip = 0
        else:
            iterator = iter(self.base_loader)
        skipped = 0
        # Fetch one ahead so that end_of_dataloader is set *on* the last
        # batch: accumulation must sync on it.
        current, have_current, expected_local = None, False, None
        while True:
            try:
                nxt = _to_tensor(next(iterator))
            except StopIteration:
                nxt = None
                if not have_current:
                    break
            if have_current:
                if skipped < effective_skip:
                    skipped += 1
                else:
                    is_last = nxt is None
                    if is_last:
                        self.end_of_dataloader = True
                    batch = current
                    if expected_local is None:
                        leaves = _array_leaves(batch)
                        if leaves:
                            expected_local = leaves[0].shape[0]
                    if is_last and expected_local is not None and not self._drop_last:
                        # Record the real tail and pad to the static shape.
                        leaves = _array_leaves(batch)
                        actual = leaves[0].shape[0] if leaves else expected_local
                        if actual < expected_local:
                            if self.remainder < 0:
                                # The global tail: this rank's tail times the ranks.
                                self.remainder = actual * self.num_processes
                            batch = self._pad_batch_to(batch, expected_local)
                    yield self._device_feed(batch)
            if nxt is None:
                break
            current, have_current = nxt, True
        self.iteration += 1
        self.end()


class SkipBatchSampler:
    """A batch sampler without its first ``skip_batches`` batches."""

    def __init__(self, batch_sampler, skip_batches: int = 0):
        self.batch_sampler = batch_sampler
        self.skip_batches = skip_batches

    def __iter__(self):
        for idx, batch in enumerate(self.batch_sampler):
            if idx >= self.skip_batches:
                yield batch

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        return len(self.batch_sampler) - self.skip_batches


class SkipDataLoader:
    """An iterable without its first ``skip_batches`` batches."""

    def __init__(self, dataset_or_loader, skip_batches: int = 0):
        self.base = dataset_or_loader
        self.skip_batches = skip_batches

    def __iter__(self):
        for idx, batch in enumerate(self.base):
            if idx >= self.skip_batches:
                yield batch

    def __len__(self):
        return len(self.base) - self.skip_batches


def skip_first_batches(dataloader, num_batches: int = 0):
    """A loader that starts ``num_batches`` in: a prepared loader skips
    before it places the batches on the device; any other iterable becomes a
    :class:`SkipDataLoader`."""
    if isinstance(dataloader, DataLoaderShard):
        new_loader = copy.copy(dataloader)
        new_loader.skip_batches = dataloader.skip_batches + num_batches
        return new_loader
    return SkipDataLoader(dataloader, skip_batches=num_batches)


def prepare_data_loader(dataloader, device=None, num_processes: int | None = None,
                        process_index: int | None = None, split_batches: bool = False,
                        put_on_device: bool = True, rng_types=None,
                        dispatch_batches: bool | None = None, even_batches: bool = True,
                        use_seedable_sampler: bool = False, data_seed: int | None = None,
                        non_blocking: bool = False, use_stateful_dataloader: bool = False,
                        gradient_state: GradientState | None = None):
    """Shard ``dataloader`` over the job's ranks (the JAX package's
    ``prepare_data_loader``): a torch ``DataLoader`` is rebuilt over a
    :class:`BatchSamplerShard` (or an :class:`IterableDatasetShard` of its
    iterable dataset) with its dataset, collate function and workers kept;
    any other iterable of ready batches is wrapped as it is. The loader
    places batches on ``device`` (the card unless ``device="cpu"``)."""
    job_n, job_i = _job()
    num_processes = num_processes if num_processes is not None else job_n
    process_index = process_index if process_index is not None else job_i
    if use_stateful_dataloader:
        raise NotImplementedError("use_stateful_dataloader (mid-epoch resume) is not ported yet "
                                  "(ROADMAP.md, module queue: checkpointing)")
    is_torch = isinstance(dataloader, tud.DataLoader)
    is_iterable = is_torch and isinstance(dataloader.dataset, tud.IterableDataset)
    if dispatch_batches is None:
        dispatch_batches = is_iterable and put_on_device and num_processes > 1
    if dispatch_batches:
        raise NotImplementedError(
            "DataLoaderDispatcher (dispatch_batches=True: rank 0 reads, the others receive; "
            "the JAX package's default for an iterable dataset over several ranks) is not "
            "ported yet (ROADMAP.md, module queue); pass "
            "DataLoaderConfiguration(dispatch_batches=False) to shard the stream instead")
    common = dict(device=device, put_on_device=put_on_device, gradient_state=gradient_state,
                  num_processes=num_processes)
    if not is_torch:
        return DataLoaderShard(dataloader, rng_types=rng_types, **common)

    dataset = dataloader.dataset
    kwargs = {k: getattr(dataloader, k) for k in _PYTORCH_DATALOADER_KWARGS
              if hasattr(dataloader, k)}
    synchronized_generator = None
    if is_iterable:
        new_dataset = IterableDatasetShard(
            dataset, batch_size=dataloader.batch_size, drop_last=dataloader.drop_last,
            num_processes=num_processes, process_index=process_index,
            split_batches=split_batches)
        kwargs.pop("prefetch_factor", None)
        new_bs = (dataloader.batch_size // num_processes if split_batches
                  else dataloader.batch_size)
        inner = tud.DataLoader(new_dataset, batch_size=new_bs, **kwargs)
    else:
        batch_sampler = dataloader.batch_sampler
        sampler = getattr(batch_sampler, "sampler", None)
        if use_seedable_sampler and isinstance(sampler, tud.RandomSampler):
            seedable = SeedableRandomSampler(dataset,
                                             seed=data_seed if data_seed is not None else 42)
            batch_sampler = tud.BatchSampler(seedable, batch_size=dataloader.batch_size,
                                             drop_last=dataloader.drop_last)
            synchronized_generator = seedable
        sharded_sampler = BatchSamplerShard(batch_sampler, num_processes=num_processes,
                                            process_index=process_index,
                                            split_batches=split_batches,
                                            even_batches=even_batches)
        if kwargs.get("prefetch_factor", None) is None:
            kwargs.pop("prefetch_factor", None)
        inner = tud.DataLoader(dataset, batch_sampler=sharded_sampler, **kwargs)
    return DataLoaderShard(inner, rng_types=rng_types,
                           synchronized_generator=synchronized_generator,
                           _drop_last=dataloader.drop_last, _non_blocking=non_blocking, **common)
