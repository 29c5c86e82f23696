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

Mid-epoch resume (``DataLoaderShard.state_dict`` / ``load_state_dict``, the
JAX package's ``data_loader.py:436-700``): the state holds the batches fetched
this epoch, the epoch, and a snapshot of the random stream that drew this
epoch's order, taken before the epoch's iterator was built:
``("generator", bytes)`` for the ``torch.Generator`` the sampler chain
carries, else ``("torch_global", bytes)`` of torch's global CPU stream (a
plain ``RandomSampler`` draws its seed there). A loaded state restores the
snapshot and skips the fetched batches, so the epoch goes on at the same
batch, index for index; a base loader with its own ``state_dict`` is handed
its state instead. The form is the JAX package's, so a ``sampler.bin`` that
either package wrote resumes the other's loader.

:class:`DataLoaderDispatcher` (JAX ``data_loader.py:702-842``): rank 0
reads every batch of the base loader, the batch goes to every rank by one
``broadcast_object_list`` (gloo on the CPU, NCCL on cards), and each rank
keeps its rows ``[i·B/n, (i+1)·B/n)`` on its device. ``prepare_data_loader`` builds it for
``dispatch_batches=True``, the default for an iterable dataset over several
ranks.

:class:`DeviceBatchPrefetcher` (JAX ``data_loader.py:843-1113``): a
background thread reads host batches, stacks ``window`` of them on a
leading axis (``window > 1``, for ``Accelerator.build_train_window``),
copies each from pinned memory to the device on a side CUDA stream
``prefetch`` batches ahead of the consumer, and the consumer's stream waits
on the copy's event; uploads and the consumer's waits are counted
(``utils/transfer.py``). Its ``state_dict`` reports the consumer's
position.
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
from .utils.operations import broadcast_object_list, recursively_apply, send_to_device
from .utils.transfer import host_put, record_input_wait
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


def _find_order_generator(loader):
    """The ``torch.Generator`` that draws the loader's order, found along
    the sampler chain (a prepared torch loader nests the user's sampler in
    ``BatchSamplerShard`` and a torch ``BatchSampler``), or None."""
    seen, frontier = set(), [loader]
    for _ in range(4):  # loader -> shard -> batch_sampler -> sampler
        nxt = []
        for obj in frontier:
            if id(obj) in seen or obj is None:
                continue
            seen.add(id(obj))
            gen = getattr(obj, "generator", None)
            if gen is not None and hasattr(gen, "get_state"):
                return gen
            nxt.extend([getattr(obj, "sampler", None), getattr(obj, "batch_sampler", None)])
        frontier = nxt
    return None


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
        # Mid-epoch resume: batches fetched this epoch, a loaded position
        # still to replay, the snapshot of the stream that drew this epoch's
        # order, a loaded snapshot still to restore, and a stateful base's
        # loaded and live states.
        self._num_batches_fetched = 0
        self._resume_batches = 0
        self._epoch_rng = None
        self._pending_rng = None
        self._pending_base_state = None
        self._base_state_live = None

    # ---------------------------------------------------- sampler snapshot
    def _capture_sampler_rng(self):
        """The state of the stream that will draw this epoch's order, taken
        before ``iter()`` draws from it: the sampler chain's generator, else
        torch's global stream for a torch loader; None otherwise."""
        gen = _find_order_generator(self.base_loader)
        if gen is not None:
            return ("generator", gen.get_state().numpy().tobytes())
        if isinstance(self.base_loader, tud.DataLoader):
            return ("torch_global", torch.random.get_rng_state().numpy().tobytes())
        return None

    def _restore_sampler_rng(self, snapshot):
        if snapshot is None:
            return
        kind, raw = snapshot
        state = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy())
        if kind == "generator":
            gen = _find_order_generator(self.base_loader)
            if gen is not None:
                gen.set_state(state)
        else:
            torch.random.set_rng_state(state)

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
        if self.iteration != epoch:
            # A loaded position belongs to epoch ``iteration``: another
            # epoch drops all of it (the skip, the snapshot, a base state).
            self._resume_batches = 0
            self._pending_rng = None
            self._pending_base_state = None
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
        resume = self._resume_batches
        self._resume_batches = 0
        self._num_batches_fetched = resume
        if self._pending_base_state is not None:
            # A stateful base repositions itself: no skip.
            self.base_loader.load_state_dict(self._pending_base_state)
            self._pending_base_state = None
            resume = 0
        if self._pending_rng is not None:
            # Replay the interrupted epoch's order.
            self._restore_sampler_rng(self._pending_rng)
            self._pending_rng = None
        self._epoch_rng = self._capture_sampler_rng()
        effective_skip = self.skip_batches + resume
        base_is_stateful = callable(getattr(self.base_loader, "state_dict", None))
        # Indexable iterables skip by indexing instead of loading and
        # dropping batches; torch loaders skip by counting, and a stateful
        # base by its own iterator (indexing would leave its state stale).
        if (effective_skip > 0 and not base_is_stateful
                and hasattr(self.base_loader, "__getitem__")
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
            if base_is_stateful:
                # Before the fetch: at a yield the base's state must say
                # that its next fetch returns the batch held ahead.
                self._base_state_live = self.base_loader.state_dict()
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
                    self._num_batches_fetched += 1
                    yield self._device_feed(batch)
            if nxt is None:
                break
            current, have_current = nxt, True
        self.iteration += 1
        # The epoch ran out: a state taken now resumes at the top of the
        # next epoch, with its own order.
        self._num_batches_fetched = 0
        self._base_state_live = None
        self._epoch_rng = None
        self.end()

    # ----------------------------------------------------------- resume
    def state_dict(self):
        """The position to resume at (the JAX package's form):
        ``num_batches_fetched`` and ``iteration``, the ``sampler_rng``
        snapshot of this epoch's order when there is one, and a stateful
        base's own ``base_state``. A loaded state not yet iterated reports
        itself, so a load followed by a save writes what was loaded."""
        sd = {"num_batches_fetched": max(self._num_batches_fetched, self._resume_batches),
              "iteration": self.iteration}
        rng = self._pending_rng if self._pending_rng is not None else self._epoch_rng
        if rng is not None:
            sd["sampler_rng"] = rng
        if self._pending_base_state is not None:
            sd["base_state"] = self._pending_base_state
        elif self._base_state_live is not None:
            sd["base_state"] = self._base_state_live
        return sd

    def load_state_dict(self, sd):
        """Resume at ``sd``'s position at the next iteration (its epoch
        unless :meth:`set_epoch` picks another first)."""
        self._resume_batches = sd.get("num_batches_fetched", 0)
        self.iteration = sd.get("iteration", 0)
        self._pending_rng = sd.get("sampler_rng")
        self._epoch_rng = None
        self._base_state_live = None
        base_state = sd.get("base_state")
        if base_state is not None and hasattr(self.base_loader, "load_state_dict"):
            self._pending_base_state = base_state


class DataLoaderDispatcher:
    """Rank 0 reads every batch; each rank receives its rows (JAX
    ``data_loader.py:702-842``). For iterable datasets that cannot be
    sharded by index (a stream). Each batch goes to every rank by one
    ``broadcast_object_list`` (gloo on the CPU, NCCL on cards); rank
    ``process_index`` keeps rows ``[i·B/n, (i+1)·B/n)`` of every leaf, on
    ``device``. It
    fetches one batch ahead, so ``end_of_dataloader`` is true on the last
    batch; ``skip_batches`` and a loaded position (``load_state_dict``) are
    read and dropped on rank 0, so a skip past the end yields nothing. On
    one rank it yields the base loader's batches as they are."""

    def __init__(self, base_loader, device=None, split_batches: bool = False,
                 put_on_device: bool = True, skip_batches: int = 0, _drop_last: bool = False,
                 num_processes: int | None = None, process_index: int | None = None,
                 gradient_state: GradientState | None = None):
        self.base_loader = base_loader
        self.device = resolve_device(device)
        self.split_batches = split_batches
        self.put_on_device = put_on_device
        self.skip_batches = skip_batches
        self._drop_last = _drop_last
        job_n, job_i = _job()
        self.num_processes = num_processes if num_processes is not None else job_n
        self.process_index = process_index if process_index is not None else job_i
        self.gradient_state = gradient_state if gradient_state is not None else GradientState()
        self.iteration = 0
        self.end_of_dataloader = False
        self.remainder = -1
        self._num_batches_fetched = 0
        self._resume_batches = 0

    @property
    def dataset(self):
        return getattr(self.base_loader, "dataset", self.base_loader)

    @property
    def batch_size(self):
        return getattr(self.base_loader, "batch_size", None)

    @property
    def total_batch_size(self):
        return (self.batch_size or 1) * (1 if self.split_batches else self.num_processes)

    @property
    def total_dataset_length(self):
        return len(self.dataset)

    def __len__(self):
        return max(len(self.base_loader) - self.skip_batches, 0)

    def set_epoch(self, epoch: int):
        if self.iteration != epoch:
            self._resume_batches = 0
        self.iteration = epoch
        if hasattr(self.base_loader, "set_epoch"):
            self.base_loader.set_epoch(epoch)

    def begin(self):
        self.end_of_dataloader = False
        self.remainder = -1
        self.gradient_state._add_dataloader(self)

    def end(self):
        self.gradient_state._remove_dataloader(self)

    def _fetch_and_scatter(self, iterator):
        """Rank 0 fetches and the batch goes to every rank (JAX
        ``_fetch_and_scatter``); None at the end of the stream."""
        batch = None
        if self.process_index == 0:
            try:
                batch = _to_tensor(next(iterator))
            except StopIteration:
                pass
        if self.num_processes > 1:
            payload = [batch]
            broadcast_object_list(payload, from_process=0)
            batch = payload[0]
        return batch

    def _emit(self, batch):
        """This rank's rows of a global batch, on the device (or the host
        without ``put_on_device``)."""
        n, i = self.num_processes, self.process_index

        def rows(x):
            if n == 1 or x.dim() == 0:
                return x
            per = x.shape[0] // n
            return x[i * per:(i + 1) * per]

        local = recursively_apply(rows, batch, test_type=lambda x: isinstance(x, torch.Tensor))
        if self.put_on_device:
            return send_to_device(local, self.device)
        return recursively_apply(lambda t: t.cpu(), local,
                                 test_type=lambda x: isinstance(x, torch.Tensor))

    def __iter__(self):
        self.begin()
        self.set_epoch(self.iteration)
        iterator = iter(self.base_loader) if self.process_index == 0 else None
        resume = self._resume_batches
        self._resume_batches = 0
        self._num_batches_fetched = resume
        effective_skip = self.skip_batches + resume
        skipped, prev, have_prev = 0, None, False
        while True:
            batch = self._fetch_and_scatter(iterator)
            if batch is None:
                if have_prev and skipped >= effective_skip:
                    self.end_of_dataloader = True
                    self._num_batches_fetched += 1
                    yield self._emit(prev)
                break
            if have_prev:
                if skipped < effective_skip:
                    skipped += 1
                else:
                    self._num_batches_fetched += 1
                    yield self._emit(prev)
            prev, have_prev = batch, True
        self.iteration += 1
        self._num_batches_fetched = 0
        self.end()

    def state_dict(self):
        return {"num_batches_fetched": max(self._num_batches_fetched, self._resume_batches),
                "iteration": self.iteration}

    def load_state_dict(self, sd):
        self._resume_batches = sd.get("num_batches_fetched", 0)
        self.iteration = sd.get("iteration", 0)


class DeviceBatchPrefetcher:
    """An asynchronous host-to-device input feed (JAX ``data_loader.py:
    843-1113``): the training loop should never wait for an upload.

    A background thread pulls host batches from any iterable (typically a
    prepared :class:`DataLoaderShard`, whose own device feed it suspends
    while it iterates), stacks ``window`` consecutive batches on a leading
    axis when ``window > 1`` (the batches ``Accelerator.build_train_window``
    takes; with ``window=1`` it yields plain batches; a tail that fills no
    window is dropped), and copies each from pinned memory to ``device`` on
    a side CUDA stream, ``prefetch`` batches ahead of the consumer. The
    consumer's current stream waits on the copy's event before it uses the
    batch (and the batch's memory is recorded on that stream), so no host
    thread ever waits for a copy. Leaves already on the device pass through.

    Every upload counts as a ``host_put``; a wait of the consumer for a
    batch that was not staged yet, after the first batch of an iteration
    (pipeline fill), counts as a blocking input transfer
    (``record_input_wait``): ``transfer_stats()`` measures whether the loop
    ever waited. ``state_dict`` is the wrapped loader's with the position
    rewritten to the consumer's (whole windows handed out), and the epoch's
    identity taken at its first batch, so read-ahead is replayed after a
    resume, not lost. ``device`` defaults to the wrapped loader's, else the
    card (raising without one)."""

    _SENTINEL = object()

    def __init__(self, loader, prefetch: int = 2, window: int = 1, device=None):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.loader = loader
        self.prefetch = int(prefetch)
        self.window = int(window)
        if device is None:
            device = getattr(loader, "device", None)
        self.device = resolve_device(device)
        self._consumed = 0  # base batches handed to the training loop this epoch
        self._resume_consumed = 0
        self._epoch_identity = None

    def __len__(self):
        n = len(self.loader)
        return n // self.window if self.window > 1 else n

    def _stage(self, batches, stream):
        """``window`` host batches -> one batch on the device (counted), and
        the event its copy records on ``stream`` (None on the CPU)."""
        dev = self.device

        def stack(*xs):
            xs = [torch.as_tensor(x) if isinstance(x, np.ndarray) else x for x in xs]
            if not isinstance(xs[0], torch.Tensor):
                return xs[0]
            if len(xs) == 1:
                return xs[0]
            if any(x.device != xs[0].device for x in xs):
                xs = [x.to(dev) for x in xs]
            return torch.stack(xs)

        batch = _map_leaves(stack, *batches)

        def place(b):
            def one(x):
                if not isinstance(x, torch.Tensor) or x.device.type != "cpu" or dev.type == "cpu":
                    return x
                return x.pin_memory().to(dev, non_blocking=True)

            if stream is None:
                return _map_leaves(one, b)
            with torch.cuda.stream(stream):
                out = _map_leaves(one, b)
            done = torch.cuda.Event()
            done.record(stream)
            return out, done

        # A leaf on the host is uploaded (on the CPU it stays, but the batch is
        # still counted as placed); a leaf already on the card passes through.
        host = [x for x in _leaves(batch)
                if isinstance(x, torch.Tensor) and x.device.type == "cpu"]
        if not host:
            return batch, None
        staged = host_put(batch, place)
        return staged if stream is not None else (staged, None)

    def __iter__(self):
        import atexit
        import queue
        import threading
        import time

        resume = self._resume_consumed
        self._resume_consumed = 0
        self._consumed = resume
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        # Bound now: an iterator finalized at interpreter teardown finds the
        # queue module's globals gone.
        empty = queue.Empty
        stop = threading.Event()
        box = {"error": None}
        loader = self.loader
        dev = self.device
        stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # The wrapped shard would place each batch on the device itself;
            # the prefetcher places (counted, window-shaped) instead.
            restore_put = getattr(loader, "put_on_device", None) is True
            if restore_put:
                loader.put_on_device = False
            try:
                if dev.type == "cuda" and dev.index is not None:
                    torch.cuda.set_device(dev)
                stack, first = [], True
                for batch in loader:
                    if first:
                        first = False
                        if hasattr(loader, "state_dict"):
                            ident = dict(loader.state_dict())
                            ident.pop("base_state", None)
                            ident.pop("num_batches_fetched", None)
                            self._epoch_identity = ident
                    if stop.is_set():
                        return
                    stack.append(batch)
                    if len(stack) < self.window:
                        continue
                    staged = self._stage(stack, stream)
                    stack = []
                    if not offer(staged):
                        return
            except BaseException as exc:  # raised again on the consumer's thread
                box["error"] = exc
            finally:
                if restore_put:
                    loader.put_on_device = True
                offer(self._SENTINEL)

        thread = threading.Thread(target=produce, name="accelerate-device-prefetch",
                                  daemon=True)

        def shutdown():
            # An iterator abandoned before the end leaves the producer running
            # into interpreter teardown: stop it before daemon threads freeze.
            stop.set()
            thread.join(timeout=1.0)

        atexit.register(shutdown)
        thread.start()
        delivered = False
        try:
            while True:
                waited = 0.0
                try:
                    item = q.get_nowait()
                except empty:
                    t0 = time.perf_counter()
                    item = q.get()
                    waited = time.perf_counter() - t0
                if item is self._SENTINEL:
                    if box["error"] is not None:
                        raise box["error"]
                    self._consumed = 0
                    self._epoch_identity = None
                    break
                if delivered and waited > 1e-3:
                    # The batch was not staged when the loop asked (sub-ms
                    # waits are the queue's own jitter, not a stall).
                    record_input_wait(waited)
                delivered = True
                batch, done = item
                if done is not None:
                    current = torch.cuda.current_stream(dev)
                    current.wait_event(done)
                    for t in _leaves(batch):
                        if isinstance(t, torch.Tensor) and t.is_cuda:
                            t.record_stream(current)
                self._consumed += self.window
                yield batch
        finally:
            stop.set()
            try:
                atexit.unregister(shutdown)
            except Exception:
                pass  # interpreter teardown: the atexit module may be gone
            with q.mutex:  # drop staged batches (get() would raise a torn-down Empty)
                q.queue.clear()
            thread.join(timeout=5.0)

    def state_dict(self):
        """The wrapped loader's resume state with the position rewritten to
        the consumer's (whole windows yielded) and the epoch's identity
        (iteration, sampler stream) taken at its first batch; a stateful
        base's own state (the producer's position) is dropped."""
        sd = dict(self.loader.state_dict()) if hasattr(self.loader, "state_dict") else {}
        if self._epoch_identity is not None:
            sd.update(self._epoch_identity)
        sd["num_batches_fetched"] = max(self._consumed, self._resume_consumed)
        sd.pop("base_state", None)
        return sd

    def load_state_dict(self, sd):
        self._resume_consumed = sd.get("num_batches_fetched", 0)
        self._consumed = 0
        self._epoch_identity = None
        if hasattr(self.loader, "load_state_dict"):
            self.loader.load_state_dict(sd)


def _map_leaves(fn, *batches):
    """``fn`` over the leaves of batches of one structure (dicts, lists,
    tuples)."""
    first = batches[0]
    if isinstance(first, Mapping):
        return {k: _map_leaves(fn, *(b[k] for b in batches)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map_leaves(fn, *xs) for xs in zip(*batches))
    return fn(*batches)


def _leaves(batch) -> list:
    if isinstance(batch, Mapping):
        return [leaf for v in batch.values() for leaf in _leaves(v)]
    if isinstance(batch, (list, tuple)):
        return [leaf for v in batch for leaf in _leaves(v)]
    return [batch]


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
    :class:`SkipDataLoader`. An explicit skip replaces a loaded position
    (on the copy and on ``dataloader``), so the two never add up and the
    source's next epoch starts at its top."""
    if isinstance(dataloader, DataLoaderShard):
        new_loader = copy.copy(dataloader)
        new_loader.skip_batches = dataloader.skip_batches + num_batches
        for obj in (new_loader, dataloader):
            obj._resume_batches = 0
            obj._pending_rng = None
            obj._pending_base_state = None
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
    any other iterable of ready batches is wrapped as it is. With
    ``dispatch_batches`` (None: on for an iterable dataset over several
    ranks) an iterable dataset, or any iterable that is not a torch loader,
    goes through a :class:`DataLoaderDispatcher` instead; a map-style torch
    loader is sharded by index either way, as in the JAX package. The loader
    places batches on ``device`` (the card unless ``device="cpu"``).
    ``use_stateful_dataloader`` is accepted as the JAX package accepts it:
    every prepared loader resumes mid-epoch, and a base loader with its own
    ``state_dict`` / ``load_state_dict`` is treated as stateful."""
    job_n, job_i = _job()
    num_processes = num_processes if num_processes is not None else job_n
    process_index = process_index if process_index is not None else job_i
    is_torch = isinstance(dataloader, tud.DataLoader)
    is_iterable = is_torch and isinstance(dataloader.dataset, tud.IterableDataset)
    if dispatch_batches is None:
        dispatch_batches = is_iterable and put_on_device and num_processes > 1
    if dispatch_batches and (is_iterable or not is_torch):
        # JAX data_loader.py:1210-1218, 1266-1268: rank 0 reads the stream.
        return DataLoaderDispatcher(
            dataloader, device=device, split_batches=split_batches, put_on_device=put_on_device,
            _drop_last=getattr(dataloader, "drop_last", False), num_processes=num_processes,
            process_index=process_index, gradient_state=gradient_state)
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
