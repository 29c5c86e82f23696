"""Run state — the counterpart of ``accelerate_tpu/state.py``.

The JAX package keeps ``PartialState``, ``AcceleratorState`` and
``GradientState`` as process-wide singletons over a device mesh. The port
runs one process per rank, so they are plain objects that the
``Accelerator`` creates and owns; only the ``torch.distributed`` process
group is process-wide, as torch keeps it.

:class:`PartialState` joins the job (the counterpart of the JAX package's
``PartialState``, ``state.py:113``). Rank and world size come from the
launcher's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` (``commands/launch.py``
sets them), or from a process group the launcher already initialised; the
rendezvous is ``init_method`` (default ``env://``: ``MASTER_ADDR`` and
``MASTER_PORT``). A world of one rank is today's single process: no process
group, nothing initialised. Otherwise card ``LOCAL_RANK`` becomes the
current CUDA device (set before ``init_process_group``), so the port's
``"cuda"`` defaults (the model, the optimizer transforms) land on the
rank's card, with the NCCL backend; or, for ``device="cpu"``, the CPU with
gloo: the backend follows the device (the launch contract's
``ACCELERATE_USE_CPU`` is the launcher's ``--cpu``, which asks for
``device="cpu"``). A process group that a launcher already initialised
(``launchers.debug_launcher``) is joined as it is. A launched rank leaves
its group through :func:`teardown_process_group` when its script finishes
cleanly (``commands/rank.py``).

The launch contract (``commands/launch.py``; JAX ``state.py:139-140,
527-533``): ``ACCELERATE_USE_CPU`` means ``device="cpu"`` with gloo when no
device is passed, ``ACCELERATE_DEBUG_MODE`` turns on debug mode (the
collectives of ``utils/operations.py`` first check that every rank brings
the same shapes), and ``ACCELERATE_MIXED_PRECISION`` is the precision when
none is passed. The process-control surface of the JAX package's
``PartialState`` (``state.py:319-450``) is :class:`ProcessView`'s:
``is_last_process``, ``main_process_first``, ``local_main_process_first``,
``split_between_processes`` and the ``on_*`` decorators.
"""

from __future__ import annotations

import os
import time
import weakref
from contextlib import contextmanager
from functools import wraps
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from .parallel.mesh import MESH_AXES, ParallelismConfig
from .utils import operations as ops
from .utils.constants import ENV_CPU, ENV_DEBUG_MODE, ENV_MIXED_PRECISION
from .utils.dataclasses import PrecisionType
from .utils.device import resolve_device
from .utils.environment import parse_choice_from_env, parse_flag_from_env

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_EXIT_KEY = "accelerate_tpu_torch/exit"
_LEFT_KEY = "accelerate_tpu_torch/left"


def _store_count(store, key: str, add: int = 0) -> int:
    return int(store.add(key, add))


def teardown_process_group(timeout: float = 60.0) -> None:
    """Leave the job cleanly: wait until every rank has come here (through
    the rendezvous store, at most ``timeout`` seconds), so that no rank
    destroys its groups while a peer still works in a collective with it,
    then destroy every group. The store's host (rank 0) leaves last, after
    every other rank is past its last read of the store. A rank that does
    not come in time leaves the groups as they are: the launcher stops the
    job. Nothing on a job of one rank but the destroy."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        torch.cuda.synchronize()
    world, rank = dist.get_world_size(), dist.get_rank()
    if world > 1:
        store = dist.distributed_c10d._get_default_store()
        _store_count(store, _EXIT_KEY, 1)
        deadline = time.monotonic() + timeout
        while _store_count(store, _EXIT_KEY) < world:
            if time.monotonic() > deadline:
                return
            time.sleep(0.005)
        if rank == 0:
            while _store_count(store, _LEFT_KEY) < world - 1 and time.monotonic() < deadline:
                time.sleep(0.005)
        else:
            _store_count(store, _LEFT_KEY, 1)
    dist.destroy_process_group()


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "").strip()
    return int(value) if value else default


class ProcessView:
    """This process's rank of the job as ``torch.distributed`` (or, before
    a process group exists, the launcher's environment) reports it, without a
    device: what logging and the trackers read to decide who writes (the
    JAX package reads its ``PartialState`` singleton there).
    :class:`PartialState` adds the device and the process group."""

    def __init__(self):
        if dist.is_initialized():
            rank, world_size = dist.get_rank(), dist.get_world_size()
        else:
            rank, world_size = _env_int("RANK", 0), _env_int("WORLD_SIZE", 1)
        self.process_index, self.num_processes = rank, world_size
        self.local_process_index = _env_int("LOCAL_RANK", rank)

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    def wait_for_everyone(self) -> None:
        """A barrier over the job's ranks; nothing on one rank."""
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()

    def _goes_first(self, is_main: bool):
        if not is_main:
            self.wait_for_everyone()
        yield
        if is_main:
            self.wait_for_everyone()

    @contextmanager
    def main_process_first(self):
        """The main process runs the block first; the others wait for it,
        then run it."""
        yield from self._goes_first(self.is_main_process)

    @contextmanager
    def local_main_process_first(self):
        """The same for each node's main process."""
        yield from self._goes_first(self.is_local_main_process)

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This rank's contiguous share of a list, tuple, array, tensor or
        dict of equal-length values (each value split by rows). The first
        ``length % num_processes`` ranks take one element more; with
        ``apply_padding`` a short share is padded with the input's last
        element, so every rank holds the same length (JAX ``state.py:
        362-406``)."""
        if self.num_processes == 1:
            yield inputs
            return
        if isinstance(inputs, dict):
            lengths = {k: len(v) for k, v in inputs.items()}
            if not lengths:
                yield inputs
                return
            if len(set(lengths.values())) > 1:
                raise ValueError(f"All dict values must share a length to split; got {lengths}")
            length = next(iter(lengths.values()))
        else:
            length = len(inputs)
        split_sizes = [length // self.num_processes] * self.num_processes
        for i in range(length % self.num_processes):
            split_sizes[i] += 1
        start = sum(split_sizes[: self.process_index])
        end = start + split_sizes[self.process_index]
        if isinstance(inputs, dict):
            shard = {k: v[start:end] for k, v in inputs.items()}
        else:
            shard = inputs[start:end]
        if apply_padding and split_sizes[self.process_index] < max(split_sizes):
            pad = max(split_sizes) - split_sizes[self.process_index]
            if isinstance(inputs, dict):
                shard = {k: _pad_with_last(shard[k], pad, fallback=inputs[k]) for k in inputs}
            else:
                shard = _pad_with_last(shard, pad, fallback=inputs)
        yield shard

    def _only_if(self, function: Callable, cond: Callable[[], bool]):
        @wraps(function)
        def wrapper(*args, **kwargs):
            if cond():
                return function(*args, **kwargs)

        return wrapper

    def on_main_process(self, function: Callable = None):
        """Decorator: run ``function`` on the main process only."""
        return self._only_if(function, lambda: self.is_main_process)

    def on_local_main_process(self, function: Callable = None):
        return self._only_if(function, lambda: self.is_local_main_process)

    def on_last_process(self, function: Callable):
        return self._only_if(function, lambda: self.is_last_process)

    def on_process(self, function: Callable = None, process_index: int = None):
        """Decorator: run ``function`` on rank ``process_index`` only
        (``@state.on_process(process_index=1)`` works too)."""
        if function is None:
            return lambda f: self.on_process(f, process_index)
        return self._only_if(function, lambda: self.process_index == process_index)

    def on_local_process(self, function: Callable = None, local_process_index: int = None):
        if function is None:
            return lambda f: self.on_local_process(f, local_process_index)
        return self._only_if(function,
                             lambda: self.local_process_index == local_process_index)


def _pad_with_last(seq, pad: int, fallback=None):
    """``seq`` with ``pad`` copies of its last element; an empty share
    borrows the last element of ``fallback`` (the whole input). Arrays come
    back as numpy arrays, tensors as tensors, anything else as a list (JAX
    ``state.py:475-482``)."""
    source = seq if len(seq) else fallback
    if isinstance(seq, torch.Tensor):
        reps = [torch.as_tensor(source[-1:])] * pad
        return torch.cat([seq, *reps]) if len(seq) else torch.cat(reps)
    if isinstance(seq, np.ndarray) or hasattr(seq, "shape"):
        reps = [np.asarray(source[-1:])] * pad
        return (np.concatenate([np.asarray(seq), *reps], axis=0) if len(seq)
                else np.concatenate(reps, axis=0))
    return list(seq) + [source[-1]] * pad


class PartialState(ProcessView):
    """This process's rank of the job: ``process_index``, ``num_processes``,
    ``local_process_index`` and ``device``."""

    def __init__(self, device=None, *, init_method: str | None = None):
        if device is None and parse_flag_from_env(ENV_CPU):
            device = "cpu"
        dev = resolve_device(device)
        super().__init__()
        self.debug = ops.debug_mode = parse_flag_from_env(ENV_DEBUG_MODE)
        rank, world_size = self.process_index, self.num_processes
        if world_size == 1 and not dist.is_initialized():
            self.device = dev
            return
        if dev.type == "cuda":
            torch.cuda.set_device(self.local_process_index)
        self.device = dev
        backend = BACKENDS[dev.type]
        if not dist.is_initialized():
            dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                    world_size=world_size)
        elif dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}; a {dev.type} "
                             f"device needs {backend!r}")

    @property
    def distributed(self) -> bool:
        return self.num_processes > 1

    def print(self, *args, **kwargs) -> None:
        """``print`` on the main process only."""
        if self.is_main_process:
            print(*args, **kwargs)


class AcceleratorState:
    """The job's rank (:class:`PartialState`), its ``pp`` x ``dp`` x
    ``fsdp`` x ``ep`` x ``sp`` x ``tp`` mesh (None for a single process without
    sequence parallelism, or one that holds every rank itself,
    ``loopback``) and the mixed-precision mode (``no``, ``bf16``, ``fp16``
    or ``fp8``; ``ACCELERATE_MIXED_PRECISION`` when none is passed, else
    ``no``). ``data_group`` is the process group a batch's rows split
    over (dp x fsdp; None for the default group, when those are all the
    ranks): the pp, ep, tp and sp ranks of one data coordinate read the
    same rows, as the JAX package's ``data_batch_axes`` says.
    ``expert_group`` is the joint ep x tp group under ep x tp (None
    otherwise). ``pp_group`` is the pipeline's stage group (None without a
    pp axis)."""

    def __init__(self, mixed_precision: str | None = None, device=None,
                 parallelism_config: ParallelismConfig | None = None,
                 init_method: str | None = None, loopback: bool = False):
        if mixed_precision is None:
            mixed_precision = parse_choice_from_env(ENV_MIXED_PRECISION, "no")
        mode = str(mixed_precision).lower()
        if mode not in {p.value for p in PrecisionType}:
            raise ValueError(f"Unknown mixed_precision mode: {mixed_precision!r}; "
                             f"choose from {[p.value for p in PrecisionType]}")
        self.mixed_precision = mode
        self.partial = PartialState(device, init_method=init_method)
        self.device = self.partial.device
        cfg = parallelism_config or ParallelismConfig()
        self.parallelism_config = cfg
        self.mesh = None
        self.data_group = self.expert_group = None
        if self.partial.distributed or (cfg.sp_size > 1 and not loopback):
            self.mesh = cfg.build_mesh(self.partial.num_processes, self.device.type)
            self.data_group = self._data_group()
            self.expert_group = self._expert_group()

    def _data_group(self):
        """The dp x fsdp process group of this rank (every rank joins every
        such group's creation, as ``new_group`` asks)."""
        mesh = self.mesh
        sizes = {a: mesh[a].size() for a in MESH_AXES}
        if sizes["pp"] * sizes["ep"] * sizes["sp"] * sizes["tp"] == 1:
            return None
        if sizes["fsdp"] == 1:
            return mesh.get_group("dp")
        if sizes["dp"] == 1:
            return mesh.get_group("fsdp")
        return self._product_group(sizes, ("dp", "fsdp"))

    @staticmethod
    def _product_group(sizes: dict, axes: tuple):
        """This rank's group over the product of the mesh axes ``axes``
        (every rank joins every such group's creation)."""
        others = [a for a in MESH_AXES if a not in axes]
        mine, rank = None, dist.get_rank()

        def coords(names):
            out = [{}]
            for a in names:
                out = [dict(c, **{a: j}) for c in out for j in range(sizes[a])]
            return out

        for fixed in coords(others):
            ranks = []
            for varied in coords(axes):
                c, r = {**fixed, **varied}, 0
                for a in MESH_AXES:
                    r = r * sizes[a] + c[a]
                ranks.append(r)
            group = dist.new_group(sorted(ranks))
            if rank in ranks:
                mine = group
        return mine

    def _expert_group(self):
        """Under ep x tp, this rank's joint ep x tp group (ep major, as in
        ``parallel/tensor.py``); None otherwise."""
        sizes = {a: self.mesh[a].size() for a in MESH_AXES}
        if sizes["ep"] == 1 or sizes["tp"] == 1:
            return None
        return self._product_group(sizes, ("ep", "tp"))

    @property
    def pp_group(self):
        return None if self.mesh is None or self.pp_size == 1 else self.mesh.get_group("pp")

    @property
    def compute_dtype(self) -> torch.dtype:
        """bf16 under ``bf16`` and ``fp8`` (whose int8 products take bf16
        operands), fp16 under ``fp16``, else f32 (JAX ``state.py:589-594``)."""
        if self.mixed_precision in ("bf16", "fp8"):
            return torch.bfloat16
        return torch.float16 if self.mixed_precision == "fp16" else torch.float32

    @property
    def sp_size(self) -> int:
        return 1 if self.mesh is None else self.mesh["sp"].size()

    @property
    def tp_size(self) -> int:
        return 1 if self.mesh is None else self.mesh["tp"].size()

    @property
    def pp_size(self) -> int:
        """The pipeline's stages: the mesh's pp axis, or the configuration's
        (a loopback holds every stage in this process)."""
        return self.parallelism_config.pp_size if self.mesh is None else self.mesh["pp"].size()


class GradientState:
    """Gradient-accumulation bookkeeping (JAX ``state.py:647-710``): the
    micro-steps per update (``num_steps``), whether this micro-step ends an
    accumulation window (``sync_gradients``, set by
    ``Accelerator.accumulate``), and the stack of prepared loaders that are
    iterating, whose innermost tells ``end_of_dataloader`` and ``remainder``.
    One object per ``Accelerator``, handed to the loaders, optimizers and
    schedulers it prepares (the JAX package keeps a process-wide singleton).
    Loaders are held by weak reference, as the JAX package holds them."""

    def __init__(self, num_steps: int = 1, sync_with_dataloader: bool = True):
        if int(num_steps) < 1:
            raise ValueError(f"gradient_accumulation_steps must be >= 1, got {num_steps}")
        self.num_steps = int(num_steps)
        # True: the last batch of a loader always syncs
        # (GradientAccumulationPlugin.sync_with_dataloader).
        self.sync_with_dataloader = bool(sync_with_dataloader)
        self.sync_gradients = True
        self._dataloader_refs = []

    @property
    def active_dataloader(self):
        refs = [r() for r in self._dataloader_refs]
        refs = [r for r in refs if r is not None]
        return refs[-1] if refs else None

    @property
    def end_of_dataloader(self) -> bool:
        dl = self.active_dataloader
        return getattr(dl, "end_of_dataloader", False) if dl is not None else False

    @property
    def remainder(self) -> int:
        dl = self.active_dataloader
        return getattr(dl, "remainder", -1) if dl is not None else -1

    def _set_sync_gradients(self, sync: bool) -> None:
        self.sync_gradients = bool(sync)

    def _add_dataloader(self, dataloader) -> None:
        self._dataloader_refs.append(weakref.ref(dataloader))

    def _remove_dataloader(self, dataloader) -> None:
        self._dataloader_refs = [r for r in self._dataloader_refs
                                 if r() is not None and r() is not dataloader]
