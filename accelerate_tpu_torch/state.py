"""Run state — the counterpart of ``accelerate_tpu/state.py``.

The JAX package keeps ``PartialState``, ``AcceleratorState`` and
``GradientState`` as process-wide singletons over a device mesh. The port
runs one process per rank, so they are plain objects that the
``Accelerator`` creates and owns; only the ``torch.distributed`` process
group is process-wide, as torch keeps it.

:class:`PartialState` joins the job (the counterpart of the JAX package's
``PartialState``, ``state.py:113``). Rank and world size come from the
launcher's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` (``torchrun`` sets them),
or from a process group the launcher already initialised; the rendezvous is
``init_method`` (default ``env://``, torchrun's address). A world of one rank
is today's single process: no process group, nothing initialised. Otherwise
card ``LOCAL_RANK`` becomes the current CUDA device (set before
``init_process_group``), so the port's ``"cuda"`` defaults (the model, the
optimizer transforms) land on the rank's card, with the NCCL backend; or,
for ``device="cpu"``, the CPU with gloo: the backend
follows the device, never an environment variable. A process group that a
launcher already initialised (``launchers.debug_launcher``) is joined as it
is.
"""

from __future__ import annotations

import os
import weakref

import torch
import torch.distributed as dist

from .parallel.mesh import MESH_AXES, ParallelismConfig
from .utils.dataclasses import PrecisionType
from .utils.device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "").strip()
    return int(value) if value else default


class ProcessView:
    """This process's rank of the job as ``torch.distributed`` (or, before
    a process group exists, torchrun's environment) reports it, without a
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

    def wait_for_everyone(self) -> None:
        """A barrier over the job's ranks; nothing on one rank."""
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()


class PartialState(ProcessView):
    """This process's rank of the job: ``process_index``, ``num_processes``,
    ``local_process_index`` and ``device``."""

    def __init__(self, device=None, *, init_method: str | None = None):
        dev = resolve_device(device)
        super().__init__()
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
    ``fsdp`` x ``sp`` x ``tp`` mesh (None for a single process without
    sequence parallelism, or one that holds every rank itself,
    ``loopback``) and the mixed-precision mode (``no``, ``bf16``, ``fp16``
    or ``fp8``). ``data_group`` is the process group a batch's rows split
    over (dp x fsdp; None for the default group, when those are all the
    ranks): the pp, tp and sp ranks of one data coordinate read the same
    rows, as the JAX package's ``data_batch_axes`` says. ``pp_group`` is the
    pipeline's stage group (None without a pp axis)."""

    def __init__(self, mixed_precision: str | None = None, device=None,
                 parallelism_config: ParallelismConfig | None = None,
                 init_method: str | None = None, loopback: bool = False):
        mode = "no" if mixed_precision is None else str(mixed_precision).lower()
        if mode not in {p.value for p in PrecisionType}:
            raise ValueError(f"Unknown mixed_precision mode: {mixed_precision!r}; "
                             f"choose from {[p.value for p in PrecisionType]}")
        self.mixed_precision = mode
        self.partial = PartialState(device, init_method=init_method)
        self.device = self.partial.device
        cfg = parallelism_config or ParallelismConfig()
        self.parallelism_config = cfg
        self.mesh = None
        self.data_group = None
        if self.partial.distributed or (cfg.sp_size > 1 and not loopback):
            self.mesh = cfg.build_mesh(self.partial.num_processes, self.device.type)
            self.data_group = self._data_group()

    def _data_group(self):
        """The dp x fsdp process group of this rank (every rank joins every
        such group's creation, as ``new_group`` asks)."""
        mesh = self.mesh
        sizes = {a: mesh[a].size() for a in MESH_AXES}
        if sizes["pp"] * sizes["sp"] * sizes["tp"] == 1:
            return None
        if sizes["fsdp"] == 1:
            return mesh.get_group("dp")
        if sizes["dp"] == 1:
            return mesh.get_group("fsdp")
        mine, rank = None, dist.get_rank()
        for p in range(sizes["pp"]):
            for s in range(sizes["sp"]):
                for t in range(sizes["tp"]):
                    ranks = [(((p * sizes["dp"] + d) * sizes["fsdp"] + f) * sizes["sp"] + s)
                             * sizes["tp"] + t
                             for d in range(sizes["dp"]) for f in range(sizes["fsdp"])]
                    group = dist.new_group(ranks)
                    if rank in ranks:
                        mine = group
        return mine

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

    def __init__(self, num_steps: int = 1):
        if int(num_steps) < 1:
            raise ValueError(f"gradient_accumulation_steps must be >= 1, got {num_steps}")
        self.num_steps = int(num_steps)
        self.sync_with_dataloader = True  # the last batch of a loader always syncs
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
