"""Launchers — the counterpart of ``accelerate_tpu/launchers.py``.

:func:`notebook_launcher` runs a training function from a notebook or a
script (JAX ``launchers.py:30-69``): inline for one process, or one process
per card, each with the launch contract of ``commands/launch.py``
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` and ``ACCELERATE_MIXED_PRECISION``), so
that an ``Accelerator`` made inside joins the job over NCCL.
:func:`debug_launcher` runs a function in ``num_processes`` CPU ranks of
one gloo job on this host (JAX ``launchers.py:122``): it is how the tests
drive the multi-process paths without a card. From a shell, start one
process per card with ``accelerate-tpu-torch launch`` (``commands/``),
after ``accelerate-tpu-torch config``.

Every rank that finishes leaves its job through
``state.teardown_process_group``: it waits until every rank has finished,
then destroys its groups, so that no rank tears its gloo or NCCL group down
while a peer still works in a collective with it.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .state import teardown_process_group
from .utils.constants import ENV_MIXED_PRECISION
from .utils.dataclasses import PrecisionType
from .utils.device import resolve_device


def _debug_worker(rank: int, num_processes: int, store: str, function, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(num_processes), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=num_processes)
    function(*args)  # a rank that raises leaves at once, its group as it is
    teardown_process_group()


def _join(ctx, timeout: float | None, what: str):
    """Wait for the spawned ranks; a rank that raises fails the launch with
    its error, and ranks still running after ``timeout`` seconds (None: no
    limit) are killed (``TimeoutError``)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=None if deadline is None
                           else max(0.0, deadline - time.monotonic())):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{what}: ranks still running after {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()


def debug_launcher(function, args=(), num_processes: int = 2, timeout: float = 600.0):
    """Spawn ``num_processes`` CPU ranks, join them in one gloo process group
    through a file store in a fresh temporary directory (no port to collide
    on), run ``function(*args)`` in each and wait for all. ``function`` must
    be picklable (a module-level function). A rank that raises fails the
    launch with that rank's error; ranks still running after ``timeout``
    seconds are killed and the launch raises ``TimeoutError``."""
    with tempfile.TemporaryDirectory(prefix="accelerate_tpu_torch_launch_") as tmp:
        ctx = mp.start_processes(_debug_worker,
                                 args=(num_processes, os.path.join(tmp, "store"), function, args),
                                 nprocs=num_processes, join=False, start_method="spawn")
        _join(ctx, timeout, "debug_launcher")


def _notebook_worker(local_rank: int, env: dict, function, args):
    os.environ.update(env, RANK=str(int(env["NODE_RANK"]) * int(env["LOCAL_WORLD_SIZE"])
                                    + local_rank), LOCAL_RANK=str(local_rank))
    function(*args)
    teardown_process_group()


def notebook_launcher(function, args=(), num_processes: int | None = None,
                      mixed_precision: str = "no", use_port: str = "29500",
                      master_addr: str = "127.0.0.1", node_rank: int = 0, num_nodes: int = 1,
                      timeout: float | None = None):
    """Run ``function(*args)`` from a notebook or a script. The precision
    reaches the ``Accelerator`` made inside through
    ``ACCELERATE_MIXED_PRECISION`` (a value already in the environment
    wins, as in the JAX package); an unknown one raises.

    - ``num_processes`` None, 0 or 1: ``function`` runs in this process.
    - ``num_processes`` N > 1: N processes on this node, one per card
      (``torch.multiprocessing.start_processes``, ``spawn``: ``function``
      must be picklable), ranks ``node_rank * N`` to ``node_rank * N + N - 1``
      of ``num_nodes * N``, meeting at ``master_addr:use_port`` (a free
      port on one node when ``use_port`` is None). There must be N cards:
      NCCL cannot hold two ranks on one card, and the processes never fall
      back to the CPU (run ``debug_launcher`` for CPU ranks). A rank that
      raises fails the launch; ``timeout`` (seconds, None: none) kills
      ranks still running."""
    if mixed_precision not in {p.value for p in PrecisionType}:
        raise ValueError(f"Unknown mixed_precision mode: {mixed_precision!r}; choose from "
                         f"{[p.value for p in PrecisionType]}")
    if num_processes in (None, 0, 1):
        os.environ.setdefault(ENV_MIXED_PRECISION, mixed_precision)
        return function(*args)
    resolve_device(None)  # raises without a card, as every entry point does
    cards = torch.cuda.device_count()
    if num_processes > cards:
        raise ValueError(f"notebook_launcher: {num_processes} processes need as many cards; "
                         f"{cards} are visible (NCCL cannot hold two ranks on one card)")
    os.environ.setdefault(ENV_MIXED_PRECISION, mixed_precision)
    if use_port is None:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            use_port = sock.getsockname()[1]
    env = dict(WORLD_SIZE=str(num_nodes * num_processes), LOCAL_WORLD_SIZE=str(num_processes),
               NODE_RANK=str(node_rank), MASTER_ADDR=master_addr, MASTER_PORT=str(use_port),
               **{ENV_MIXED_PRECISION: os.environ[ENV_MIXED_PRECISION]})
    ctx = mp.start_processes(_notebook_worker, args=(env, function, args),
                             nprocs=num_processes, join=False, start_method="spawn")
    _join(ctx, timeout, "notebook_launcher")
