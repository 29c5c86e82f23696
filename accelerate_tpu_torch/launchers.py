"""Launchers — the counterpart of ``accelerate_tpu/launchers.py``.

:func:`debug_launcher` runs a function in ``num_processes`` CPU ranks of one
gloo job on this host (the JAX package's ``debug_launcher``,
``launchers.py:122``): it is how the tests drive the multi-process training
step without a card. On cards, launch one process per card with ``torchrun
--nproc_per_node=N``, which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
and the rendezvous address that ``state.PartialState`` reads.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch.distributed as dist
import torch.multiprocessing as mp


def _debug_worker(rank: int, num_processes: int, store: str, function, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(num_processes), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=num_processes)
    try:
        function(*args)
    finally:
        dist.destroy_process_group()


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
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"debug_launcher: ranks still running after {timeout} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
