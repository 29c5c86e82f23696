"""Kernel registry — pairs each hand-written CUDA kernel with its plain version.

The PyTorch counterpart of ``accelerate_tpu/ops/registry.py``. Every op
registers a **plain** implementation (straightforward PyTorch, the parity
seam the tests hold the JAX reference against) and a **kernel** wrapper (a
CUDA kernel written by hand for Hopper). :func:`dispatch` picks by the
tensor's device, never by what happens to be installed:

- a CPU tensor runs the plain version (that is how the CPU tests run);
- a CUDA tensor launches the kernel, and the wrapper raises if it cannot
  build or launch it — there is no fallback that hides a missing kernel;
- the explicit spec ``kernels="off"`` runs the plain version on any device.
  It exists as the comparison arm of ``chip_smoke.py``, and nothing
  selects it implicitly (no environment variable reads it).

Each wrapper counts its launches in :data:`launch_counts`, keyed by kernel
name, where it launches and nowhere else, so a run can show that its main
path really went through the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

KERNEL = "kernel"
OFF = "off"
SPECS = (KERNEL, OFF)


@dataclass
class KernelOp:
    name: str
    plain: Callable
    kernel: Callable


_OPS: dict[str, KernelOp] = {}

# Launches per kernel name since the last reset_launch_counts().
launch_counts: dict[str, int] = {}


def register_op(name: str, plain: Callable, kernel: Callable) -> None:
    _OPS[name] = KernelOp(name=name, plain=plain, kernel=kernel)


def known_ops() -> tuple:
    return tuple(sorted(_OPS))


def resolve_spec(spec: str | None) -> str:
    """``None`` means ``kernel``; any token other than kernel/off raises."""
    if spec is None:
        return KERNEL
    token = str(spec).strip().lower()
    if token not in SPECS:
        raise ValueError(f"unknown kernels spec {spec!r}; choose from {' | '.join(SPECS)}")
    return token


def dispatch(op: str, *args, kernels: str | None = None, **kwargs):
    """Run ``op``: the plain version for ``kernels="off"`` or for a first
    argument on the CPU, the kernel wrapper otherwise."""
    entry = _OPS.get(op)
    if entry is None:
        raise KeyError(f"unknown kernel op {op!r}; registered: {known_ops()}")
    if resolve_spec(kernels) == OFF or args[0].device.type == "cpu":
        return entry.plain(*args, **kwargs)
    return entry.kernel(*args, **kwargs)


def record_launch(kernel_name: str) -> None:
    launch_counts[kernel_name] = launch_counts.get(kernel_name, 0) + 1


def reset_launch_counts() -> None:
    launch_counts.clear()
