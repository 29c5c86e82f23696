"""Run state — the counterpart of ``accelerate_tpu/state.py``.

The JAX package keeps ``AcceleratorState`` and ``GradientState`` as
process-wide singletons over a device mesh. The port runs one process on one
device for now, so both are plain objects that the ``Accelerator`` creates
and owns; nothing is shared between two accelerators of one process.
"""

from __future__ import annotations

import torch

from .utils.dataclasses import UNPORTED_PRECISIONS, PrecisionType
from .utils.device import resolve_device


class AcceleratorState:
    """Single process, one device, and the mixed-precision mode."""

    def __init__(self, mixed_precision: str | None = None, device=None):
        mode = "no" if mixed_precision is None else str(mixed_precision).lower()
        if mode in UNPORTED_PRECISIONS:
            raise NotImplementedError(
                f"mixed_precision={mode!r} is not ported yet (ROADMAP.md, module queue: "
                "the fp16 gradient scaler and the int8 matmul path)")
        if mode not in {p.value for p in PrecisionType}:
            raise ValueError(f"Unknown mixed_precision mode: {mixed_precision!r}; "
                             f"choose from {[p.value for p in PrecisionType]}")
        self.mixed_precision = mode
        self.device = resolve_device(device)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision == "bf16" else torch.float32


class GradientState:
    """Gradient-accumulation bookkeeping: the number of micro-steps per
    update."""

    def __init__(self, num_steps: int = 1):
        if int(num_steps) < 1:
            raise ValueError(f"gradient_accumulation_steps must be >= 1, got {num_steps}")
        self.num_steps = int(num_steps)
