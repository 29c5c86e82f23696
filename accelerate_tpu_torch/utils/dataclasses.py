"""The parts of ``accelerate_tpu/utils/dataclasses.py`` the Accelerator reads.

The mixed-precision names the port trains with: ``no`` (f32 compute) and
``bf16`` (f32 master parameters, bf16 compute). ``fp16`` needs the gradient
scaler and ``fp8`` the int8 matmul path; neither is ported, and
``state.AcceleratorState`` raises ``NotImplementedError`` for them. Also
the sequence-parallel plugin.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class PrecisionType(str, enum.Enum):
    NO = "no"
    BF16 = "bf16"


# Mixed-precision modes of the JAX package that the port does not run yet.
UNPORTED_PRECISIONS = ("fp16", "fp8")


@dataclass
class SequenceParallelPlugin:
    """Sequence parallelism over the mesh's ``sp`` axis (JAX
    ``utils/dataclasses.py:200-210``). ``ring_attention=True``: ring
    attention (``parallel/ring.py``); ``False`` asks for Ulysses' all-to-all,
    which is not ported yet, and the ``Accelerator`` raises for it."""

    sp_size: int = 1
    ring_attention: bool = True
