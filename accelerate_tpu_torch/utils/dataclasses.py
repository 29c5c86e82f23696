"""The parts of ``accelerate_tpu/utils/dataclasses.py`` the Accelerator reads.

Only the mixed-precision names the port trains with: ``no`` (f32 compute)
and ``bf16`` (f32 master parameters, bf16 compute). ``fp16`` needs the
gradient scaler and ``fp8`` the int8 matmul path; neither is ported, and
``state.AcceleratorState`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import enum


class PrecisionType(str, enum.Enum):
    NO = "no"
    BF16 = "bf16"


# Mixed-precision modes of the JAX package that the port does not run yet.
UNPORTED_PRECISIONS = ("fp16", "fp8")
