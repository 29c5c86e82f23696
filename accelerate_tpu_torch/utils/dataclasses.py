"""The parts of ``accelerate_tpu/utils/dataclasses.py`` the Accelerator reads.

The mixed-precision names the port trains with: ``no`` (f32 compute) and
``bf16`` (f32 master parameters, bf16 compute). ``fp16`` needs the gradient
scaler and ``fp8`` the int8 matmul path; neither is ported, and
``state.AcceleratorState`` raises ``NotImplementedError`` for them. Also
the sequence-parallel plugin, the random streams a loader synchronizes and
the data-loader configuration.
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


class RNGType(str, enum.Enum):
    """Random streams a prepared loader hands from rank 0 to every rank at
    the start of an epoch (JAX ``utils/dataclasses.py:91-101``; the port
    adds the card's stream and has no JAX key)."""

    TORCH = "torch"
    CUDA = "cuda"
    NUMPY = "numpy"
    PYTHON = "python"
    GENERATOR = "generator"


@dataclass
class DataLoaderConfiguration:
    """How ``Accelerator.prepare`` shards a loader (JAX
    ``utils/dataclasses.py:288-297``). ``dispatch_batches=True`` (rank 0
    reads, the others receive) and ``use_stateful_dataloader`` are not ported
    yet and raise at ``prepare``; ``non_blocking`` makes the loader's copies
    to the card asynchronous (from pinned memory)."""

    split_batches: bool = False
    dispatch_batches: bool | None = None
    even_batches: bool = True
    use_seedable_sampler: bool = False
    non_blocking: bool = False
    data_seed: int | None = None
    use_stateful_dataloader: bool = False
