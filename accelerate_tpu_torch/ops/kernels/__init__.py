"""Hand-written CUDA kernels for Hopper and their ctypes wrappers.

Sources live in ``accelerate_tpu_torch/csrc/``; ``_build.py`` compiles them
at first use. Importing this package builds and loads nothing.

One wrapper per kernel, each paired with its plain version in
``ops/registry.py``: ``paged_gather`` (``ops/paged_attention``),
``paged_decode_cuda`` (``ops/paged_attention``), ``int8_matmul_cuda``
(``ops/int8``), ``flash_attention_cuda`` and ``splash_attention_cuda``
(``ops/attention``), ``ring_block_fwd_cuda`` and ``ring_block_bwd_cuda``
(``parallel/ring``) and ``fused_update_cuda`` (``ops/fused_update``).
"""

from .flash_attention import flash_attention_cuda
from .fused_update import fused_update_cuda
from .int8_matmul import int8_matmul_cuda
from .paged_decode import paged_decode_cuda
from .paged_gather import paged_gather
from .ring_block import ring_block_bwd_cuda, ring_block_fwd_cuda
from .splash_attention import splash_attention_cuda

__all__ = ["flash_attention_cuda", "fused_update_cuda", "int8_matmul_cuda",
           "paged_decode_cuda", "paged_gather", "ring_block_bwd_cuda", "ring_block_fwd_cuda",
           "splash_attention_cuda"]
