"""accelerate_tpu_torch — the PyTorch and CUDA port of accelerate_tpu, for NVIDIA Hopper.

The JAX package ``accelerate_tpu`` is the reference; this package keeps its
module names and layout so each counterpart is easy to find, and never
imports JAX or anything of ``accelerate_tpu``. Every TPU kernel on a ported
path becomes a CUDA kernel written by hand for ``sm_90a`` (``csrc/``), with
its plain PyTorch version beside it (``ops/registry.py``).

Ported so far: the paged serving engine (``serving.ContinuousBatcher``) on
the Llama decoder (``models/llama.py``), greedy and sampled ``generate``,
and the paged KV gather kernel. ROADMAP.md lists what comes next.

Entry points run on the card by default and raise without one unless the
caller passes ``device="cpu"``.
"""

from .generation import generate
from .models import Llama, LlamaConfig, llama_params_from_numpy
from .ops.paged_attention import init_kv_pool
from .serving import ContinuousBatcher
from .utils.device import resolve_device

__all__ = [
    "ContinuousBatcher",
    "Llama",
    "LlamaConfig",
    "generate",
    "init_kv_pool",
    "llama_params_from_numpy",
    "resolve_device",
]
