"""accelerate_tpu_torch — the PyTorch and CUDA port of accelerate_tpu, for NVIDIA Hopper.

The JAX package ``accelerate_tpu`` is the reference; this package keeps its
module names and layout so each counterpart is easy to find, and never
imports JAX or anything of ``accelerate_tpu``. Every TPU kernel on a ported
path becomes a CUDA kernel written by hand for ``sm_90a`` (``csrc/``), with
its plain PyTorch version beside it (``ops/registry.py``).

Ported so far: the paged serving engine (``serving.ContinuousBatcher``) on
the Llama decoder (``models/llama.py``), greedy and sampled ``generate``,
and the paged KV gather kernel; the fused training step
(``Accelerator.build_train_step``) with the optimizer transforms of
``optim.py``, causal flash attention (forward and backward) and the fused
optimizer update as kernels; int8-weight serving (``matmul_precision="int8"``)
with the int8 matmul kernel, and the fused paged decode attention
(``ops.paged_attention.paged_attention``); Gemma-2 training through the
splash attention kernel (local window, logit softcap, query scale; forward
and backward) with the vocab-chunked fused loss, and the Hugging Face
config converters of ``models/convert.py`` (Llama, Mistral, Gemma, Gemma-2,
Qwen2, Qwen3); sequence-parallel training with ring attention over
``torch.distributed`` (``Accelerator(sp_plugin=SequenceParallelPlugin(...))``,
``parallel/ring.py``) with the ring's per-block flash forward and backward
as kernels; the canonical Accelerate loop of ``examples/nlp_example.py``
(prepared loaders, ``backward``, the imperative ``optimizer.step()`` through
the fused update kernel, schedules, ``gather_for_metrics``) on BERT
(``models/bert.py``; ``python -m accelerate_tpu_torch.examples.nlp_example``).
ROADMAP.md lists what comes next.

Entry points run on the card by default and raise without one unless the
caller passes ``device="cpu"``.
"""

from . import optim
from .accelerator import Accelerator
from .data_loader import prepare_data_loader, skip_first_batches
from .generation import generate
from .launchers import debug_launcher
from .models import (
    BertConfig,
    BertForSequenceClassification,
    Llama,
    LlamaConfig,
    bert_config_from_hf,
    bert_params_from_numpy,
    gemma2_config_from_hf,
    gemma_config_from_hf,
    llama_config_from_hf,
    llama_params_from_numpy,
    optax_state_from_numpy,
    qwen2_config_from_hf,
    qwen3_config_from_hf,
)
from .ops.paged_attention import init_kv_pool
from .optim import (
    adam,
    adamw,
    constant_schedule,
    cosine_decay_schedule,
    inject_hyperparams,
    linear_schedule,
    polynomial_schedule,
    sgd,
)
from .parallel.mesh import ParallelismConfig
from .parallel.ring import LoopbackRing, ring_attention
from .serving import ContinuousBatcher
from .state import AcceleratorState, GradientState, PartialState
from .utils.dataclasses import DataLoaderConfiguration, SequenceParallelPlugin
from .utils.device import resolve_device
from .utils.memory import find_executable_batch_size, release_memory
from .utils.operations import gather, gather_object, reduce, send_to_device
from .utils.random import set_seed
from .utils.tqdm import tqdm

__all__ = [
    "Accelerator",
    "AcceleratorState",
    "BertConfig",
    "BertForSequenceClassification",
    "ContinuousBatcher",
    "DataLoaderConfiguration",
    "GradientState",
    "Llama",
    "LlamaConfig",
    "LoopbackRing",
    "ParallelismConfig",
    "PartialState",
    "SequenceParallelPlugin",
    "adam",
    "adamw",
    "bert_config_from_hf",
    "bert_params_from_numpy",
    "constant_schedule",
    "cosine_decay_schedule",
    "debug_launcher",
    "find_executable_batch_size",
    "gather",
    "gather_object",
    "gemma2_config_from_hf",
    "gemma_config_from_hf",
    "generate",
    "init_kv_pool",
    "inject_hyperparams",
    "linear_schedule",
    "llama_config_from_hf",
    "llama_params_from_numpy",
    "optax_state_from_numpy",
    "optim",
    "polynomial_schedule",
    "prepare_data_loader",
    "qwen2_config_from_hf",
    "qwen3_config_from_hf",
    "reduce",
    "release_memory",
    "resolve_device",
    "ring_attention",
    "send_to_device",
    "set_seed",
    "sgd",
    "skip_first_batches",
    "tqdm",
]
