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
(``models/bert.py``; ``python -m accelerate_tpu_torch.examples.nlp_example``);
checkpoints in the JAX package's layout (``save_state`` / ``load_state``,
``save_model``; ``checkpointing.py``), mid-epoch loader resume, trackers and
multi-process logging (``tracking.py``, ``logging.py``;
``python -m accelerate_tpu_torch.examples.complete_nlp_example``); sharded
training: the fsdp axis and ZeRO over dp with the JAX package's planners
(``FullyShardedDataParallelPlugin``, ``Accelerator.zero_sharding``,
``parallel/sharding.py``, ``parallel/fsdp.py``) over ``torch.distributed``
or on one card through ``LoopbackShards``, and remat (``LlamaConfig(remat=
True)``, ``BertConfig(remat=True)``); the precision modes ``fp16`` (the loss
scaler, flash in fp16) and ``fp8`` (int8 QAT through the int8 matmul),
host-offloaded optimizer state, ``build_train_window`` fed by
``DeviceBatchPrefetcher``, ``DataLoaderDispatcher``, the train steps of
``train_steps.py`` (exported lazily, as in the JAX package) and the yarn and
dynamic rope types; pipeline parallelism (the pp axis with the GPipe and
1F1B schedules, alone and with dp, fsdp and tp: ``PipelineParallelPlugin``,
``parallel/pipeline.py``), pipelined inference (``prepare_pippy``,
``inference.py``) and optax's ``adafactor``; big-model loading and
offloaded inference (``init_empty_weights``, ``infer_auto_device_map``,
``dispatch_model`` with layers streamed from the host or disk or spread over
cards, ``load_checkpoint_and_dispatch``, weight-only int8/int4
quantization: ``big_modeling.py``, ``hooks.py``, ``utils/modeling.py``,
``utils/offload.py``, ``utils/quantization.py``, exported lazily as in the
JAX package) and the CV examples' convnet (``models/vision.py``,
``examples/cv_example.py``); the launcher and the CLI (``commands/``); and
mixture of experts with the ep axis (``MoELlama``, ``models/moe.py``,
``ops/moe.py``, ``mixtral_config_from_hf``, ``ParallelismConfig(ep_size=)``);
and Hugging Face checkpoints with the classic-GPT decoders: the state-dict
converters of ``models/convert.py`` for every decoder family the port has
and BERT (``from_hf``, ``from_hf_checkpoint``), GPT-2 (``models/gpt2.py``)
and GPT-NeoX / GPT-J / OPT (``GPTX``, ``models/gptx.py``), served, trained,
sharded and streamed as Llama is.
ROADMAP.md lists what comes next.

Entry points run on the card by default and raise without one unless the
caller passes ``device="cpu"``.
"""

from . import optim
from .accelerator import Accelerator
from .data_loader import (
    DataLoaderDispatcher,
    DeviceBatchPrefetcher,
    prepare_data_loader,
    skip_first_batches,
)
from .generation import generate
from .inference import prepare_pippy
from .launchers import debug_launcher, notebook_launcher
from .logging import get_logger
from .models import (
    GPT2,
    GPTX,
    HF_CONVERTERS,
    BertConfig,
    BertForSequenceClassification,
    ConvNetConfig,
    ConvNetForImageClassification,
    GPT2Config,
    GPTXConfig,
    Llama,
    LlamaConfig,
    MoELlama,
    MoELlamaConfig,
    bert_config_from_hf,
    bert_params_from_hf,
    bert_params_from_numpy,
    convnet_params_from_numpy,
    from_hf,
    from_hf_checkpoint,
    gemma2_config_from_hf,
    gemma2_params_from_hf,
    gemma_config_from_hf,
    gemma_params_from_hf,
    gpt2_config_from_hf,
    gpt2_params_from_hf,
    gpt2_params_from_numpy,
    gpt_neox_config_from_hf,
    gpt_neox_params_from_hf,
    gptj_config_from_hf,
    gptj_params_from_hf,
    gptx_params_from_numpy,
    llama_config_from_hf,
    llama_params_from_hf,
    llama_params_from_numpy,
    mixtral_config_from_hf,
    mixtral_params_from_hf,
    moe_llama_params_from_numpy,
    opt_config_from_hf,
    opt_params_from_hf,
    optax_state_from_numpy,
    phi3_config_from_hf,
    phi3_params_from_hf,
    qwen2_config_from_hf,
    qwen2_params_from_hf,
    qwen3_config_from_hf,
    qwen3_params_from_hf,
)
from .ops.paged_attention import init_kv_pool
from .optim import (
    adafactor,
    adam,
    adamw,
    constant_schedule,
    cosine_decay_schedule,
    inject_hyperparams,
    linear_schedule,
    polynomial_schedule,
    sgd,
)
from .parallel.fsdp import LoopbackShards
from .parallel.mesh import ParallelismConfig
from .parallel.ring import LoopbackRing, ring_attention
from .parallel.tensor import LoopbackTP
from .parallel.ulysses import ulysses_attention
from .serving import ContinuousBatcher
from .optimizer import GradScalerState
from .state import AcceleratorState, GradientState, PartialState
from .utils.dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    Fp8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    MegatronStylePlugin,
    PipelineParallelPlugin,
    ProjectConfiguration,
    SequenceParallelPlugin,
    TensorParallelPlugin,
)
from .utils.device import resolve_device
from .utils.memory import find_executable_batch_size, release_memory
from .utils.operations import gather, gather_object, reduce, send_to_device
from .utils.random import set_seed
from .utils.tqdm import tqdm
from .utils.transfer import reset_transfer_stats, transfer_stats

_TRAIN_STEPS = ("GPTTrainStep", "BertTrainStep", "T5TrainStep", "RegressionTrainStep",
                "get_train_step")
_BIG_MODELING = ("init_empty_weights", "init_on_device", "dispatch_model",
                 "load_checkpoint_and_dispatch", "cpu_offload", "disk_offload")


def __getattr__(name):
    # The train steps and the big-model entry points load on first use, as
    # in the JAX package (accelerate_tpu/__init__.py:39-57).
    if name in _TRAIN_STEPS:
        from . import train_steps

        return getattr(train_steps, name)
    if name in _BIG_MODELING:
        from . import big_modeling

        return getattr(big_modeling, name)
    if name == "infer_auto_device_map":
        from .utils.modeling import infer_auto_device_map

        return infer_auto_device_map
    if name in ("load_and_quantize_model", "QuantizationConfig"):
        from .utils import quantization

        return getattr(quantization, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Accelerator",
    "AcceleratorState",
    "AutocastKwargs",
    "BertConfig",
    "BertForSequenceClassification",
    "ContinuousBatcher",
    "ConvNetConfig",
    "ConvNetForImageClassification",
    "DataLoaderConfiguration",
    "DataLoaderDispatcher",
    "DeviceBatchPrefetcher",
    "Fp8RecipeKwargs",
    "FullyShardedDataParallelPlugin",
    "GPT2",
    "GPT2Config",
    "GPTX",
    "GPTXConfig",
    "GradScalerState",
    "GradientAccumulationPlugin",
    "GradientState",
    "Llama",
    "LlamaConfig",
    "LoopbackRing",
    "LoopbackShards",
    "LoopbackTP",
    "MegatronStylePlugin",
    "MoELlama",
    "MoELlamaConfig",
    "ParallelismConfig",
    "PipelineParallelPlugin",
    "PartialState",
    "ProjectConfiguration",
    "QuantizationConfig",
    "SequenceParallelPlugin",
    "TensorParallelPlugin",
    "adafactor",
    "adam",
    "adamw",
    "bert_params_from_numpy",
    "constant_schedule",
    "convnet_params_from_numpy",
    "cpu_offload",
    "cosine_decay_schedule",
    "debug_launcher",
    "disk_offload",
    "dispatch_model",
    "find_executable_batch_size",
    "gather",
    "gather_object",
    "generate",
    "get_logger",
    "infer_auto_device_map",
    "init_empty_weights",
    "init_kv_pool",
    "init_on_device",
    "inject_hyperparams",
    "linear_schedule",
    "notebook_launcher",
    "llama_params_from_numpy",
    "load_and_quantize_model",
    "load_checkpoint_and_dispatch",
    "moe_llama_params_from_numpy",
    "optax_state_from_numpy",
    "optim",
    "polynomial_schedule",
    "prepare_data_loader",
    "prepare_pippy",
    "reduce",
    "release_memory",
    "reset_transfer_stats",
    "resolve_device",
    "ring_attention",
    "ulysses_attention",
    "send_to_device",
    "set_seed",
    "sgd",
    "skip_first_batches",
    "tqdm",
    "transfer_stats",
    "gpt2_params_from_numpy",
    "gptx_params_from_numpy",
    *HF_CONVERTERS,
]
