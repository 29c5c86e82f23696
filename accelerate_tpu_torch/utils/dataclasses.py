"""The parts of ``accelerate_tpu/utils/dataclasses.py`` the Accelerator reads.

The mixed-precision modes (JAX ``utils/dataclasses.py:84-88``): ``no`` (f32
compute), ``bf16`` (f32 master parameters, bf16 compute), ``fp16`` (fp16
compute with the dynamic loss scaler of ``optimizer.GradScalerState``) and
``fp8`` (bf16 compute with the block projections through the int8 matmul,
quantization-aware training, as :class:`Fp8RecipeKwargs` describes). Also
the fp8 recipe, the sequence-parallel, tensor-parallel, pipeline-parallel
and Megatron-style plugins, the fully sharded data-parallel plugin and the
remat policies it turns on, the random streams a loader synchronizes, the
data-loader configuration and the project (checkpoint and logging folder)
configuration. The JAX package has no
tracker-type enum: trackers are named by string
(``tracking.LOGGER_TYPE_TO_CLASS``), and so are the port's.
"""

from __future__ import annotations

import copy
import enum
from dataclasses import dataclass


class KwargsHandler:
    """Base of the handlers ``Accelerator(kwargs_handlers=[...])`` takes
    (JAX ``utils/dataclasses.py:25-34``): ``to_kwargs`` is what differs
    from the defaults."""

    def to_dict(self):
        return copy.deepcopy(self.__dict__)

    def to_kwargs(self):
        default_dict = self.__class__().to_dict()
        return {k: v for k, v in self.to_dict().items() if default_dict[k] != v}


class PrecisionType(str, enum.Enum):
    NO = "no"
    BF16 = "bf16"
    FP16 = "fp16"
    FP8 = "fp8"


@dataclass
class Fp8RecipeKwargs(KwargsHandler):
    """The ``mixed_precision="fp8"`` recipe (JAX ``utils/dataclasses.py:
    225-248``): ``backend="int8"`` swaps the model's block projections to
    the int8 matmul with the straight-through backward at ``prepare``
    (quantization-aware training; ``ops/int8.py``, the kernel of
    ``csrc/int8_matmul.cu`` on the card), ``backend="bf16"`` keeps plain
    bf16 compute."""

    backend: str = "int8"  # 'int8' (QAT matmuls) | 'bf16' (cast-only fallback)

    def __post_init__(self):
        if self.backend not in ("int8", "bf16"):
            raise ValueError(f"fp8 recipe backend must be int8|bf16, got {self.backend!r}")


@dataclass
class GradientAccumulationPlugin(KwargsHandler):
    """Gradient accumulation (JAX ``utils/dataclasses.py:105-118``):
    ``num_steps`` micro-steps per update, ``sync_with_dataloader`` (the
    last batch of a loader always ends a window); ``adjust_scheduler`` and
    ``sync_each_batch`` are kept for the API, as in the JAX package, whose
    reads of them the port mirrors (none)."""

    num_steps: int = None
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False

    def __post_init__(self):
        if self.sync_with_dataloader is None:
            self.sync_with_dataloader = True


@dataclass
class AutocastKwargs(KwargsHandler):
    """The dtype policy of models prepared while it is active (JAX
    ``utils/dataclasses.py:121-130``): ``enabled=False`` computes in f32
    whatever the mixed-precision mode. ``cache_enabled`` is kept for the
    API."""

    enabled: bool = True
    cache_enabled: bool = None


@dataclass
class SequenceParallelPlugin:
    """Sequence parallelism over the mesh's ``sp`` axis (JAX
    ``utils/dataclasses.py:200-210``). ``ring_attention=True``: ring
    attention (``parallel/ring.py``); ``False``: Ulysses' head-sequence
    all-to-all (``parallel/ulysses.py``), which needs the heads of a tp rank
    to divide by ``sp_size``."""

    sp_size: int = 1
    ring_attention: bool = True


@dataclass
class TensorParallelPlugin(KwargsHandler):
    """Tensor parallelism over the mesh's ``tp`` axis (JAX
    ``utils/dataclasses.py:177-187``): the model's sharding rules put the
    heads, the MLP's columns and the vocab on ``tp`` (Megatron's split,
    ``parallel/tensor.py``)."""

    tp_size: int = 1

    def __post_init__(self):
        if self.tp_size < 1:
            raise ValueError("tp_size must be >= 1")


@dataclass
class PipelineParallelPlugin(KwargsHandler):
    """Pipeline stages over the mesh's ``pp`` axis (JAX ``utils/dataclasses.py:
    189-196``; ``parallel/pipeline.py`` runs them): ``num_microbatches`` 0
    means one microbatch a stage, ``schedule`` is ``"gpipe"`` (every
    forward, then every backward) or ``"1f1b"`` (one forward and one
    backward a tick, at most 2 x pp saved stage inputs a stage)."""

    pp_size: int = 1
    num_microbatches: int = 0
    schedule: str = "gpipe"

    def __post_init__(self):
        if self.pp_size < 1:
            raise ValueError("pp_size must be >= 1")


@dataclass
class MegatronStylePlugin(KwargsHandler):
    """Composed parallelism (JAX ``utils/dataclasses.py:213-222``): the
    mesh's tp, pp, sp and fsdp sizes in one object; ``sequence_parallelism``
    is kept for the API (sp is the ``sp_size`` axis)."""

    tp_size: int = 1
    pp_size: int = 1
    sp_size: int = 1
    fsdp_size: int = 1
    sequence_parallelism: bool = False


@dataclass
class FullyShardedDataParallelPlugin:
    """Fully sharded data parallelism over the mesh's ``fsdp`` axis (JAX
    ``utils/dataclasses.py:151-173``; ``parallel/fsdp.py`` runs it):

    - ``fsdp_size``: the axis size, -1 for every rank left over;
    - ``min_shard_size``: leaves with fewer elements stay replicated (and
      are all-reduced);
    - ``reshard_after_forward``: a layer's gathered weights are freed after
      its forward and gathered again by its backward;
    - ``activation_checkpointing``: the model's remat (``LlamaConfig.remat``)
      is turned on at ``prepare``;
    - ``state_dict_type``: ``save_state`` writes the full layout either way
      (module docstring of ``checkpointing.py``);
    - ``cpu_offload``: the imperative optimizer keeps its state (the
      moments, on the shards under fsdp) in pinned host memory between
      steps and brings it to the device only for the update (JAX
      ``accelerator.py:445-449``; ``optimizer.AcceleratedOptimizer``); the
      fused ``build_train_step`` keeps its state on the device, as the JAX
      package's does."""

    fsdp_size: int = -1
    reshard_after_forward: bool = True
    min_shard_size: int = 2**14
    cpu_offload: bool = False
    activation_checkpointing: bool = False
    state_dict_type: str = "SHARDED_STATE_DICT"

    def __post_init__(self):
        if self.state_dict_type not in ("SHARDED_STATE_DICT", "FULL_STATE_DICT"):
            raise ValueError(f"invalid state_dict_type {self.state_dict_type}")


# The remat policies of the JAX package's ``jax.checkpoint_policies`` the
# port runs (``models/llama.py``); any other name raises.
REMAT_POLICIES = ("nothing_saveable", "dots_with_no_batch_dims_saveable", "names_saveable")


def resolve_remat_policy(name: str, save_names: tuple = ()):
    """Check a config's ``remat_policy`` (JAX ``utils/dataclasses.py:
    37-63``) and return ``(name, save_names)`` for the model's checkpoint
    contexts: ``nothing_saveable`` keeps nothing, ``dots_with_no_batch_dims_
    saveable`` keeps the outputs of the weight products, ``names_saveable``
    keeps the tagged block outputs ``save_names`` (Llama's ``attn_out`` and
    ``mlp_out``)."""
    if name == "names_saveable" and not save_names:
        raise ValueError("remat_policy='names_saveable' needs a non-empty remat_save_names "
                         "tuple (the tags to keep, e.g. ('attn_out', 'mlp_out')).")
    if name not in REMAT_POLICIES:
        raise NotImplementedError(
            f"remat_policy {name!r} is not ported yet (ROADMAP.md, module queue); the port "
            f"runs {REMAT_POLICIES}")
    return name, tuple(save_names) if name == "names_saveable" else ()


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
    ``utils/dataclasses.py:288-297``). ``dispatch_batches=True``: rank 0
    reads and each rank receives its slice by a broadcast
    (``data_loader.DataLoaderDispatcher``; None: on for an iterable dataset
    over several ranks, as in the JAX package);
    ``use_stateful_dataloader`` is accepted as the JAX package accepts it
    (every prepared loader resumes mid-epoch, and a base loader with its own
    ``state_dict`` is used as one); ``non_blocking`` makes the loader's
    copies to the card asynchronous (from pinned memory)."""

    split_batches: bool = False
    dispatch_batches: bool | None = None
    even_batches: bool = True
    use_seedable_sampler: bool = False
    non_blocking: bool = False
    data_seed: int | None = None
    use_stateful_dataloader: bool = False


@dataclass
class ProjectConfiguration:
    """Checkpoint and logging folder layout (JAX ``utils/dataclasses.py:
    267-286``): ``project_dir`` holds ``checkpoints/checkpoint_<i>`` under
    ``automatic_checkpoint_naming``, ``total_limit`` bounds how many stay,
    ``iteration`` is the index of the next automatic save, and the
    trackers write under ``logging_dir`` (``project_dir`` unless set)."""

    project_dir: str = None
    logging_dir: str = None
    automatic_checkpoint_naming: bool = False
    total_limit: int = None
    iteration: int = 0
    save_on_each_node: bool = False  # kept for the API: each rank writes its own files

    def set_directories(self, project_dir: str = None):
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        if self.logging_dir is None:
            self.logging_dir = self.project_dir
