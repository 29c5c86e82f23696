"""The checkpoint file-name contract and the launch contract — the port's
copy of ``accelerate_tpu/utils/constants.py:10-50, 177-186``.

Both packages write the same folder layout under the same names
(``model/``, ``optimizer.meta.pkl``, ``scheduler.bin``, ``sampler.bin``,
``random_states_<rank>.pkl``, ``checkpoint_<i>``; the safetensors export's
``model.safetensors`` and its index), so a user finds the same files
whichever package wrote them.
"""

MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
DATALOADER_NAME = "dataloader"
RNG_STATE_NAME = "random_states"
PARAMS_NAME = "params"

SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"
WEIGHTS_NAME = "model.msgpack"
WEIGHTS_INDEX_NAME = "model.msgpack.index.json"
SAFE_WEIGHTS_PATTERN_NAME = "model{suffix}.safetensors"
WEIGHTS_PATTERN_NAME = "model{suffix}.msgpack"

CHECKPOINT_DIR_PREFIX = "checkpoint"

# Where ``utils/other.write_basic_config`` writes by default.
DEFAULT_CONFIG_FOLDER = "accelerate_tpu"
DEFAULT_CONFIG_FILE = "default_config.yaml"

# The launch contract (JAX ``utils/constants.py:33-50``): what
# ``commands/launch.py`` exports to each process it starts and what the
# port's ``state.py`` and ``accelerator.py`` read. The port reads only these
# ``ACCELERATE_*`` keys (``HONOURED_ENV``); the launcher refuses a config
# field whose key no module reads. Rank, world size and the rendezvous are
# PyTorch's own ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
# ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.
ENV_PREFIX = "ACCELERATE_"
ENV_MIXED_PRECISION = "ACCELERATE_MIXED_PRECISION"
ENV_CPU = "ACCELERATE_USE_CPU"
ENV_DEBUG_MODE = "ACCELERATE_DEBUG_MODE"
ENV_MESH_SHAPE = "ACCELERATE_MESH_SHAPE"
ENV_RESTART_ATTEMPT = "ACCELERATE_RESTART_ATTEMPT"
ENV_GRADIENT_ACCUMULATION_STEPS = "ACCELERATE_GRADIENT_ACCUMULATION_STEPS"
ENV_FSDP_MIN_SHARD_SIZE = "ACCELERATE_FSDP_MIN_SHARD_SIZE"
ENV_FSDP_CPU_OFFLOAD = "ACCELERATE_FSDP_CPU_OFFLOAD"
ENV_PP_SCHEDULE = "ACCELERATE_PP_SCHEDULE"
ENV_PP_MICROBATCHES = "ACCELERATE_PP_MICROBATCHES"
ENV_PROJECT_DIR = "ACCELERATE_PROJECT_DIR"
ENV_CHECKPOINT_TOTAL_LIMIT = "ACCELERATE_CHECKPOINT_TOTAL_LIMIT"
ENV_CHECKPOINT_AUTO_NAMING = "ACCELERATE_CHECKPOINT_AUTO_NAMING"
ENV_LOG_WITH = "ACCELERATE_LOG_WITH"
ENV_TRAIN_WINDOW = "ACCELERATE_TRAIN_WINDOW"
ENV_ZERO_SHARDING = "ACCELERATE_ZERO_SHARDING"
HONOURED_ENV = (
    ENV_MIXED_PRECISION, ENV_CPU, ENV_DEBUG_MODE, ENV_MESH_SHAPE, ENV_RESTART_ATTEMPT,
    ENV_GRADIENT_ACCUMULATION_STEPS, ENV_FSDP_MIN_SHARD_SIZE, ENV_FSDP_CPU_OFFLOAD,
    ENV_PP_SCHEDULE, ENV_PP_MICROBATCHES, ENV_PROJECT_DIR, ENV_CHECKPOINT_TOTAL_LIMIT,
    ENV_CHECKPOINT_AUTO_NAMING, ENV_LOG_WITH, ENV_TRAIN_WINDOW, ENV_ZERO_SHARDING,
)
# The mesh axes of ACCELERATE_MESH_SHAPE, in the JAX package's order.
MESH_AXIS_ORDER = ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")
