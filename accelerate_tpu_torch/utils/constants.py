"""The checkpoint file-name contract — the port's copy of
``accelerate_tpu/utils/constants.py:10-25, 181-186``.

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
