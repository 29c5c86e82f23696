from .bert import BertConfig, BertForSequenceClassification
from .convert import (
    bert_config_from_hf,
    bert_params_from_hf,
    from_hf,
    from_hf_checkpoint,
    gemma2_config_from_hf,
    gemma2_params_from_hf,
    gemma_config_from_hf,
    gemma_params_from_hf,
    gpt2_config_from_hf,
    gpt2_params_from_hf,
    gpt_neox_config_from_hf,
    gpt_neox_params_from_hf,
    gptj_config_from_hf,
    gptj_params_from_hf,
    llama_config_from_hf,
    llama_params_from_hf,
    mixtral_config_from_hf,
    mixtral_params_from_hf,
    opt_config_from_hf,
    opt_params_from_hf,
    phi3_config_from_hf,
    phi3_params_from_hf,
    qwen2_config_from_hf,
    qwen2_params_from_hf,
    qwen3_config_from_hf,
    qwen3_params_from_hf,
)
from .from_jax import (
    bert_params_from_numpy,
    convnet_params_from_numpy,
    gpt2_params_from_numpy,
    gptx_params_from_numpy,
    llama_params_from_numpy,
    moe_llama_params_from_numpy,
    optax_state_from_numpy,
)
from .gpt2 import GPT2, GPT2Config
from .gptx import GPTX, GPTXConfig
from .llama import Llama, LlamaConfig
from .moe import MoELlama, MoELlamaConfig
from .vision import ConvNetConfig, ConvNetForImageClassification

# The Hugging Face converters (models/convert.py): a config and a state-dict
# converter per family, and the two entry points.
HF_CONVERTERS = (
    "bert_config_from_hf", "bert_params_from_hf", "from_hf", "from_hf_checkpoint",
    "gemma2_config_from_hf", "gemma2_params_from_hf", "gemma_config_from_hf",
    "gemma_params_from_hf", "gpt2_config_from_hf", "gpt2_params_from_hf",
    "gpt_neox_config_from_hf", "gpt_neox_params_from_hf", "gptj_config_from_hf",
    "gptj_params_from_hf", "llama_config_from_hf", "llama_params_from_hf",
    "mixtral_config_from_hf", "mixtral_params_from_hf", "opt_config_from_hf",
    "opt_params_from_hf", "phi3_config_from_hf", "phi3_params_from_hf",
    "qwen2_config_from_hf", "qwen2_params_from_hf", "qwen3_config_from_hf",
    "qwen3_params_from_hf",
)

__all__ = ["BertConfig", "BertForSequenceClassification", "ConvNetConfig",
           "ConvNetForImageClassification", "GPT2", "GPT2Config", "GPTX", "GPTXConfig",
           "Llama", "LlamaConfig", "MoELlama", "MoELlamaConfig", "bert_params_from_numpy",
           "convnet_params_from_numpy", "gpt2_params_from_numpy", "gptx_params_from_numpy",
           "llama_params_from_numpy", "moe_llama_params_from_numpy",
           "optax_state_from_numpy", *HF_CONVERTERS]
