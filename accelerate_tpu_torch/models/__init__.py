from .bert import BertConfig, BertForSequenceClassification
from .convert import (
    bert_config_from_hf,
    gemma2_config_from_hf,
    gemma_config_from_hf,
    llama_config_from_hf,
    mixtral_config_from_hf,
    qwen2_config_from_hf,
    qwen3_config_from_hf,
)
from .from_jax import (
    bert_params_from_numpy,
    convnet_params_from_numpy,
    llama_params_from_numpy,
    moe_llama_params_from_numpy,
    optax_state_from_numpy,
)
from .llama import Llama, LlamaConfig
from .moe import MoELlama, MoELlamaConfig
from .vision import ConvNetConfig, ConvNetForImageClassification

__all__ = ["BertConfig", "BertForSequenceClassification", "ConvNetConfig",
           "ConvNetForImageClassification", "Llama", "LlamaConfig", "MoELlama",
           "MoELlamaConfig", "mixtral_config_from_hf", "moe_llama_params_from_numpy",
           "bert_config_from_hf", "bert_params_from_numpy", "convnet_params_from_numpy",
           "gemma2_config_from_hf",
           "gemma_config_from_hf", "llama_config_from_hf", "llama_params_from_numpy",
           "optax_state_from_numpy", "qwen2_config_from_hf", "qwen3_config_from_hf"]
