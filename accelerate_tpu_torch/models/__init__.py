from .bert import BertConfig, BertForSequenceClassification
from .convert import (
    bert_config_from_hf,
    gemma2_config_from_hf,
    gemma_config_from_hf,
    llama_config_from_hf,
    qwen2_config_from_hf,
    qwen3_config_from_hf,
)
from .from_jax import bert_params_from_numpy, llama_params_from_numpy, optax_state_from_numpy
from .llama import Llama, LlamaConfig

__all__ = ["BertConfig", "BertForSequenceClassification", "Llama", "LlamaConfig",
           "bert_config_from_hf", "bert_params_from_numpy", "gemma2_config_from_hf",
           "gemma_config_from_hf", "llama_config_from_hf", "llama_params_from_numpy",
           "optax_state_from_numpy", "qwen2_config_from_hf", "qwen3_config_from_hf"]
