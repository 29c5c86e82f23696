from .from_jax import llama_params_from_numpy, optax_state_from_numpy
from .llama import Llama, LlamaConfig

__all__ = ["Llama", "LlamaConfig", "llama_params_from_numpy", "optax_state_from_numpy"]
