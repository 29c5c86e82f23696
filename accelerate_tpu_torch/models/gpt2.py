"""GPT-2 in PyTorch — the counterpart of ``accelerate_tpu/models/gpt2.py``.

Learned positions, pre-LN blocks, a fused QKV projection with biases,
tanh-gelu, and the LM head tied to ``wte``. The parameter tree is the JAX
package's (``embed/wte``, ``embed/wpe``, the stacked ``layers`` with
``attn/{w_qkv,b_qkv,wo,bo}``, ``mlp/{w_in,b_in,w_out,b_out}``, ``ln_1``,
``ln_2``, and ``ln_f``), which is the classic-GPT skeleton of
``models/gptx.py`` at one point of its axes: a learned table at offset 0,
sequential residual, tanh-gelu, biases everywhere, tied head. So
:class:`GPT2` is :class:`~.gptx.GPTX` with :class:`GPT2Config` fixing those
axes, and it serves, trains, shards and streams as GPTX does.

The ``wpe`` rows are read at the token's mask-derived position, never at
the cache slot: a request admitted at a large pool offset still sees
positions 0..len-1. Positions past the table raise (a lookup would clamp
silently), and so does a cache longer than the table.
"""

from __future__ import annotations

from dataclasses import dataclass

from .gptx import GPTX, validate_gpt_config


@dataclass
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    attention_impl: str = "auto"  # 'auto' | 'dense' | 'flash'
    matmul_precision: str = "default"  # 'default' | 'int8'

    # The classic-GPT axes (models/gptx.py) GPT-2 fixes; not fields.
    position_style = "learned"
    position_offset = 0
    rotary_dim = None
    rope_theta = 10000.0
    rope_scaling = None
    parallel_residual = False
    shared_layernorm = False
    hidden_act = "gelu_tanh"
    attention_bias = True
    tie_word_embeddings = True
    lm_head_bias = False
    remat_save_names = ()

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads

    def __post_init__(self):
        validate_gpt_config(self)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        max_position_embeddings=128)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def gpt2_xl(cls, **kw):
        """``openai-community/gpt2-xl``'s ``config.json``: n_embd 1600,
        n_layer 48, n_head 25, n_positions 1024, vocab 50257 (n_inner null:
        4 x n_embd)."""
        defaults = dict(vocab_size=50257, hidden_size=1600, intermediate_size=6400,
                        num_hidden_layers=48, num_attention_heads=25,
                        max_position_embeddings=1024)
        defaults.update(kw)
        return cls(**defaults)


class GPT2(GPTX):
    """GPT-2 (module docstring). ``num_params`` and ``flops_per_token`` are
    GPTX's, which at GPT-2's axes count the JAX package's GPT-2
    parameters."""

    def sharding_rules(self):
        """The JAX package's GPT-2 rules (``models/gpt2.py:109-128``): GPTX's
        without the untied head's."""
        return [rule for rule in super().sharding_rules() if not rule[0].startswith("lm_head")]
