"""Mixture-of-experts Llama — the counterpart of ``accelerate_tpu/models/moe.py``.

The decoder of ``models/llama.py`` with the SwiGLU FFN replaced by a routed
expert FFN (``ops/moe.py``): each layer holds a router ``(h, E)`` and the
expert stacks ``w_gate``/``w_up`` ``(E, h, i)`` and ``w_down`` ``(E, i, h)``,
stacked over layers like every other leaf. The router's load-balancing loss
is sown per layer as ``moe_aux``, averaged over the layers by
``Llama.apply`` (and over the microbatches under GPipe), reported as
``aux_loss`` and added to the LM loss with ``router_aux_coef``.

Expert parallelism: the expert stacks split over the ``ep`` axis on their
expert dim (``sharding_rules``), and the layer reads the expert group
(``ctx["experts"]``, ``parallel/tensor.py``) that the shard engine hands the
forward; ``ops/moe.py`` says how the routing, the ranks' experts and their
combine meet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..ops.moe import moe_ffn
from .llama import Llama, LlamaConfig


@dataclass
class MoELlamaConfig(LlamaConfig):
    num_experts: int = 8
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            max_position_embeddings=128,
            num_experts=4,
            moe_top_k=2,
        )
        defaults.update(kw)
        return cls(**defaults)


class MoELlama(Llama):
    scan_aux_keys = ("moe_aux",)

    def __init__(self, config: MoELlamaConfig, device=None):
        if config.matmul_precision != "default":
            raise ValueError("MoELlama's expert FFN takes matmul_precision='default' only "
                             "(the JAX package's MoE FFN does not go through the precision "
                             "dispatcher)")
        super().__init__(config, device=device)

    # ------------------------------------------------------------------- init
    def init(self, generator=None, dtype=torch.float32):
        """Llama's parameters with the MLP replaced by the router and the
        expert stacks: normal with std 1/sqrt(fan_in), drawn after the
        other leaves from the same generator (``generator``: a
        ``torch.Generator`` on the model's device, or an int seed)."""
        dev = self.device
        if dev.type == "meta":
            generator = None
        elif not isinstance(generator, torch.Generator):
            seed = 0 if generator is None else int(generator)
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
        params = super().init(generator, dtype)
        cfg = self.config
        h, inter, L, E = (cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers,
                          cfg.num_experts)

        def dense(shape, fan_in):
            t = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
            return t.mul_(1.0 / math.sqrt(fan_in))

        del params["layers"]["mlp"]  # the dense MLP's, freed before the experts exist
        params["layers"]["mlp"] = {
            "router": dense((L, h, E), h),
            "w_gate": dense((L, E, h, inter), h),
            "w_up": dense((L, E, h, inter), h),
            "w_down": dense((L, E, inter, h), inter),
        }
        return params

    # --------------------------------------------------------------- sharding
    def sharding_rules(self):
        """Llama's rules with the expert leaves' (JAX ``models/moe.py:80-88``):
        the layer stack on pp, the experts on ep, then the Megatron split
        over fsdp and tp."""
        rules = [
            (r"mlp/router", ("pp", "fsdp", None)),
            (r"mlp/w_(gate|up)", ("pp", "ep", "fsdp", "tp")),
            (r"mlp/w_down", ("pp", "ep", "tp", "fsdp")),
        ]
        return rules + [r for r in super().sharding_rules() if "mlp" not in r[0]]

    # ---------------------------------------------------------------- forward
    def mlp(self, layer, h2, ctx=None):
        """The routed expert FFN; sows the layer's router loss into
        ``ctx["moe_aux"]``."""
        cfg = self.config
        m = layer["mlp"]
        ctx = {} if ctx is None else ctx
        out, aux = moe_ffn(h2, m["router"], m["w_gate"], m["w_up"], m["w_down"],
                           k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor,
                           group=ctx.get("experts"), stats=ctx.get("router_stats"),
                           key=(ctx.get("microbatch", 0), ctx.get("layer")))
        ctx["moe_aux"] = aux
        return out

    def _tp_mlp(self, tp, layer, h2, ctx):
        return self.mlp(layer, h2, ctx)

    def aux_loss_coefs(self) -> dict:
        return {"moe_aux": self.config.router_aux_coef}

    def finalize_aux(self, out, aux: dict):
        a = aux.get("moe_aux")
        if a is not None:
            out["aux_loss"] = a
            if "loss" in out:
                out["loss"] = out["loss"] + self.config.router_aux_coef * a
        return out

    # -------------------------------------------------------------- estimation
    def _attn_params(self) -> int:
        cfg = self.config
        return (cfg.hidden_size * (cfg.num_attention_heads + 2 * cfg.num_key_value_heads)
                * cfg.head_dim + cfg.num_attention_heads * cfg.head_dim * cfg.hidden_size)

    def num_params(self) -> int:
        cfg = self.config
        h, inter, L, E = (cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers,
                          cfg.num_experts)
        moe = h * E + E * 3 * h * inter
        total = L * (self._attn_params() + moe + 2 * h) + cfg.vocab_size * h + h
        if not cfg.tie_word_embeddings:
            total += h * cfg.vocab_size
        return total

    def flops_per_token(self) -> float:
        """6 x the active parameters (the router and the top-k experts, not
        all E) plus attention's ``12·L·h·max_position_embeddings``."""
        cfg = self.config
        h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
        active_moe = h * cfg.num_experts + cfg.moe_top_k * 3 * h * inter
        active = L * (self._attn_params() + active_moe + 2 * h) + cfg.vocab_size * h + h
        if not cfg.tie_word_embeddings:
            active += h * cfg.vocab_size
        return 6 * active + 12 * L * h * cfg.max_position_embeddings
