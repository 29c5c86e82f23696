"""Llama-family decoder in PyTorch — the counterpart of ``accelerate_tpu/models/llama.py``.

The JAX package's layout is kept so that parameters carry across by name
(``models/from_jax.py``) and both packages compute the same function:

- per-layer weights are stacked with a leading ``L`` dim, and projections are
  stored (in_dim, out_dim) so every projection is one ``x @ W``;
- the untied LM head is ``(h, V)``;
- GQA with ``n_kv_heads <= n_heads``; the cached path groups queries so the
  repeat never materializes (``ops/attention.cached_attention``).

PyTorch runs eagerly, so the JAX ``lax.scan`` over the layer stack is a plain
loop over layer indices, and the per-layer window of mixed-regime models
(``layer_windows``) is read per layer instead of per scan segment.

With ``labels`` the head adds the shifted-label cross-entropy
(``ops/losses.py``), which is what the training step differentiates. With
``fused_loss=True`` it computes that loss by the vocab-chunked streaming
logsumexp straight from the hidden states (``fused_cross_entropy_loss``,
with Gemma-2's final softcap per chunk and the tied (V, h) table read in
place) and returns the loss without logits. Its knobs are the config's
``fused_loss_*`` fields; the JAX package's ``ACCELERATE_FUSED_LOSS_*``
environment overrides are not ported (no environment variable sets
them).

The uncached forward's attention goes through ``ops/attention.attention``:
Gemma-2's windowed, softcapped and scaled layers resolve to the splash
kernel on the card, plain causal layers to flash.

Sequence parallelism (``attention_impl="ring"``, which the ``Accelerator``
sets under an ``sp`` axis): ``apply`` takes this rank's shard of the
sequence with its GLOBAL ``positions`` (rope), the sp process group
(``sp_group``, handed to ring attention), ``targets`` (the labels already
shifted on the global sequence, ``utils/transfer.shard_batch``) in place of
``labels``, and ``loss_normalizer``, the valid-target count over every rank,
so each rank's loss is its share of the global mean.

``matmul_precision="int8"`` sends the seven block projections (wq, wk, wv,
wo, gate, up, down) through ``ops/int8.matmul``, whose forward is the int8
matmul kernel on the card; the embedding and the LM head stay exact, as in
the JAX package.

Remat (``remat=True``; JAX ``models/llama.py:726-732``): under autograd each
block runs inside ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``, so the backward runs the block's forward again in
place of keeping its activations. ``remat_policy`` picks what the region
keeps anyway: ``nothing_saveable`` nothing; ``dots_with_no_batch_dims_
saveable`` the outputs of the weight products (``aten.mm``; attention's
batched products are recomputed, as JAX keeps none); ``names_saveable`` the
block's tagged outputs among ``remat_save_names``, the attention projection
(``attn_out``) and the MLP's down projection (``mlp_out``), JAX's
``checkpoint_name`` tags. Kept values equal recomputed ones, so every
policy gives the plain step's numbers bitwise. A sharded model
(``parallel/fsdp.py``) gathers each layer inside the region, so remat frees
the gathered weights after the forward and gathers them again for the
backward.

``sharding_rules`` are the JAX package's ``(path_regex, spec)`` rules, which
``parallel/sharding.plan_param_shardings`` reads under an fsdp or tp axis.

Rope types: ``default``, ``linear``, ``llama3``, ``yarn`` (with its
attention factor on cos and sin) and ``dynamic`` (NTK, the base stretched
past the pretraining window; the cached decode pins the length to the
cache's, as the JAX package does).

Tensor parallelism (``tp``, the sharded step of ``parallel/fsdp.py``):
``apply`` takes ``tp``, a ``parallel/tensor`` context, and a tree whose
leaves split over tp by the rules below are lists of the pieces of the tp
ranks this process holds. The block then runs Megatron's split
(:meth:`Llama.block`): wq, wk, wv, w_gate and w_up column-parallel, wo
and w_down row-parallel and summed over tp, the embedding and the LM head
vocab-parallel (``parallel/tensor.vocab_parallel_embedding``,
``ops/losses.vocab_parallel_*``). A rank attends with its own query heads
(8 of Llama-3-8B's 32 at tp 4) through the attention op, flash on the card.
Where a rule was relaxed, or a rank's KV columns end in the middle of a head
(2 KV heads at tp 4), the projection's output is gathered over tp and each
rank takes the heads its queries read; where the query heads do not divide
by tp, every rank attends with all heads and keeps the columns its wo rows
read. Every replicated value that per-rank work reads goes through
``tp.copy``, so the norms' and biases' gradients are whole on every rank.

``attention_impl="ulysses"`` is Ulysses sequence parallelism
(``parallel/ulysses.py``): under an ``sp`` axis, ``sp_group`` is handed to
it as to the ring.

Pipeline parallelism (``pipeline=spec``, a ``parallel/pipeline.PipelineSpec``;
``pipeline_capable``): the layer stack runs through the GPipe schedule of
``spec.run`` over :meth:`Llama.run_layers`, each stage on its block of
layers (Gemma-2's windows read per global layer index, JAX's
``_window_segments`` per stage); the embedding and the head run around it
as without the pipeline. The 1F1B schedule drives :meth:`Llama.embed`,
:meth:`Llama.run_layers` and :meth:`Llama.head` itself
(``parallel/pipeline.train_1f1b``).

Auxiliary losses (JAX ``models/llama.py:335-340, 545-550, 667-676,
735-742``): a model whose block sows per-layer values (the MoE router loss,
``models/moe.py``) names their keys in ``scan_aux_keys``; the block's MLP
writes each into the per-layer context it is given, :meth:`Llama.run_layers`
returns their sums over its layers (out of the remat region, as the JAX scan
returns them), :meth:`Llama.apply` divides by the layer count (GPipe: by
layers times microbatches) and :meth:`Llama.finalize_aux` folds them into the
output. ``aux_loss_coefs`` tells the 1F1B schedule how each enters the loss.
The dense model has none.
"""

from __future__ import annotations

import contextvars
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..modules import ModelOutput, Module
from ..ops.attention import attention as _attention
from ..ops.attention import cached_attention, softcap_scores
from ..ops.int8 import PRECISIONS
from ..ops.int8 import matmul as _precision_matmul
from ..ops.losses import (
    cross_entropy_loss,
    fused_cross_entropy_loss,
    vocab_parallel_cross_entropy,
    vocab_parallel_fused_cross_entropy,
)
from ..parallel.tensor import LoopbackTP, vocab_parallel_embedding
from ..utils.dataclasses import resolve_remat_policy
from ..utils.device import host_to_device, resolve_device

# The tp context of a model whose weights are whole: one piece, no collectives.
_WHOLE = LoopbackTP(1)


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    attention_impl: str = "auto"  # 'auto' | 'dense' | 'flash' | 'splash' | 'ring' | 'ulysses'
    matmul_precision: str = "default"  # 'default' | 'int8'
    # QKV projection biases (the Qwen2 recipe; Llama proper is bias-free).
    attention_bias: bool = False
    # Per-head RMSNorm on Q and K after the head reshape, before rope (Qwen3).
    qk_norm: bool = False
    # Sliding-window attention (Mistral): None = full causal.
    sliding_window: int | None = None
    # RoPE scaling: None, or a dict with rope_type 'linear', 'llama3', 'yarn'
    # or 'dynamic' (NTK-aware). Matches the HF config field.
    rope_scaling: dict | None = None
    # Per-head width; None = hidden/heads.
    head_dim: int | None = None
    # FFN activation: 'silu' (SwiGLU) or 'gelu_tanh' (GeGLU, Gemma).
    hidden_act: str = "silu"
    # Embedding-lookup scale (Gemma); the tied LM head is NOT scaled.
    embedding_multiplier: float = 1.0
    # Per-layer window sizes (None entry = full attention) for models mixing
    # attention regimes across depth (Gemma-2, Qwen2 max_window_layers).
    layer_windows: tuple | None = None
    # Gemma-2 score shaping.
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    query_pre_attn_scalar: float | None = None
    # Gemma-2 sandwich norms (four norms per layer instead of two).
    sandwich_norms: bool = False
    # Compute the training loss by vocab-chunked streaming logsumexp straight
    # from hidden states (ops/losses.fused_cross_entropy_loss); outputs carry
    # the loss and no logits when it engages. fused_loss_unroll (the JAX
    # chunk scan's unroll) is validated here and has no effect in eager
    # PyTorch, where the chunk loop is a Python loop.
    fused_loss: bool = False
    fused_loss_chunk: int = 8192
    fused_loss_dtype: str = "fp32"
    fused_loss_unroll: int = 1
    fused_loss_backward: str = "custom"
    remat_save_names: tuple = ("attn_out", "mlp_out")

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if self.hidden_act not in ("silu", "gelu_tanh"):
            raise ValueError(f"hidden_act must be silu|gelu_tanh, got {self.hidden_act!r}")
        if self.fused_loss_chunk <= 0:
            raise ValueError(f"fused_loss_chunk must be > 0, got {self.fused_loss_chunk}")
        if self.fused_loss_dtype not in ("fp32", "bf16"):
            raise ValueError(
                f"fused_loss_dtype must be fp32|bf16, got {self.fused_loss_dtype!r}"
            )
        if self.fused_loss_unroll < 0:
            raise ValueError(f"fused_loss_unroll must be >= 0, got {self.fused_loss_unroll}")
        if self.fused_loss_backward not in ("custom", "ad"):
            raise ValueError(
                f"fused_loss_backward must be custom|ad, got {self.fused_loss_backward!r}"
            )
        self.remat_save_names = tuple(self.remat_save_names)
        if self.layer_windows is not None:
            self.layer_windows = tuple(self.layer_windows)
            if len(self.layer_windows) != self.num_hidden_layers:
                raise ValueError(
                    f"layer_windows has {len(self.layer_windows)} entries for "
                    f"{self.num_hidden_layers} layers"
                )
            if len(set(self.layer_windows)) == 1:
                self.sliding_window = self.layer_windows[0]
                self.layer_windows = None

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
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def llama3_8b(cls, **kw):
        defaults = dict(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_hidden_layers=32,
            num_attention_heads=32,
            num_key_value_heads=8,
            rope_theta=500000.0,
            max_position_embeddings=8192,
        )
        defaults.update(kw)
        return cls(**defaults)


def rms_norm(x, weight, eps):
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * weight).to(dtype)


SUPPORTED_ROPE_TYPES = ("default", "linear", "llama3", "yarn", "dynamic")


def _llama3_scale_inv_freq(inv_freq, scaling: dict):
    """Llama-3.1 frequency-banded RoPE scaling: low-frequency components are
    divided by ``factor``, high-frequency kept, the band between smoothly
    interpolated (numpy, the same expression as the JAX package)."""
    factor = scaling.get("factor", 8.0)
    low = scaling.get("low_freq_factor", 1.0)
    high = scaling.get("high_freq_factor", 4.0)
    original_max = scaling.get("original_max_position_embeddings", 8192)

    wavelen = 2.0 * np.pi / inv_freq
    low_freq_wavelen = original_max / low
    high_freq_wavelen = original_max / high
    smooth = (original_max / wavelen - low) / (high - low)
    smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    scaled = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    is_medium = (wavelen >= high_freq_wavelen) & (wavelen <= low_freq_wavelen)
    return np.where(is_medium, smoothed, scaled).astype(np.float32)


def _yarn_inv_freq(head_dim, theta, scaling: dict):
    """YaRN frequency blending (JAX ``models/llama.py:229-272``, the public
    recipe of transformers' ``_compute_yarn_parameters``): low-frequency
    components interpolate (divided by ``factor``), high-frequency ones
    extrapolate (unchanged), with a linear ramp between the correction dims
    of ``beta_fast`` and ``beta_slow``. Returns ``(inv_freq,
    attention_factor)``; the factor scales cos and sin. Numpy f32, the JAX
    expression step for step."""
    dim = head_dim
    factor = float(scaling.get("factor", 1.0))
    original_max = scaling.get("original_max_position_embeddings") or scaling.get(
        "max_position_embeddings", 4096)
    beta_fast = scaling.get("beta_fast") or 32
    beta_slow = scaling.get("beta_slow") or 1
    attention_factor = scaling.get("attention_factor")
    mscale, mscale_all = scaling.get("mscale"), scaling.get("mscale_all_dim")

    def get_mscale(scale, m=1):
        return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

    if attention_factor is None:
        if mscale and mscale_all:
            attention_factor = get_mscale(factor, mscale) / get_mscale(factor, mscale_all)
        else:
            attention_factor = get_mscale(factor)

    def correction_dim(num_rot):
        return (dim * math.log(original_max / (num_rot * 2 * math.pi))) / (2 * math.log(theta))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if scaling.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    pos_freqs = theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
    extrapolation = 1.0 / pos_freqs
    interpolation = 1.0 / (factor * pos_freqs)
    ramp = np.clip((np.arange(dim // 2, dtype=np.float32) - low) / (high - low), 0, 1)
    extrapolation_factor = 1.0 - ramp
    inv_freq = interpolation * (1 - extrapolation_factor) + extrapolation * extrapolation_factor
    return inv_freq.astype(np.float32), float(attention_factor)


def rope_tables(positions, head_dim, theta, scaling: dict | None = None,
                seq_len: int | None = None, max_position_embeddings: int | None = None):
    """cos/sin tables for rotary embeddings, fp32. positions: (B, S) int.

    ``seq_len`` and ``max_position_embeddings`` feed the ``dynamic`` (NTK)
    rope type, whose base stretches when the forward's length exceeds the
    pretraining window (JAX ``models/llama.py:276-306``); the cached decode
    passes the cache's length, so prefill and every decode step share one
    set of frequencies. ``yarn`` scales cos and sin by its attention
    factor."""
    rope_type = scaling.get("rope_type", scaling.get("type", "default")) if scaling else "default"
    if rope_type not in (None,) + SUPPORTED_ROPE_TYPES:
        raise ValueError(f"Unsupported rope_type {rope_type!r} (supported: {SUPPORTED_ROPE_TYPES})")
    attention_factor = 1.0
    if rope_type == "dynamic":
        max_pos = max_position_embeddings or scaling.get("max_position_embeddings", 2048)
        eff = max(seq_len or max_pos, max_pos)
        factor = float(scaling.get("factor", 1.0))
        theta = theta * ((factor * eff / max_pos) - (factor - 1)) ** (head_dim / (head_dim - 2))
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    if rope_type == "linear":
        inv_freq = inv_freq / float(scaling.get("factor", 1.0))
    elif rope_type == "llama3":
        inv_freq = _llama3_scale_inv_freq(inv_freq, scaling)
    elif rope_type == "yarn":
        if "original_max_position_embeddings" not in scaling and max_position_embeddings:
            scaling = {**scaling, "max_position_embeddings": max_position_embeddings}
        inv_freq, attention_factor = _yarn_inv_freq(head_dim, theta, scaling)
    inv = host_to_device(np.asarray(inv_freq, np.float32), positions.device)
    angles = positions[..., None].float() * inv  # (B,S,D/2)
    if attention_factor == 1.0:
        return torch.cos(angles), torch.sin(angles)
    return torch.cos(angles) * attention_factor, torch.sin(angles) * attention_factor


def apply_rope(x, cos, sin):
    """x: (B, S, H, D). Rotate the [:D/2], [D/2:] halves (Llama convention)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def _index_tree(tree, i):
    """Layer ``i`` of a stacked ``(L, ...)`` parameter tree (views, no copies)."""
    return {k: _index_tree(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# The block output a remat region is computing (``names_saveable``): set
# around the attention and MLP output projections, read by the policy.
_REMAT_TAG = contextvars.ContextVar("accelerate_tpu_torch_remat_tag", default=None)


def _tagged(name, fn, *args):
    """``fn(*args)`` with the remat tag ``name`` set (JAX's
    ``checkpoint_name``)."""
    token = _REMAT_TAG.set(name)
    try:
        return fn(*args)
    finally:
        _REMAT_TAG.reset(token)


def _remat_context_fn(policy: str, save_names: tuple):
    """The ``context_fn`` of ``checkpoint`` for a remat policy, or None for
    ``nothing_saveable`` (plain checkpointing)."""
    if policy == "nothing_saveable":
        return None
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    aten = torch.ops.aten
    dots = {aten.mm.default, aten.addmm.default}

    def keep(ctx, op, *args, **kwargs):
        if policy == "dots_with_no_batch_dims_saveable":
            save = op in dots
        else:
            save = _REMAT_TAG.get() in save_names
        return CheckpointPolicy.MUST_SAVE if save else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, keep)


class Llama(Module):
    _WINDOW_FROM_CONFIG = object()  # sentinel: use cfg.sliding_window
    # The embed / block / head stage protocol the pipeline schedules drive.
    pipeline_capable = True
    # Context keys a block sows per layer (the MoE router loss); none here.
    scan_aux_keys: tuple = ()

    def aux_loss_coefs(self) -> dict:
        """How each ``scan_aux_keys`` entry enters the total loss (its
        coefficient); the 1F1B schedule reads it. It must agree with
        :meth:`finalize_aux`."""
        return {}

    def finalize_aux(self, out, aux: dict):
        """Fold the per-layer means of the sown values into the output (the
        dense model has none)."""
        return out

    def __init__(self, config: LlamaConfig, device=None):
        resolve_remat_policy(config.remat_policy, config.remat_save_names)
        if config.matmul_precision not in PRECISIONS:
            raise ValueError(f"matmul precision must be 'default' or 'int8', "
                             f"got {config.matmul_precision!r}")
        self.config = config
        self.device = resolve_device(device)
        self.params = None

    # ------------------------------------------------------------------- init
    def init(self, generator=None, dtype=torch.float32):
        """Random parameters from ``generator`` (a ``torch.Generator`` on the
        model's device, or an int seed): normal with std 1/sqrt(fan_in) for
        projections and embeddings, ones for norm scales, zeros for biases."""
        cfg = self.config
        dev = self.device
        if dev.type == "meta":  # shapes only (models/from_jax.py)
            generator = None
        elif not isinstance(generator, torch.Generator):
            seed = 0 if generator is None else int(generator)
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
        h, inter = cfg.hidden_size, cfg.intermediate_size
        hd = cfg.head_dim
        nh, nkv, L = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.num_hidden_layers

        def dense(shape, fan_in):
            t = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
            return t.mul_(1.0 / math.sqrt(fan_in))

        def const(shape, value):
            return torch.full(shape, value, device=dev, dtype=dtype)

        attn = {
            "wq": dense((L, h, nh * hd), h),
            "wk": dense((L, h, nkv * hd), h),
            "wv": dense((L, h, nkv * hd), h),
            "wo": dense((L, nh * hd, h), nh * hd),
        }
        if cfg.attention_bias:
            attn.update(bq=const((L, nh * hd), 0.0), bk=const((L, nkv * hd), 0.0),
                        bv=const((L, nkv * hd), 0.0))
        if cfg.qk_norm:
            attn.update(q_norm=const((L, hd), 1.0), k_norm=const((L, hd), 1.0))
        layers = {
            "attn": attn,
            "mlp": {
                "w_gate": dense((L, h, inter), h),
                "w_up": dense((L, h, inter), h),
                "w_down": dense((L, inter, h), inter),
            },
            "input_norm": {"weight": const((L, h), 1.0)},
            "post_attn_norm": {"weight": const((L, h), 1.0)},
        }
        if cfg.sandwich_norms:
            layers["pre_ffw_norm"] = {"weight": const((L, h), 1.0)}
            layers["post_ffw_norm"] = {"weight": const((L, h), 1.0)}
        params = {
            "embed": {"weight": dense((cfg.vocab_size, h), h)},
            "layers": layers,
            "final_norm": {"weight": const((h,), 1.0)},
        }
        if not cfg.tie_word_embeddings:
            params["lm_head"] = {"weight": dense((h, cfg.vocab_size), h)}
        return params

    # ---------------------------------------------------------------- forward
    def embed(self, params, input_ids, positions=None, attention_mask=None,
              rope_seq_len=None, tp=None):
        """Token embedding + rotary tables. Returns (hidden, ctx). A table
        split over tp (a list of the held ranks' rows) is looked up
        vocab-parallel."""
        cfg = self.config
        table = params["embed"]["weight"]
        if isinstance(table, list):
            x = vocab_parallel_embedding(tp, table, input_ids)
        else:
            x = F.embedding(input_ids.long(), table)
        if cfg.embedding_multiplier != 1.0:
            # The multiplier rounded to the activation dtype, as jnp.asarray(m, x.dtype).
            x = x * torch.tensor(cfg.embedding_multiplier, dtype=x.dtype).item()
        return x, self.context(input_ids, positions, attention_mask, rope_seq_len)

    def context(self, input_ids, positions=None, attention_mask=None, rope_seq_len=None):
        """The blocks' read-only context of a batch (the rotary tables and
        the mask), without the embedding: what a pipeline stage after the
        first needs."""
        cfg = self.config
        B, S = input_ids.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=input_ids.device)[None].expand(B, S)
        cos, sin = rope_tables(
            positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
            seq_len=rope_seq_len if rope_seq_len is not None else S,
            max_position_embeddings=cfg.max_position_embeddings,
        )
        return {"cos": cos, "sin": sin, "attention_mask": attention_mask}

    def block(self, layer, x, ctx, cache_layer=None, window=_WINDOW_FROM_CONFIG):
        """One decoder layer on the residual stream.

        Without a cache the attention runs through :meth:`_tp_attention` on
        ``ctx["tp"]``'s pieces (one whole piece without tensor
        parallelism). With ``cache_layer`` (``{"k","v"}`` of shape (B, K,
        n_kv, D) plus ``ctx["cache_pos"]``) the layer writes this chunk's
        K/V into the cache at the write offset — in place, where the JAX
        version returns an updated copy of its donated cache — and attends
        against the whole cache. Returns ``(x, cache_layer)`` in that
        mode."""
        cfg = self.config
        if window is Llama._WINDOW_FROM_CONFIG:
            window = cfg.sliding_window
        scale = cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar is not None else None
        tp = ctx.get("tp") or _WHOLE
        h = rms_norm(x, layer["input_norm"]["weight"], cfg.rms_norm_eps)
        a = layer["attn"]
        if cache_layer is None:
            attn_out = self._tp_attention(tp, h, a, ctx, window, scale)
        else:
            q, k, v = self._heads(tp, h, tp.copy(h), a, ctx)
            pos = ctx["cache_pos"]
            S = h.shape[1]
            k_cache, v_cache = cache_layer["k"], cache_layer["v"]
            k_cache[:, pos:pos + S] = k.to(k_cache.dtype)
            v_cache[:, pos:pos + S] = v.to(v_cache.dtype)
            attn_out = cached_attention(
                q, k_cache, v_cache, q_positions=ctx["positions"],
                kv_mask=ctx.get("kv_mask"), window=window,
                softcap=cfg.attn_logit_softcap, scale=scale,
            )
            attn_out = _tagged("attn_out", self._mm, attn_out.flatten(2), a["wo"], ctx)
        if cfg.sandwich_norms:
            x = x + rms_norm(attn_out, layer["post_attn_norm"]["weight"], cfg.rms_norm_eps)
            h2 = rms_norm(x, layer["pre_ffw_norm"]["weight"], cfg.rms_norm_eps)
            x = x + rms_norm(self._tp_mlp(tp, layer, h2, ctx),
                             layer["post_ffw_norm"]["weight"], cfg.rms_norm_eps)
        else:
            x = x + attn_out
            h2 = rms_norm(x, layer["post_attn_norm"]["weight"], cfg.rms_norm_eps)
            x = x + self._tp_mlp(tp, layer, h2, ctx)
        return x if cache_layer is None else (x, cache_layer)

    def mlp(self, layer, h2, ctx=None):
        """SwiGLU (or GeGLU) FFN on the normed residual."""
        m = layer["mlp"]
        gate = self._mm(h2, m["w_gate"], ctx)
        gate = F.silu(gate) if self.config.hidden_act == "silu" else F.gelu(gate, approximate="tanh")
        return _tagged("mlp_out", self._mm, gate * self._mm(h2, m["w_up"], ctx), m["w_down"], ctx)

    def _mm(self, a, b, ctx=None):
        """Block matmul through the precision dispatcher (``ops/int8.py``),
        with the forward's kernel spec. The embedding and the LM head stay
        exact, the usual QAT skip list."""
        kernels = None if ctx is None else ctx.get("kernels")
        return _precision_matmul(a, b, precision=self.config.matmul_precision, kernels=kernels)


    # ----------------------------------------------------- tensor parallel
    def _tp_query_heads(self, tp):
        """Per held tp rank, the query heads ``(lo, hi)`` it attends with:
        its own ``nh / tp`` when they divide, else all of them."""
        nh, T = self.config.num_attention_heads, tp.size
        if nh % T:
            return [(0, nh) for _ in tp.indices]
        n = nh // T
        return [(t * n, (t + 1) * n) for t in tp.indices]

    def _tp_full(self, tp, h, hs, w, b, ctx):
        """The replicated ``(B, S, cols)`` projection ``h @ w (+ b)``: each
        rank's columns gathered over tp when ``w`` is split (``hs``: ``h``
        through ``tp.copy``), else computed on the replicated ``h``."""
        if isinstance(w, list):
            outs = [self._mm(hr, wr, ctx) for hr, wr in zip(hs, w)]
            if b is not None:
                outs = [o + br for o, br in zip(outs, b)]
            return tp.gather(outs, -1)
        out = self._mm(h, w, ctx)
        return out if b is None else out + b

    def _tp_heads(self, tp, h, hs, w, b, n_proj, ranges, rep, ctx):
        """Per held tp rank, the ``(B, S, hi - lo, D)`` heads its queries
        ``(lo, hi)`` read of the projection ``h @ w (+ b)`` with ``n_proj``
        heads (``rep`` query heads a projection head, repeated): the rank's
        own columns where they are exactly those heads, else its heads of
        the replicated projection (:meth:`_tp_full`) through ``tp.copy``."""
        B, S, _ = h.shape
        hd = self.config.head_dim
        if isinstance(w, list):
            width = w[0].shape[-1]
            own = width % hd == 0 and all(
                lo % rep == 0 and (lo // rep, -(-hi // rep)) == (t * width // hd,
                                                                  (t + 1) * width // hd)
                for t, (lo, hi) in zip(tp.indices, ranges))
            if own:
                outs = [self._mm(hr, wr, ctx) for hr, wr in zip(hs, w)]
                if b is not None:
                    outs = [o + br for o, br in zip(outs, b)]
                return [o.reshape(B, S, width // hd, hd).repeat_interleave(rep, dim=2)
                        for o in outs]
        full = self._tp_full(tp, h, hs, w, b, ctx).reshape(B, S, n_proj, hd)
        return [f.repeat_interleave(rep, dim=2)[:, :, lo:hi]
                for f, (lo, hi) in zip(tp.copy(full), ranges)]

    def _heads(self, tp, h, hs, a, ctx):
        """The replicated q ``(B, S, nh, D)``, k and v ``(B, S, nkv, D)`` of
        the normed residual ``h``, the QK norms and rope applied; a
        projection split over tp has its columns gathered
        (:meth:`_tp_full`, ``hs``: ``h`` through ``tp.copy``)."""
        cfg = self.config
        B, S, _ = h.shape
        q, k, v = (self._tp_full(tp, h, hs, a[w], a.get(b), ctx).reshape(B, S, n, cfg.head_dim)
                   for w, b, n in (("wq", "bq", cfg.num_attention_heads),
                                   ("wk", "bk", cfg.num_key_value_heads),
                                   ("wv", "bv", cfg.num_key_value_heads)))
        if "q_norm" in a:  # Qwen3 per-head QK norm
            q = rms_norm(q, a["q_norm"], cfg.rms_norm_eps)
            k = rms_norm(k, a["k_norm"], cfg.rms_norm_eps)
        return apply_rope(q, ctx["cos"], ctx["sin"]), apply_rope(k, ctx["cos"], ctx["sin"]), v

    def _tp_attention(self, tp, h, a, ctx, window, scale):
        """The uncached attention of :meth:`block`: the replicated output
        of the wo projection. With wo split over tp each rank attends with
        its query heads (:meth:`_tp_query_heads`) and its wo rows' product
        is summed over tp; with wo whole (no tp, or its rule relaxed) the
        attention runs replicated on all heads."""
        cfg = self.config
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        B, S, _ = h.shape
        rep = nh // nkv
        wo = a["wo"]
        hs = tp.copy(h)
        per_rank = isinstance(wo, list)
        if per_rank:
            ranges = self._tp_query_heads(tp)
            q, k, v = (self._tp_heads(tp, h, hs, a[w], a.get(b), n, ranges, r, ctx)
                       for w, b, n, r in (("wq", "bq", nh, 1), ("wk", "bk", nkv, rep),
                                          ("wv", "bv", nkv, rep)))
            if "q_norm" in a:
                q = [rms_norm(t, w, cfg.rms_norm_eps) for t, w in zip(q, tp.copy(a["q_norm"]))]
                k = [rms_norm(t, w, cfg.rms_norm_eps) for t, w in zip(k, tp.copy(a["k_norm"]))]
            q = [apply_rope(t, ctx["cos"], ctx["sin"]) for t in q]
            k = [apply_rope(t, ctx["cos"], ctx["sin"]) for t in k]
        else:
            ranges = [(0, nh)]
            q, k, v = self._heads(tp, h, hs, a, ctx)
            if nkv != nh:
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            q, k, v = [q], [k], [v]
        sp = ctx.get("sp_group")
        if cfg.attention_impl == "ulysses" and sp is not None:
            from ..parallel.ulysses import check_heads

            n_sp = sp.size if isinstance(getattr(sp, "size", None), int) else \
                torch.distributed.get_world_size(sp)
            check_heads(ranges[0][1] - ranges[0][0], n_sp, tp.size, nh)
        outs = [_attention(qr, kr, vr, causal=True, mask=ctx["attention_mask"],
                           impl=cfg.attention_impl, window=window,
                           softcap=cfg.attn_logit_softcap, scale=scale,
                           kernels=ctx.get("kernels"), group=sp).reshape(B, S, -1)
                for qr, kr, vr in zip(q, k, v)]
        if not per_rank:
            return _tagged("attn_out", self._mm, outs[0], wo, ctx)
        width = wo[0].shape[0]
        if outs[0].shape[-1] != width:  # every rank attended with all heads
            outs = [o[..., t * width:(t + 1) * width] for o, t in zip(outs, tp.indices)]
        return tp.reduce([_tagged("attn_out", self._mm, o, w, ctx) for o, w in zip(outs, wo)])

    def _tp_mlp(self, tp, layer, h2, ctx):
        """The MLP of :meth:`block`: column-parallel gate and up,
        row-parallel down, summed over tp (:meth:`mlp` when none is
        split)."""
        m = layer["mlp"]
        split = [isinstance(m[k], list) for k in ("w_gate", "w_up", "w_down")]
        if not any(split):
            return self.mlp(layer, h2, ctx)
        if not all(split):
            raise NotImplementedError("an MLP with some of w_gate, w_up, w_down split over tp "
                                      "and others whole")
        act = F.silu if self.config.hidden_act == "silu" else functools.partial(
            F.gelu, approximate="tanh")
        outs = []
        for hr, wg, wu, wd in zip(tp.copy(h2), m["w_gate"], m["w_up"], m["w_down"]):
            gate = act(self._mm(hr, wg, ctx))
            outs.append(_tagged("mlp_out", self._mm, gate * self._mm(hr, wu, ctx), wd, ctx))
        return tp.reduce(outs)

    def sharding_rules(self):
        """The JAX package's rules (``models/llama.py:411-431``): Megatron
        tp with the complementary fsdp dim, and the layer stack on pp."""
        return [
            (r"embed/weight", ("tp", "fsdp")),
            (r"attn/w[qkv]", ("pp", "fsdp", "tp")),
            (r"attn/b[qkv]", ("pp", "tp")),
            (r"attn/wo", ("pp", "tp", "fsdp")),
            (r"mlp/w_(gate|up)", ("pp", "fsdp", "tp")),
            (r"mlp/w_down", ("pp", "tp", "fsdp")),
            (r"layers/.*norm", ("pp",)),
            (r"norm", ()),
            (r"lm_head/weight", ("fsdp", "tp")),
        ]

    @staticmethod
    def _shift_labels(labels, attention_mask):
        """Next-token targets: predict t+1 from t; final position untargeted.
        A position trains only if it is itself real (left-padding guard) AND
        its target token t+1 is real (right-padding guard)."""
        B = labels.shape[0]
        pad = torch.full((B, 1), -100, dtype=labels.dtype, device=labels.device)
        shifted = torch.cat([labels[:, 1:], pad], dim=1)
        if attention_mask is not None:
            tail = torch.zeros((B, 1), dtype=attention_mask.dtype, device=attention_mask.device)
            target_valid = torch.cat([attention_mask[:, 1:], tail], dim=1)
            valid = target_valid.bool() & attention_mask.bool()
            shifted = torch.where(valid, shifted, torch.full_like(shifted, -100))
        return shifted

    def head(self, params, x, labels=None, attention_mask=None, targets=None,
             loss_normalizer=None, tp=None):
        """Final norm + LM head (+ shifted-label loss with ``labels``, or the
        loss of ``targets``, labels already shifted). The tied head reads the
        embed table in its native (V, h) layout; with ``fused_loss`` and a
        loss to compute, the loss comes straight from the hidden states and
        the output carries no logits. ``loss_normalizer``: the loss's
        denominator in place of this call's valid-target count. A head
        split over tp (a list of the held ranks' vocab slices) runs the
        vocab-parallel losses; its output carries the loss alone when there
        is one, else the logits gathered over tp."""
        if labels is not None and targets is not None:
            raise ValueError("pass labels (shifted here) or targets (already shifted), not both")
        if labels is not None:
            targets = self._shift_labels(labels, attention_mask)
        cfg = self.config
        x = rms_norm(x, params["final_norm"]["weight"], cfg.rms_norm_eps)
        if cfg.tie_word_embeddings:
            head_w = params["embed"]["weight"]  # (V, h)
            head_w = [w.to(x.dtype) for w in head_w] if isinstance(head_w, list) else \
                head_w.to(x.dtype)
        else:
            head_w = params["lm_head"]["weight"]  # (h, V)
        if isinstance(head_w, list):
            return self._tp_head(tp, x, head_w, targets, loss_normalizer)
        if targets is not None and cfg.fused_loss:
            loss = fused_cross_entropy_loss(
                x, head_w, targets,
                logit_cap=cfg.final_logit_softcap, head_transposed=cfg.tie_word_embeddings,
                vocab_chunk=cfg.fused_loss_chunk, chunk_dtype=cfg.fused_loss_dtype,
                custom_backward=cfg.fused_loss_backward == "custom", normalizer=loss_normalizer,
            )
            return ModelOutput(loss=loss)
        logits = x @ head_w.T if cfg.tie_word_embeddings else x @ head_w
        if cfg.final_logit_softcap is not None:
            logits = softcap_scores(logits.float(), cfg.final_logit_softcap)
        out = ModelOutput(logits=logits)
        if targets is not None:
            out["loss"] = cross_entropy_loss(logits, targets, normalizer=loss_normalizer)
        return out

    def _tp_head(self, tp, x, head_w, targets, loss_normalizer):
        """The vocab-parallel head of :meth:`head`."""
        cfg = self.config
        xs = tp.copy(x)
        if targets is not None and cfg.fused_loss:
            return ModelOutput(loss=vocab_parallel_fused_cross_entropy(
                tp, xs, head_w, targets, logit_cap=cfg.final_logit_softcap,
                head_transposed=cfg.tie_word_embeddings, vocab_chunk=cfg.fused_loss_chunk,
                chunk_dtype=cfg.fused_loss_dtype,
                custom_backward=cfg.fused_loss_backward == "custom", normalizer=loss_normalizer))
        parts = [xr @ w.T if cfg.tie_word_embeddings else xr @ w for xr, w in zip(xs, head_w)]
        if cfg.final_logit_softcap is not None:
            parts = [softcap_scores(p.float(), cfg.final_logit_softcap) for p in parts]
        if targets is None:
            return ModelOutput(logits=tp.gather(parts, -1))
        return ModelOutput(loss=vocab_parallel_cross_entropy(tp, parts, targets,
                                                             normalizer=loss_normalizer))

    # ------------------------------------------------------------------ cache
    def init_cache(self, batch_size: int, max_len: int, dtype=torch.bfloat16):
        """Pre-allocated decode cache on the model's device. ``pos`` (the
        write offset) is a host int: it advances deterministically, so the
        decode loop never reads it back from the card."""
        cfg = self.config
        shape = (cfg.num_hidden_layers, batch_size, max_len, cfg.num_key_value_heads,
                 cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device),
            "pos": 0,
            "kv_mask": torch.zeros((batch_size, max_len), dtype=torch.int32, device=self.device),
        }

    def _layer_window(self, i: int):
        cfg = self.config
        return cfg.sliding_window if cfg.layer_windows is None else cfg.layer_windows[i]

    def apply(self, params, input_ids=None, labels=None, attention_mask=None,
              positions=None, cache=None, kernels=None, targets=None, loss_normalizer=None,
              sp_group=None, tp=None, experts=None, router_stats=None, **kwargs):
        """Forward. ``kernels`` is the registry spec for the kernels the
        forward runs: the uncached attention's flash, splash or ring-block
        ops and, with ``matmul_precision="int8"``, the int8 matmul
        (``None``: the CUDA kernels for CUDA tensors; ``"off"``: their plain
        versions). ``targets``, ``loss_normalizer`` and ``sp_group`` serve a
        sequence shard, ``tp`` a tp rank's pieces, ``experts`` the expert
        group of a mixture-of-experts layer and ``router_stats`` its router
        loss over data ranks (``ops/moe.py``), ``pipeline`` a
        ``PipelineSpec`` (module docstring)."""
        pipeline = kwargs.get("pipeline")
        if cache is not None:
            return self._apply_cached(params, input_ids, attention_mask, cache,
                                      labels=labels, positions=positions, kernels=kernels)
        x, ctx = self.embed(params, input_ids, positions, attention_mask, tp=tp)
        ctx.update(kernels=kernels, sp_group=sp_group, tp=tp, experts=experts,
                   router_stats=router_stats)
        L = self.config.num_hidden_layers
        if pipeline is not None:
            x, aux = pipeline.run(self, params["layers"], x, ctx)
        else:
            x, aux = self.run_layers(params["layers"], x, ctx, 0, L)
            aux = {k: v / L for k, v in aux.items()}
        out = self.head(params, x, labels=labels, attention_mask=attention_mask,
                        targets=targets, loss_normalizer=loss_normalizer, tp=tp)
        return self.finalize_aux(out, aux)

    def run_layers(self, layers, x, ctx, start: int, stop: int):
        """Layers ``start .. stop - 1`` (global indices) of the stack on the
        residual stream, each with its window; under remat and autograd each
        block runs inside a checkpoint region, its layer indexed (gathered,
        when sharded) inside the region. Returns ``(x, aux)``: each
        ``scan_aux_keys`` value summed over these layers (each block sows
        into its own copy of ``ctx``, which names its ``layer``)."""
        cfg = self.config
        keys = tuple(self.scan_aux_keys)
        remat = cfg.remat and torch.is_grad_enabled()
        if remat:
            from torch.utils.checkpoint import checkpoint

            context_fn = _remat_context_fn(*resolve_remat_policy(cfg.remat_policy,
                                                                 cfg.remat_save_names))
            extra = {} if context_fn is None else {"context_fn": context_fn}

        def layer_fn(x, i, window):
            ctx_call = dict(ctx, layer=i)
            x = self.block(_index_tree(layers, i), x, ctx_call, window=window)
            return (x,) + tuple(ctx_call.pop(k) for k in keys)

        sums = {}
        for i in range(start, stop):
            window = self._layer_window(i)
            if remat:
                got = checkpoint(layer_fn, x, i, window, use_reentrant=False, **extra)
            else:
                got = layer_fn(x, i, window)
            x = got[0]
            for k, v in zip(keys, got[1:]):
                sums[k] = v if k not in sums else sums[k] + v
        return x, sums

    def _apply_cached(self, params, input_ids, attention_mask, cache, labels=None,
                      positions=None, kernels=None):
        """Prefill/decode forward through the KV cache. The chunk is written
        at ``cache['pos']`` in place (the cache tensors are the caller's, as
        the JAX version's are donated); the output carries the advanced
        cache. ``positions`` (optional, (B,S)) are the token positions used
        for RoPE; causal masking always uses the cache slot indices."""
        B, S = input_ids.shape
        pos = int(cache["pos"])
        dev = input_ids.device
        slot_positions = (pos + torch.arange(S, dtype=torch.int32, device=dev))[None].expand(B, S)
        rope_positions = slot_positions if positions is None else positions
        chunk_mask = (attention_mask.to(torch.int32) if attention_mask is not None
                      else torch.ones((B, S), dtype=torch.int32, device=dev))
        kv_mask = cache["kv_mask"]
        kv_mask[:, pos:pos + S] = chunk_mask
        x, ctx = self.embed(params, input_ids, rope_positions, attention_mask,
                            rope_seq_len=cache["k"].shape[2])
        ctx["positions"] = slot_positions
        ctx["kv_mask"] = kv_mask
        ctx["cache_pos"] = pos
        ctx["kernels"] = kernels
        for i in range(self.config.num_hidden_layers):
            x, _ = self.block(
                _index_tree(params["layers"], i), x, ctx,
                cache_layer={"k": cache["k"][i], "v": cache["v"][i]},
                window=self._layer_window(i),
            )
        out = self.head(params, x, labels=labels, attention_mask=attention_mask)
        out["cache"] = {"k": cache["k"], "v": cache["v"], "pos": pos + S, "kv_mask": kv_mask}
        return out

    # -------------------------------------------------------------- estimation
    def num_params(self) -> int:
        cfg = self.config
        h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
        attn = (h * (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * cfg.head_dim
                + cfg.num_attention_heads * cfg.head_dim * h)
        if cfg.attention_bias:
            attn += (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * cfg.head_dim
        if cfg.qk_norm:
            attn += 2 * cfg.head_dim
        total = L * (attn + 3 * h * inter + 2 * h) + cfg.vocab_size * h + h
        if not cfg.tie_word_embeddings:
            total += h * cfg.vocab_size
        return total

    def flops_per_token(self) -> float:
        """Approximate forward+backward FLOPs per token (6N + attention)."""
        cfg = self.config
        attn_extra = 12 * cfg.num_hidden_layers * cfg.hidden_size * cfg.max_position_embeddings
        return 6 * self.num_params() + attn_extra
