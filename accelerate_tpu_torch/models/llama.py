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
environment overrides are not ported (the port reads no environment
variable).

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

Left out so far, and raising when set: remat, the pipeline schedule, MoE,
the ulysses attention impl, and the ``yarn``/``dynamic`` rope types.
"""

from __future__ import annotations

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
from ..ops.losses import cross_entropy_loss, fused_cross_entropy_loss
from ..utils.device import host_to_device, resolve_device


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
    # RoPE scaling: None, or a dict with rope_type 'linear' or 'llama3'
    # ('yarn' and 'dynamic' are not ported yet). Matches the HF config field.
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


SUPPORTED_ROPE_TYPES = ("default", "linear", "llama3")


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


def rope_tables(positions, head_dim, theta, scaling: dict | None = None,
                seq_len: int | None = None, max_position_embeddings: int | None = None):
    """cos/sin tables for rotary embeddings, fp32. positions: (B, S) int.

    ``seq_len``/``max_position_embeddings`` are accepted for signature parity
    with the JAX version, where they feed the ``dynamic`` rope type."""
    del seq_len, max_position_embeddings
    rope_type = scaling.get("rope_type", scaling.get("type", "default")) if scaling else "default"
    if rope_type in ("yarn", "dynamic"):
        raise NotImplementedError(
            f"rope_type {rope_type!r} is not ported yet (ROADMAP.md, module "
            "queue: the model zoo's rope scalings)"
        )
    if rope_type not in (None,) + SUPPORTED_ROPE_TYPES:
        raise ValueError(f"Unsupported rope_type {rope_type!r} (supported: {SUPPORTED_ROPE_TYPES})")
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    if rope_type == "linear":
        inv_freq = inv_freq / float(scaling.get("factor", 1.0))
    elif rope_type == "llama3":
        inv_freq = _llama3_scale_inv_freq(inv_freq, scaling)
    inv = host_to_device(np.asarray(inv_freq, np.float32), positions.device)
    angles = positions[..., None].float() * inv  # (B,S,D/2)
    return torch.cos(angles), torch.sin(angles)


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


class Llama(Module):
    _WINDOW_FROM_CONFIG = object()  # sentinel: use cfg.sliding_window

    def __init__(self, config: LlamaConfig, device=None):
        unported = {
            "remat": config.remat,
            "attention_impl=ulysses": config.attention_impl == "ulysses",
        }
        for name, engaged in unported.items():
            if engaged:
                raise NotImplementedError(
                    f"Llama option {name} is not ported yet (ROADMAP.md, module queue)"
                )
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
              rope_seq_len=None):
        """Token embedding + rotary tables. Returns (hidden, ctx)."""
        cfg = self.config
        B, S = input_ids.shape
        table = params["embed"]["weight"]
        x = F.embedding(input_ids.long(), table)
        if cfg.embedding_multiplier != 1.0:
            # The multiplier rounded to the activation dtype, as jnp.asarray(m, x.dtype).
            x = x * torch.tensor(cfg.embedding_multiplier, dtype=x.dtype).item()
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        cos, sin = rope_tables(
            positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
            seq_len=rope_seq_len if rope_seq_len is not None else S,
            max_position_embeddings=cfg.max_position_embeddings,
        )
        return x, {"cos": cos, "sin": sin, "attention_mask": attention_mask}

    def block(self, layer, x, ctx, cache_layer=None, window=_WINDOW_FROM_CONFIG):
        """One decoder layer on the residual stream.

        With ``cache_layer`` (``{"k","v"}`` of shape (B, K, n_kv, D) plus
        ``ctx["cache_pos"]``) the layer writes this chunk's K/V into the cache
        at the write offset — in place, where the JAX version returns an
        updated copy of its donated cache — and attends against the whole
        cache. Returns ``(x, cache_layer)`` in that mode."""
        cfg = self.config
        if window is Llama._WINDOW_FROM_CONFIG:
            window = cfg.sliding_window
        nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        B, S, _ = x.shape
        cos, sin = ctx["cos"], ctx["sin"]
        scale = cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar is not None else None
        h = rms_norm(x, layer["input_norm"]["weight"], cfg.rms_norm_eps)
        a = layer["attn"]
        q, k, v = self._mm(h, a["wq"], ctx), self._mm(h, a["wk"], ctx), self._mm(h, a["wv"], ctx)
        if "bq" in a:  # Qwen2-style QKV biases
            q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
        q = q.reshape(B, S, nh, hd)
        k = k.reshape(B, S, nkv, hd)
        v = v.reshape(B, S, nkv, hd)
        if "q_norm" in a:  # Qwen3 per-head QK norm
            q = rms_norm(q, a["q_norm"], cfg.rms_norm_eps)
            k = rms_norm(k, a["k_norm"], cfg.rms_norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cache_layer is not None:
            pos = ctx["cache_pos"]
            k_cache, v_cache = cache_layer["k"], cache_layer["v"]
            k_cache[:, pos:pos + S] = k.to(k_cache.dtype)
            v_cache[:, pos:pos + S] = v.to(v_cache.dtype)
            attn_out = cached_attention(
                q, k_cache, v_cache, q_positions=ctx["positions"],
                kv_mask=ctx.get("kv_mask"), window=window,
                softcap=cfg.attn_logit_softcap, scale=scale,
            )
        else:
            if nkv != nh:
                rep = nh // nkv
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            attn_out = _attention(
                q, k, v, causal=True, mask=ctx["attention_mask"],
                impl=cfg.attention_impl, window=window,
                softcap=cfg.attn_logit_softcap, scale=scale, kernels=ctx.get("kernels"),
                group=ctx.get("sp_group"),
            )
        attn_out = self._mm(attn_out.reshape(B, S, nh * hd), a["wo"], ctx)
        if cfg.sandwich_norms:
            x = x + rms_norm(attn_out, layer["post_attn_norm"]["weight"], cfg.rms_norm_eps)
            h2 = rms_norm(x, layer["pre_ffw_norm"]["weight"], cfg.rms_norm_eps)
            m = self.mlp(layer, h2, ctx)
            x = x + rms_norm(m, layer["post_ffw_norm"]["weight"], cfg.rms_norm_eps)
        else:
            x = x + attn_out
            h2 = rms_norm(x, layer["post_attn_norm"]["weight"], cfg.rms_norm_eps)
            x = x + self.mlp(layer, h2, ctx)
        return x if cache_layer is None else (x, cache_layer)

    def mlp(self, layer, h2, ctx=None):
        """SwiGLU (or GeGLU) FFN on the normed residual."""
        m = layer["mlp"]
        gate = self._mm(h2, m["w_gate"], ctx)
        gate = F.silu(gate) if self.config.hidden_act == "silu" else F.gelu(gate, approximate="tanh")
        return self._mm(gate * self._mm(h2, m["w_up"], ctx), m["w_down"], ctx)

    def _mm(self, a, b, ctx=None):
        """Block matmul through the precision dispatcher (``ops/int8.py``),
        with the forward's kernel spec. The embedding and the LM head stay
        exact, the usual QAT skip list."""
        kernels = None if ctx is None else ctx.get("kernels")
        return _precision_matmul(a, b, precision=self.config.matmul_precision, kernels=kernels)

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
             loss_normalizer=None):
        """Final norm + LM head (+ shifted-label loss with ``labels``, or the
        loss of ``targets``, labels already shifted). The tied head reads the
        embed table in its native (V, h) layout; with ``fused_loss`` and a
        loss to compute, the loss comes straight from the hidden states and
        the output carries no logits. ``loss_normalizer``: the loss's
        denominator in place of this call's valid-target count."""
        if labels is not None and targets is not None:
            raise ValueError("pass labels (shifted here) or targets (already shifted), not both")
        if labels is not None:
            targets = self._shift_labels(labels, attention_mask)
        cfg = self.config
        x = rms_norm(x, params["final_norm"]["weight"], cfg.rms_norm_eps)
        if cfg.tie_word_embeddings:
            head_w = params["embed"]["weight"].to(x.dtype)  # (V, h)
        else:
            head_w = params["lm_head"]["weight"]  # (h, V)
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
              sp_group=None, **kwargs):
        """Forward. ``kernels`` is the registry spec for the kernels the
        forward runs: the uncached attention's flash, splash or ring-block
        ops and, with ``matmul_precision="int8"``, the int8 matmul
        (``None``: the CUDA kernels for CUDA tensors; ``"off"``: their plain
        versions). ``targets``, ``loss_normalizer`` and ``sp_group`` serve a
        sequence shard (module docstring)."""
        if kwargs.get("pipeline") is not None:
            raise NotImplementedError("pipeline schedules are not ported yet (ROADMAP.md)")
        if cache is not None:
            return self._apply_cached(params, input_ids, attention_mask, cache,
                                      labels=labels, positions=positions, kernels=kernels)
        x, ctx = self.embed(params, input_ids, positions, attention_mask)
        ctx["kernels"] = kernels
        ctx["sp_group"] = sp_group
        for i in range(self.config.num_hidden_layers):
            x = self.block(_index_tree(params["layers"], i), x, ctx,
                           window=self._layer_window(i))
        return self.head(params, x, labels=labels, attention_mask=attention_mask,
                         targets=targets, loss_normalizer=loss_normalizer)

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
