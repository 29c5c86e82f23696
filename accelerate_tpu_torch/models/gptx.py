"""Classic-GPT decoders in PyTorch — the counterpart of ``accelerate_tpu/models/gptx.py``.

GPT-NeoX, GPT-J and OPT in one skeleton, as in the JAX package; they differ
only along documented axes:

- **positions**: rotary half-split (NeoX, partial ``rotary_dim``), rotary
  interleaved pairs (GPT-J), or a learned table read at
  ``position + position_offset`` (OPT's +2 rows);
- **residual topology**: attention and MLP off the same input (NeoX with
  two norms, GPT-J with one shared norm) or sequential pre-LN blocks (OPT);
- **activation**: exact gelu (NeoX), tanh-gelu (GPT-J), relu (OPT);
- **head**: untied (NeoX), untied with a bias (GPT-J), tied (OPT).

The parameter layout is the JAX package's, so trees carry across by name
(``models/from_jax.gptx_params_from_numpy``) and from a Hugging Face state
dict (``models/convert.py``): the stacked ``(L, ...)`` layer leaves, one
fused ``w_qkv`` ``(h, 3h)`` whose columns are ``[q | k | v]`` (NeoX's per-head
interleave is undone at conversion), ``(in, out)`` projections, the untied
head ``(h, V)``.

The model reuses Llama's layer loop, cache loop and stage protocol
(``models/llama.py``: ``apply``, ``run_layers`` with remat, ``_apply_cached``,
the pipeline's ``embed`` / ``context`` / ``run_layers`` / ``head``) and its
rotary tables; it replaces the block, the embedding, the head and the
parameters. Positions are mask-derived token positions (``positions``),
never the cache slot: a learned table and rope alike index the token's real
position in a ragged batch, while the causal mask reads slot indices.

``matmul_precision="int8"`` sends the four block projections (``w_qkv``,
``wo``, ``w_in``, ``w_out``) through ``ops/int8.matmul``; the embedding and
the head stay exact.

Tensor parallelism (``tp``, the sharded step of ``parallel/fsdp.py``): the
plan splits the fused ``w_qkv`` and ``b_qkv`` by contiguous columns over tp
(JAX's rules), so at tp 2 rank 0 holds all of q and half of k. Each rank
computes its columns, the projection is gathered over tp (the one
all-gather of a layer's activations), and each rank attends with its own
query heads; ``wo`` and ``w_out`` are row-parallel, summed over tp, each
bias added once after the sum; ``w_in`` and ``b_in`` column-parallel; the
embedding, the tied or untied head and GPT-J's head bias vocab-parallel.
The bytes a rank holds are the plan's and a checkpoint holds the full
layout, because nothing is re-laid out: the gather moves activations
instead (``(B, S, 3h)`` a layer), where splitting ``w_qkv`` per head would
need a layout the plan does not have.

Sequence parallelism (ring, Ulysses) is not ported for these models: a
config asking for it raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..modules import ModelOutput
from ..ops.attention import attention as _attention
from ..ops.attention import cached_attention
from ..ops.int8 import PRECISIONS
from ..ops.losses import cross_entropy_loss, vocab_parallel_cross_entropy
from ..ops.norms import layer_norm
from ..parallel.tensor import LoopbackTP, vocab_parallel_embedding
from ..utils.dataclasses import resolve_remat_policy
from ..utils.device import resolve_device
from .llama import Llama, apply_rope, rope_tables

# The tp context of a model whose weights are whole: one piece, no collectives.
_WHOLE = LoopbackTP(1)


def apply_rope_interleaved(x, cos, sin):
    """GPT-J rotary: the pairs are adjacent lanes (0,1), (2,3), ... (the
    ``rotate_every_two`` convention), where NeoX and Llama rotate the two
    halves. ``x``: (B, S, H, D_rot); ``cos``/``sin``: (B, S, D_rot/2)."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


POSITION_STYLES = ("rotary_neox", "rotary_gptj", "learned")
ACTIVATIONS = {
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


@dataclass
class GPTXConfig:
    vocab_size: int = 50432
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    # 'rotary_neox' (half-split, partial width) | 'rotary_gptj' (interleaved
    # pairs) | 'learned' (OPT's table with `position_offset` extra rows).
    position_style: str = "rotary_neox"
    rotary_dim: int | None = None  # None = the full head_dim (rotary styles only)
    rope_theta: float = 10000.0
    # linear / llama3 / yarn (the HF config field) over the rotary lanes;
    # 'dynamic' raises.
    rope_scaling: dict | None = None
    # True: x + attn(ln1(x)) + mlp(ln2(x)) (NeoX, GPT-J); False: sequential
    # pre-LN (OPT, NeoX with use_parallel_residual=False).
    parallel_residual: bool = True
    # GPT-J feeds attention and MLP the same ln_1 output (no ln_2 leaves).
    shared_layernorm: bool = False
    hidden_act: str = "gelu"
    attention_bias: bool = True  # NeoX/OPT yes; GPT-J projects bias-free
    position_offset: int = 0  # OPT's learned table starts at row 2
    tie_word_embeddings: bool = False  # OPT ties; NeoX and GPT-J do not
    lm_head_bias: bool = False  # GPT-J's untied head carries a bias
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    attention_impl: str = "auto"  # 'auto' | 'dense' | 'flash'
    matmul_precision: str = "default"  # 'default' | 'int8'

    # The block tags no output for remat's names_saveable (JAX reads an
    # absent field as ()).
    remat_save_names = ()

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self) -> int:
        """Every query head has its own K/V head (the KV pool's width)."""
        return self.num_attention_heads

    def __post_init__(self):
        validate_gpt_config(self)
        if self.position_style not in POSITION_STYLES:
            raise ValueError(
                f"position_style must be one of {POSITION_STYLES}, got {self.position_style!r}")
        if self.hidden_act not in ACTIVATIONS:
            raise ValueError(
                f"hidden_act must be one of {sorted(ACTIVATIONS)}, got {self.hidden_act!r}")
        if self.position_style == "learned":
            if self.rotary_dim is not None:
                raise ValueError("rotary_dim is meaningless with learned positions")
        elif self.rotary_dim is None:
            self.rotary_dim = self.head_dim
        if self.rotary_dim is not None and self.rotary_dim % 2:
            raise ValueError(f"rotary_dim must be even, got {self.rotary_dim}")
        if self.rope_scaling:
            if self.position_style == "learned":
                raise ValueError("rope_scaling is meaningless with learned positions")
            rope_type = self.rope_scaling.get("rope_type", self.rope_scaling.get("type"))
            if rope_type == "dynamic":
                raise ValueError(
                    "dynamic (NTK-by-length) rope scaling is not supported by the "
                    "classic-GPT zoo model (its rope has no cache-capacity pinning); "
                    "linear/llama3/yarn are supported")
        if self.shared_layernorm and not self.parallel_residual:
            raise ValueError("shared_layernorm requires parallel_residual (the GPT-J topology)")

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        max_position_embeddings=128)
        defaults.update(kw)
        return cls(**defaults)


def validate_gpt_config(cfg):
    """The port's refusals shared by GPT-2 and GPTX configs: the precision
    and the remat policy, and sequence parallelism, which these models do
    not run (``Accelerator.prepare`` sets ``attention_impl`` to the ring or
    Ulysses under an sp axis, and that config raises here)."""
    if cfg.matmul_precision not in PRECISIONS:
        raise ValueError(f"matmul precision must be 'default' or 'int8', "
                         f"got {cfg.matmul_precision!r}")
    resolve_remat_policy(cfg.remat_policy, ())
    if cfg.attention_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"sequence parallelism (attention_impl={cfg.attention_impl!r}) is not ported for "
            "the GPT-2 and classic-GPT (GPT-NeoX, GPT-J, OPT) models; train them with sp=1")


def _pieces(tp, b, n):
    """Per held tp rank, its ``n`` columns of ``b``: the list itself when
    ``b`` is split over tp, else slices of the replicated ``b`` through
    ``tp.copy`` (so its gradient is whole on every rank)."""
    if isinstance(b, list):
        return b
    return [br[..., t * n:(t + 1) * n] for br, t in zip(tp.copy(b), tp.indices)]


class GPTX(Llama):
    """GPT-NeoX / GPT-J / OPT (module docstring)."""

    def __init__(self, config: GPTXConfig, device=None):
        validate_gpt_config(config)
        self.config = config
        self.device = resolve_device(device)
        self.params = None

    # ------------------------------------------------------------------- init
    def init(self, generator=None, dtype=torch.float32):
        """Random parameters from ``generator`` (a ``torch.Generator`` on the
        model's device, or an int seed): normal with std 1/sqrt(fan_in) for
        projections and tables, ones for norm scales, zeros for biases."""
        cfg = self.config
        dev = self.device
        if dev.type == "meta":
            generator = None
        elif not isinstance(generator, torch.Generator):
            seed = 0 if generator is None else int(generator)
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
        h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers

        def dense(shape, fan_in):
            t = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
            return t.mul_(1.0 / math.sqrt(fan_in))

        def const(shape, value):
            return torch.full(shape, value, device=dev, dtype=dtype)

        def ln(shape):
            return {"scale": const(shape, 1.0), "bias": const(shape, 0.0)}

        embed = {"wte": dense((cfg.vocab_size, h), h)}
        if cfg.position_style == "learned":
            embed["wpe"] = dense((cfg.max_position_embeddings + cfg.position_offset, h), h)
        attn = {"w_qkv": dense((L, h, 3 * h), h), "wo": dense((L, h, h), h)}
        if cfg.attention_bias:
            attn["b_qkv"] = const((L, 3 * h), 0.0)
            attn["bo"] = const((L, h), 0.0)
        layers = {
            "attn": attn,
            "mlp": {"w_in": dense((L, h, inter), h), "b_in": const((L, inter), 0.0),
                    "w_out": dense((L, inter, h), inter), "b_out": const((L, h), 0.0)},
            "ln_1": ln((L, h)),
        }
        if not cfg.shared_layernorm:
            layers["ln_2"] = ln((L, h))
        params = {"embed": embed, "layers": layers, "ln_f": ln((h,))}
        if not cfg.tie_word_embeddings:
            head = {"weight": dense((h, cfg.vocab_size), h)}
            if cfg.lm_head_bias:
                head["bias"] = const((cfg.vocab_size,), 0.0)
            params["lm_head"] = head
        return params

    # --------------------------------------------------------------- sharding
    def sharding_rules(self):
        """The JAX package's rules (``models/gptx.py:194-213``): the fused
        QKV and ``w_in`` column-split on tp, ``wo`` and ``w_out`` row-split,
        the layer stack on pp, the vocab on tp."""
        return [
            (r"embed/wte", ("tp", "fsdp")),
            (r"embed/wpe", (None, "fsdp")),
            (r"attn/w_qkv", ("pp", "fsdp", "tp")),
            (r"attn/b_qkv", ("pp", "tp")),
            (r"attn/wo", ("pp", "tp", "fsdp")),
            (r"attn/bo", ("pp",)),
            (r"mlp/w_in", ("pp", "fsdp", "tp")),
            (r"mlp/b_in", ("pp", "tp")),
            (r"mlp/w_out", ("pp", "tp", "fsdp")),
            (r"mlp/b_out", ("pp",)),
            (r"layers/ln_", ("pp",)),
            (r"ln_f", ()),
            (r"lm_head/weight", ("fsdp", "tp")),
            (r"lm_head/bias", ("tp",)),
        ]

    # ---------------------------------------------------------------- forward
    def embed(self, params, input_ids, positions=None, attention_mask=None,
              rope_seq_len=None, tp=None):
        """Token embedding (+ the learned position table) and the blocks'
        context. ``positions`` are token positions (mask-derived in a
        ragged batch); a table split over tp is looked up vocab-parallel."""
        cfg = self.config
        B, S = input_ids.shape
        if cfg.position_style == "learned" and S > cfg.max_position_embeddings:
            # Learned positions have a hard table limit.
            raise ValueError(f"sequence length {S} exceeds max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=input_ids.device)[None].expand(B, S)
        table = params["embed"]["wte"]
        if isinstance(table, list):
            x = vocab_parallel_embedding(tp, table, input_ids)
            dtype = table[0].dtype
        else:
            x = F.embedding(input_ids.long(), table)
            dtype = table.dtype
        if cfg.position_style == "learned":
            x = x + F.embedding(positions.long() + cfg.position_offset, params["embed"]["wpe"])
        return x.to(dtype), self.context(input_ids, positions, attention_mask)

    def context(self, input_ids, positions=None, attention_mask=None):
        """The blocks' read-only context: the mask, and the rotary tables
        over ``rotary_dim`` lanes for the rotary styles."""
        cfg = self.config
        ctx = {"attention_mask": attention_mask}
        if cfg.position_style != "learned":
            B, S = input_ids.shape
            if positions is None:
                positions = torch.arange(S, dtype=torch.int32,
                                         device=input_ids.device)[None].expand(B, S)
            ctx["cos"], ctx["sin"] = rope_tables(
                positions, cfg.rotary_dim, cfg.rope_theta, cfg.rope_scaling,
                max_position_embeddings=cfg.max_position_embeddings)
        return ctx

    def _rope(self, x, ctx):
        cfg = self.config
        if cfg.position_style == "learned":
            return x
        rot = apply_rope if cfg.position_style == "rotary_neox" else apply_rope_interleaved
        d = cfg.rotary_dim
        if d == cfg.head_dim:
            return rot(x, ctx["cos"], ctx["sin"])
        return torch.cat([rot(x[..., :d], ctx["cos"], ctx["sin"]), x[..., d:]], dim=-1)

    def _layer_window(self, i: int):
        return None

    def _qkv(self, tp, h, hs, a, ctx):
        """The replicated q, k, v ``(B, S, nh, D)`` of the normed residual,
        rope applied: a ``w_qkv`` split over tp has its columns gathered
        (:meth:`Llama._tp_full`)."""
        cfg = self.config
        B, S, _ = h.shape
        qkv = self._tp_full(tp, h, hs, a["w_qkv"], a.get("b_qkv"), ctx)
        q, k, v = (t.reshape(B, S, cfg.num_attention_heads, cfg.head_dim)
                   for t in qkv.chunk(3, dim=-1))
        return self._rope(q, ctx), self._rope(k, ctx), v

    def block(self, layer, x, ctx, cache_layer=None, window=None):
        """One layer on the residual stream (parallel or sequential
        residual). With ``cache_layer`` (``{"k","v"}`` of shape (B, K, nh,
        D) plus ``ctx["cache_pos"]``) the chunk's K/V are written into the
        cache in place and the layer attends against the whole cache;
        returns ``(x, cache_layer)`` then."""
        cfg = self.config
        tp = ctx.get("tp") or _WHOLE
        a = layer["attn"]
        ln1 = layer_norm(x, layer["ln_1"]["scale"], layer["ln_1"]["bias"], cfg.layer_norm_eps)
        if cache_layer is None:
            attn = self._tp_attention(tp, ln1, a, ctx)
        else:
            q, k, v = self._qkv(tp, ln1, tp.copy(ln1), a, ctx)
            pos, S = ctx["cache_pos"], ln1.shape[1]
            k_cache, v_cache = cache_layer["k"], cache_layer["v"]
            k_cache[:, pos:pos + S] = k.to(k_cache.dtype)
            v_cache[:, pos:pos + S] = v.to(v_cache.dtype)
            out = cached_attention(q, k_cache, v_cache, q_positions=ctx["positions"],
                                   kv_mask=ctx.get("kv_mask"))
            attn = self._mm(out.flatten(2), a["wo"], ctx)
        if "bo" in a:
            attn = attn + a["bo"]
        m = layer["mlp"]
        if cfg.parallel_residual:
            ln2 = ln1 if cfg.shared_layernorm else layer_norm(
                x, layer["ln_2"]["scale"], layer["ln_2"]["bias"], cfg.layer_norm_eps)
            x = x + attn + self._tp_mlp(tp, layer, ln2, ctx) + m["b_out"]
        else:
            x = x + attn
            ln2 = layer_norm(x, layer["ln_2"]["scale"], layer["ln_2"]["bias"],
                             cfg.layer_norm_eps)
            x = x + self._tp_mlp(tp, layer, ln2, ctx) + m["b_out"]
        return x if cache_layer is None else (x, cache_layer)

    def _tp_attention(self, tp, h, a, ctx):
        """The uncached attention: the output of the ``wo`` projection
        before its bias, replicated. With ``wo`` split over tp each rank
        attends with its query heads of the gathered projection and its
        ``wo`` rows' product is summed over tp; with ``wo`` whole the
        attention runs on all heads."""
        cfg = self.config
        B, S, _ = h.shape
        wo = a["wo"]
        q, k, v = self._qkv(tp, h, tp.copy(h), a, ctx)
        per_rank = isinstance(wo, list)
        if per_rank:
            ranges = self._tp_query_heads(tp)
            q, k, v = ([t[:, :, lo:hi] for t, (lo, hi) in zip(tp.copy(u), ranges)]
                       for u in (q, k, v))
        else:
            q, k, v = [q], [k], [v]
        outs = [_attention(qr, kr, vr, causal=True, mask=ctx["attention_mask"],
                           impl=cfg.attention_impl, kernels=ctx.get("kernels")).reshape(B, S, -1)
                for qr, kr, vr in zip(q, k, v)]
        if not per_rank:
            return self._mm(outs[0], wo, ctx)
        width = wo[0].shape[0]
        if outs[0].shape[-1] != width:  # every rank attended with all heads
            outs = [o[..., t * width:(t + 1) * width] for o, t in zip(outs, tp.indices)]
        return tp.reduce([self._mm(o, w, ctx) for o, w in zip(outs, wo)])

    def _tp_mlp(self, tp, layer, h2, ctx):
        """The MLP before its output bias: ``w_in`` and ``b_in``
        column-parallel, ``w_out`` row-parallel and summed over tp."""
        m = layer["mlp"]
        act = ACTIVATIONS[self.config.hidden_act]
        split = [isinstance(m[k], list) for k in ("w_in", "w_out")]
        if not any(split):
            return self._mm(act(self._mm(h2, m["w_in"], ctx) + m["b_in"]), m["w_out"], ctx)
        if not all(split):
            raise NotImplementedError("an MLP with one of w_in, w_out split over tp and the "
                                      "other whole")
        b_in = _pieces(tp, m["b_in"], m["w_in"][0].shape[-1])
        return tp.reduce([self._mm(act(self._mm(hr, wi, ctx) + bi), wo, ctx)
                          for hr, wi, bi, wo in zip(tp.copy(h2), m["w_in"], b_in, m["w_out"])])

    def head(self, params, x, labels=None, attention_mask=None, targets=None,
             loss_normalizer=None, tp=None):
        """Final norm + LM head, tied to ``wte`` or untied (with GPT-J's
        bias), logits in f32 (+ the shifted-label loss with ``labels``, or
        the loss of ``targets``, labels already shifted). A head split over
        tp runs the vocab-parallel loss; its output carries the loss alone
        when there is one, else the logits gathered over tp."""
        if labels is not None and targets is not None:
            raise ValueError("pass labels (shifted here) or targets (already shifted), not both")
        if labels is not None:
            targets = self._shift_labels(labels, attention_mask)
        cfg = self.config
        x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"], cfg.layer_norm_eps)
        tied = cfg.tie_word_embeddings
        w = params["embed"]["wte"] if tied else params["lm_head"]["weight"]
        # (not .get: a sharded tree's dict gathers a leaf when it is indexed)
        b = params["lm_head"]["bias"] if not tied and "bias" in params["lm_head"] else None
        if isinstance(w, list):
            parts = [xr @ (wr.T if tied else wr).to(xr.dtype) for xr, wr in zip(tp.copy(x), w)]
            if b is not None:
                bs = _pieces(tp, b, w[0].shape[-1])
                parts = [p + br.to(p.dtype) for p, br in zip(parts, bs)]
            parts = [p.float() for p in parts]
            if targets is None:
                return ModelOutput(logits=tp.gather(parts, -1))
            return ModelOutput(loss=vocab_parallel_cross_entropy(tp, parts, targets,
                                                                 normalizer=loss_normalizer))
        logits = x @ (w.T if tied else w).to(x.dtype)
        if b is not None:
            logits = logits + b.to(logits.dtype)
        out = ModelOutput(logits=logits.float())
        if targets is not None:
            out["loss"] = cross_entropy_loss(out["logits"], targets, normalizer=loss_normalizer)
        return out

    # ------------------------------------------------------------------ cache
    def init_cache(self, batch_size: int, max_len: int, dtype=torch.bfloat16):
        """Pre-allocated decode cache on the model's device (Llama's layout
        with every head its own K/V head). A learned table bounds it."""
        cfg = self.config
        if cfg.position_style == "learned" and max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"cache length {max_len} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}: the learned table cannot extend")
        return super().init_cache(batch_size, max_len, dtype=dtype)

    # -------------------------------------------------------------- estimation
    def num_params(self) -> int:
        cfg = self.config
        h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
        layer = 4 * h * h + h * inter * 2 + inter + h
        if cfg.attention_bias:
            layer += 4 * h
        layer += (2 if cfg.shared_layernorm else 4) * h
        total = L * layer + cfg.vocab_size * h + 2 * h
        if cfg.position_style == "learned":
            total += (cfg.max_position_embeddings + cfg.position_offset) * h
        if not cfg.tie_word_embeddings:
            total += h * cfg.vocab_size + (cfg.vocab_size if cfg.lm_head_bias else 0)
        return total

    def flops_per_token(self) -> float:
        """6 x the parameters plus attention's ``12·L·h·max_position_embeddings``."""
        cfg = self.config
        attn_extra = 12 * cfg.num_hidden_layers * cfg.hidden_size * cfg.max_position_embeddings
        return 6 * self.num_params() + attn_extra
