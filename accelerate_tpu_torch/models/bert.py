"""BERT encoder with a sequence-classification head — the counterpart of
``accelerate_tpu/models/bert.py``, the model of ``examples/nlp_example.py``
(bert-base-cased on GLUE/MRPC in the reference).

The parameter tree is the JAX package's (stacked ``(L, ...)`` layer weights,
``(in, out)`` projections), so weights carry across with
``models/from_jax.bert_params_from_numpy``, and the forward is the JAX
package's (``bert.py:141-238``): learned word, position and token-type
embeddings and an f32 LayerNorm (``ops/norms.py``); post-LN layers whose
attention adds a bias of ``-1e30`` on masked keys to scores taken in f32,
with an f32 softmax cast back to the compute dtype; an MLP with exact GELU;
the tanh pooler over ``[CLS]``, the classifier, f32 logits and
``cross_entropy_loss``. The attention is plain PyTorch, as the JAX
package's is a plain einsum and softmax (no Pallas kernel).

Dropout (``hidden_dropout_prob``, after the attention output and the MLP in
train mode) draws from an explicit ``torch.Generator``; it cannot draw the
JAX package's bits, so parity runs at ``hidden_dropout_prob=0.0``.

``remat=True`` (JAX ``bert.py:235``, ``jax.checkpoint`` of the layer with
nothing saved): under autograd each layer runs inside
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so the backward
runs its forward again in place of keeping its activations. The recompute
draws the same dropout masks: the layer's run starts from the dropout
generator's state at its first run, and a recompute puts the generator back
where it found it. So a remat step is the plain step's, bitwise.
``pipeline=`` is not ported and raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..modules import ModelOutput, Module
from ..ops.losses import cross_entropy_loss
from ..ops.norms import layer_norm
from ..utils.device import resolve_device


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_labels: int = 2
    hidden_dropout_prob: float = 0.1
    remat: bool = False

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=128)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def base(cls, **kw):
        return cls(**kw)


def _unstack(tree, n: int) -> list:
    """A stacked ``(L, ...)`` parameter tree as ``n`` per-layer trees of
    views. ``torch.unbind`` differentiates into one stack of the layers'
    gradients; indexing layer by layer would zero a whole stacked tensor
    and add it up once a layer."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


class BertForSequenceClassification(Module):
    def __init__(self, config: BertConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.params = None

    # ------------------------------------------------------------------- init
    def init(self, generator=None, dtype=torch.float32):
        """Random parameters from ``generator`` (a ``torch.Generator`` on the
        model's device, or an int seed): normal with std 0.02 for weights
        and embeddings, ones for LayerNorm scales, zeros for biases."""
        cfg = self.config
        dev = self.device
        if dev.type == "meta":  # shapes only (models/from_jax.py)
            generator = None
        elif not isinstance(generator, torch.Generator):
            seed = 0 if generator is None else int(generator)
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
        h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers

        def dense(shape):
            return torch.randn(shape, generator=generator, device=dev, dtype=dtype).mul_(0.02)

        def const(shape, value):
            return torch.full(shape, value, device=dev, dtype=dtype)

        def ln(shape):
            return {"scale": const(shape, 1.0), "bias": const(shape, 0.0)}

        return {
            "embeddings": {
                "word": dense((cfg.vocab_size, h)),
                "position": dense((cfg.max_position_embeddings, h)),
                "token_type": dense((cfg.type_vocab_size, h)),
                "norm": ln((h,)),
            },
            "layers": {
                "attn": {
                    "wq": dense((L, h, h)), "bq": const((L, h), 0.0),
                    "wk": dense((L, h, h)), "bk": const((L, h), 0.0),
                    "wv": dense((L, h, h)), "bv": const((L, h), 0.0),
                    "wo": dense((L, h, h)), "bo": const((L, h), 0.0),
                },
                "attn_norm": ln((L, h)),
                "mlp": {
                    "w_in": dense((L, h, inter)), "b_in": const((L, inter), 0.0),
                    "w_out": dense((L, inter, h)), "b_out": const((L, h), 0.0),
                },
                "mlp_norm": ln((L, h)),
            },
            "pooler": {"w": dense((h, h)), "b": const((h,), 0.0)},
            "classifier": {"w": dense((h, cfg.num_labels)), "b": const((cfg.num_labels,), 0.0)},
        }

    # ---------------------------------------------------------------- forward
    def embed(self, params, input_ids, attention_mask=None, token_type_ids=None):
        """Embeddings and their LayerNorm; ``ctx`` carries the additive
        attention bias, (B, 1, 1, S) f32."""
        cfg = self.config
        B, S = input_ids.shape
        emb = params["embeddings"]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (F.embedding(input_ids.long(), emb["word"]) + emb["position"][None, :S]
             + F.embedding(token_type_ids.long(), emb["token_type"])).to(emb["word"].dtype)
        x = layer_norm(x, emb["norm"]["scale"], emb["norm"]["bias"], cfg.layer_norm_eps)
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=input_ids.device)
        keep = attention_mask[:, None, None, :].bool()
        zero = torch.zeros((), dtype=torch.float32, device=input_ids.device)
        bias = torch.where(keep, zero, torch.full_like(zero, -1e30))
        return x, {"attention_mask": attention_mask, "bias": bias}

    @staticmethod
    def _dropout(x, generator, rate):
        if rate == 0.0 or generator is None:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x)).to(x.dtype)

    def block(self, layer, x, ctx, generator=None, drop_rate=0.0):
        """One post-LN encoder layer; dropout only with a ``generator``."""
        cfg = self.config
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        B, S, _ = x.shape
        a = layer["attn"]
        q = (x @ a["wq"] + a["bq"]).reshape(B, S, nh, hd).transpose(1, 2)
        k = (x @ a["wk"] + a["bk"]).reshape(B, S, nh, hd).transpose(1, 2)
        v = (x @ a["wv"] + a["bv"]).reshape(B, S, nh, hd).transpose(1, 2)
        scale = 1.0 / math.sqrt(hd)
        scores = (q @ k.transpose(-1, -2)).float() * scale + ctx["bias"]
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = (probs @ v).transpose(1, 2).reshape(B, S, nh * hd)
        attn = self._dropout(attn @ a["wo"] + a["bo"], generator, drop_rate)
        x = layer_norm(x + attn, layer["attn_norm"]["scale"], layer["attn_norm"]["bias"],
                       cfg.layer_norm_eps)
        m = layer["mlp"]
        hdn = F.gelu(x @ m["w_in"] + m["b_in"])
        hdn = self._dropout(hdn @ m["w_out"] + m["b_out"], generator, drop_rate)
        return layer_norm(x + hdn, layer["mlp_norm"]["scale"], layer["mlp_norm"]["bias"],
                          cfg.layer_norm_eps)

    def head(self, params, x, labels=None):
        pooled = torch.tanh(x[:, 0] @ params["pooler"]["w"] + params["pooler"]["b"])
        logits = (pooled @ params["classifier"]["w"] + params["classifier"]["b"]).float()
        out = ModelOutput(logits=logits)
        if labels is not None:
            out["loss"] = cross_entropy_loss(logits, labels)
        return out

    def apply(self, params, input_ids=None, attention_mask=None, token_type_ids=None,
              labels=None, train: bool = False, generator=None, pipeline=None, kernels=None,
              **kwargs):
        """Forward. Dropout runs in ``train`` mode with a ``generator``;
        ``kernels`` is accepted for the accelerator's sake (BERT runs no
        kernel)."""
        if pipeline is not None:
            raise NotImplementedError("pipeline schedules are not ported yet (ROADMAP.md)")
        cfg = self.config
        x, ctx = self.embed(params, input_ids, attention_mask, token_type_ids)
        drop_rate = cfg.hidden_dropout_prob if train else 0.0
        gen = generator if train else None
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in _unstack(params["layers"], cfg.num_hidden_layers):
            if remat:
                x = checkpoint(self._replayable_block(layer, ctx, gen, drop_rate), x,
                               use_reentrant=False)
            else:
                x = self.block(layer, x, ctx, generator=gen, drop_rate=drop_rate)
        return self.head(params, x, labels=labels)

    def _replayable_block(self, layer, ctx, generator, drop_rate):
        """``x -> block(x)`` for a remat region: every run starts from the
        dropout generator's state at the first run, and a recompute (any run
        after the first) puts the generator back where it found it, so the
        recompute draws the forward's masks and later draws are unmoved."""
        start = None if generator is None else generator.get_state()
        runs = [0]

        def run(x):
            if generator is None:
                return self.block(layer, x, ctx, generator=None, drop_rate=drop_rate)
            outer, first = generator.get_state(), runs[0] == 0
            runs[0] += 1
            generator.set_state(start)
            try:
                return self.block(layer, x, ctx, generator=generator, drop_rate=drop_rate)
            finally:  # also when checkpoint's early stop ends a recompute midway
                if not first:
                    generator.set_state(outer)

        return run

    # -------------------------------------------------------------- estimation
    def num_params(self) -> int:
        cfg = self.config
        h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
        emb = (cfg.vocab_size + cfg.max_position_embeddings + cfg.type_vocab_size) * h + 2 * h
        layer = 4 * (h * h + h) + 2 * h * inter + inter + h + 4 * h
        return emb + L * layer + h * h + h + h * cfg.num_labels + cfg.num_labels

    def flops_per_token(self, seq_len: int) -> float:
        """Forward plus backward FLOPs a token: 6 a weight of the encoder's
        matmuls, plus the attention's scores and mixes (12·L·h·S)."""
        cfg = self.config
        h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
        return 6 * L * (4 * h * h + 2 * h * inter) + 12 * L * h * seq_len
