"""Loss primitives — the counterpart of ``accelerate_tpu/ops/losses.py``.

Cross-entropy is computed from logits in fp32 whatever the compute dtype
(bf16 logits lose too much precision in the logsumexp), with an ignore index
for padded positions and the mean taken over valid positions only. Under
sequence or data parallelism a rank holds part of the tokens, and the mean is
the global one: both losses take an explicit ``normalizer`` (the valid-token
count summed over every rank), and each rank's loss is then its own sum over
that count, which the ranks' gradients add up to.

:func:`fused_cross_entropy_loss` computes the same loss straight from the
hidden states, streaming the LM head's vocab dimension in chunks with running
(max, sumexp, label logit) statistics, so the (B·S, V) logit tensor never
exists: peak memory is O(B·S·vocab_chunk). Its two backward strategies are
the JAX package's: ``custom_backward=True`` is one chunked pass that
recomputes each chunk's softmax (a ``torch.autograd.Function``);
``custom_backward=False`` differentiates the chunk loop itself, each chunk
under activation checkpointing as the JAX package's ``jax.checkpoint``, and is
the cross-checking reference. The chunk products are plain ``torch.matmul``
(the JAX package leaves them to XLA, outside any Pallas kernel). The port reads
no environment variable: the model passes its config fields.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def cross_entropy_loss(logits, labels, ignore_index: int = -100, z_loss: float = 0.0,
                       label_smoothing: float = 0.0, normalizer=None):
    """Mean token cross-entropy over non-ignored positions.

    logits: (..., V) float; labels: (...) int. Ignored positions contribute
    zero and are excluded from the mean's denominator, which is the count of
    valid positions, or ``normalizer`` (a count, e.g. over every rank) when
    given."""
    logits = logits.float()
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1, safe_labels[..., None])[..., 0]
    nll = logz - label_logits
    if label_smoothing > 0.0:
        smooth = -torch.log_softmax(logits, dim=-1).mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    if z_loss > 0.0:
        nll = nll + z_loss * logz.square()
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / _denominator(valid, normalizer)


def _denominator(valid, normalizer):
    return valid.sum().clamp(min=1) if normalizer is None else normalizer


# --------------------------------------------------------------------- fused CE

def _chunk_logits(x, w_chunk, *, transposed: bool, cap, dtype):
    """One vocab slice of logits, (T, width) in ``dtype``. ``transposed``:
    ``w_chunk`` is (width, h) rows of a (V, h) table (the tied layout),
    contracted through a transposed view, never a copy."""
    mm = torch.promote_types(x.dtype, w_chunk.dtype)
    x, w_chunk = x.to(mm), w_chunk.to(mm)
    z = x @ w_chunk.T if transposed else x @ w_chunk
    z = z.to(dtype)
    if cap is not None:
        z = torch.tanh(z / cap) * cap
    return z


def _chunk_spans(V: int, vocab_chunk: int):
    """(start, width) pairs covering [0, V): full chunks, then the ragged tail."""
    n_full = V // vocab_chunk
    spans = [(i * vocab_chunk, vocab_chunk) for i in range(n_full)]
    if V - n_full * vocab_chunk:
        spans.append((n_full * vocab_chunk, V - n_full * vocab_chunk))
    return spans


def _slice_w(w, base, width, transposed):
    return w[base:base + width] if transposed else w[:, base:base + width]


def _fold_stats(m, se, label_logit, z, base, width, safe_labels):
    """Fold one chunk's logits into the running (max, sumexp, label logit).
    The accumulators stay fp32 whatever the chunk dtype (a bf16 chunk takes
    its exp in bf16 and sums it in fp32)."""
    m_new = torch.maximum(m, z.amax(dim=-1).float())
    e = torch.exp(z - m_new[:, None].to(z.dtype))
    se = se * torch.exp(m - m_new) + e.sum(dim=-1, dtype=torch.float32)
    hit = (safe_labels >= base) & (safe_labels < base + width)
    local = torch.gather(z, 1, (safe_labels - base).clamp(0, width - 1)[:, None])[:, 0].float()
    return m_new, se, torch.where(hit, local, label_logit)


def _streaming_stats_fwd(x, w, safe_labels, *, vocab_chunk, logit_cap, cd, transposed,
                         checkpointed: bool):
    """Chunked forward pass -> (logz, label_logit), both (T,) fp32. With
    ``checkpointed`` each chunk runs under activation checkpointing, so
    autograd through the loop keeps only the (T,) carries between chunks."""
    T = x.shape[0]
    V = w.shape[0] if transposed else w.shape[-1]
    m = torch.full((T,), float("-inf"), dtype=torch.float32, device=x.device)
    se = torch.zeros((T,), dtype=torch.float32, device=x.device)
    label_logit = torch.zeros((T,), dtype=torch.float32, device=x.device)
    for base, width in _chunk_spans(V, vocab_chunk):

        def one(m, se, label_logit, w_c, _base=base, _width=width):
            z = _chunk_logits(x, w_c, transposed=transposed, cap=logit_cap, dtype=cd)
            return _fold_stats(m, se, label_logit, z, _base, _width, safe_labels)

        w_c = _slice_w(w, base, width, transposed)
        if checkpointed:
            m, se, label_logit = checkpoint(one, m, se, label_logit, w_c, use_reentrant=False)
        else:
            m, se, label_logit = one(m, se, label_logit, w_c)
    return m + torch.log(se), label_logit


def _streaming_stats_bwd(x, w, safe_labels, logz, label_logit, g_logz, g_label, *,
                         vocab_chunk, logit_cap, cd, transposed):
    """Single-pass backward: recompute each chunk's capped logits, form
    g_y = p·g_logz, chain through the softcap and accumulate dx and dw per
    chunk. The label column contributes once, outside the loop: a (T,)-row
    gather of w and a scatter-add into dw."""
    T, h = x.shape
    mm = torch.promote_types(x.dtype, w.dtype)
    V = w.shape[0] if transposed else w.shape[-1]
    x_mm = x.to(mm)
    dx = torch.zeros((T, h), dtype=torch.float32, device=x.device)
    dw = torch.zeros(w.shape, dtype=mm, device=w.device)
    for base, width in _chunk_spans(V, vocab_chunk):
        w_c = _slice_w(w, base, width, transposed)
        z = _chunk_logits(x, w_c, transposed=transposed, cap=logit_cap, dtype=cd).float()
        g_y = torch.exp(z - logz[:, None]) * g_logz[:, None]
        if logit_cap is not None:
            g_y = g_y * (1.0 - torch.square(z / logit_cap))
        # The fp32 cotangent is cast back to the matmul dtype, where the
        # differentiated loop's cast lands too.
        g_y = g_y.to(mm)
        w_c = w_c.to(mm)
        if transposed:
            dx += (g_y @ w_c).float()
            dw[base:base + width] = g_y.T @ x_mm
        else:
            dx += (g_y @ w_c.T).float()
            dw[:, base:base + width] = x_mm.T @ g_y
    gl = g_label
    if logit_cap is not None:
        gl = gl * (1.0 - torch.square(label_logit / logit_cap))
    w_lab = w[safe_labels] if transposed else w[:, safe_labels].T  # (T, h)
    dx += gl[:, None] * w_lab.float()
    scatter = (gl[:, None] * x.float()).to(dw.dtype)
    if transposed:
        dw.index_put_((safe_labels,), scatter, accumulate=True)
    else:
        dw.T.index_put_((safe_labels,), scatter, accumulate=True)
    return dx.to(x.dtype), dw.to(w.dtype)


class _StreamingStats(torch.autograd.Function):
    """(logz, label_logit) with the single-pass chunked backward."""

    @staticmethod
    def forward(ctx, x, w, safe_labels, kw):
        logz, label_logit = _streaming_stats_fwd(x, w, safe_labels, checkpointed=False, **kw)
        ctx.save_for_backward(x, w, safe_labels, logz, label_logit)
        ctx.kw = kw
        return logz, label_logit

    @staticmethod
    def backward(ctx, g_logz, g_label):
        x, w, safe_labels, logz, label_logit = ctx.saved_tensors
        dx, dw = _streaming_stats_bwd(x, w, safe_labels, logz, label_logit, g_logz.float(),
                                      g_label.float(), **ctx.kw)
        return dx, dw, None, None


def fused_cross_entropy_loss(hidden, head_weight, labels, *, ignore_index: int = -100,
                             z_loss: float = 0.0, vocab_chunk: int = 8192, logit_cap=None,
                             chunk_dtype: str = "fp32", head_transposed: bool = False,
                             custom_backward: bool = True, normalizer=None):
    """Cross-entropy straight from hidden states; the full logits never exist.

    hidden: (B, S, h), any float dtype. labels: (B, S) int with
    ``ignore_index`` holes. ``head_weight``: (h, V), or (V, h) with
    ``head_transposed=True`` (the tied embedding table, chunked by rows and
    never transposed-copied). ``vocab_chunk``: vocab tile per step.
    ``chunk_dtype``: ``"fp32"`` or ``"bf16"`` (chunk logits and exp in
    bf16, running statistics in fp32). ``logit_cap``: Gemma-2's tanh softcap
    per chunk. The JAX package's scan ``unroll`` has no counterpart: the
    chunk loop is a Python loop (``LlamaConfig`` validates
    ``fused_loss_unroll`` and nothing reads it). Returns the mean NLL over
    non-ignored positions (+ z-loss), over ``normalizer`` when given."""
    if chunk_dtype not in ("fp32", "bf16"):
        raise ValueError(f"chunk_dtype must be fp32|bf16, got {chunk_dtype!r}")
    if vocab_chunk <= 0:
        raise ValueError(f"vocab_chunk must be > 0, got {vocab_chunk}")
    B, S, h = hidden.shape
    x = hidden.reshape(B * S, h)
    labels = labels.reshape(B * S)
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels)).long()
    kw = dict(vocab_chunk=vocab_chunk, logit_cap=logit_cap,
              cd=torch.bfloat16 if chunk_dtype == "bf16" else torch.float32,
              transposed=head_transposed)
    if custom_backward:
        logz, label_logit = _StreamingStats.apply(x, head_weight, safe_labels, kw)
    else:
        logz, label_logit = _streaming_stats_fwd(x, head_weight, safe_labels,
                                                 checkpointed=True, **kw)
    nll = logz - label_logit
    if z_loss > 0.0:
        nll = nll + z_loss * logz.square()
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / _denominator(valid, normalizer)
