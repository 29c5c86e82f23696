"""Attention in plain PyTorch — the counterpart of ``accelerate_tpu/ops/attention.py``.

Layout (B, S, H, D) throughout, as in the JAX package. This slice ports the
dense path and the cached (decode) path, which is what the paged serving
engine runs; the flash and splash kernels and the sequence-parallel paths
are later slices (ROADMAP.md, kernel queue) and raise when asked for.
"""

from __future__ import annotations

import math

import torch


def repeat_kv(k, v, n_rep: int):
    if n_rep == 1:
        return k, v
    return k.repeat_interleave(n_rep, dim=2), v.repeat_interleave(n_rep, dim=2)


def softcap_scores(scores, cap):
    """Gemma-2 logit softcapping: ``tanh(scores / cap) * cap``."""
    return torch.tanh(scores / cap) * cap


def dense_attention(q, k, v, *, causal=True, mask=None, positions_q=None,
                    positions_kv=None, window=None, softcap=None, scale=None):
    """q: (B,S,H,D), k/v: (B,Skv,H,D); mask: (B,Skv) 1=real. fp32 softmax.

    ``window``: a query attends keys with ``0 <= q_pos - k_pos < window``.
    ``softcap``: tanh cap on the scores. ``scale``: default 1/sqrt(D)."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True (bidirectional windows unsupported)")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dt = torch.promote_types(q.dtype, k.dtype)  # jnp.einsum promotes mixed operands
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)).float() * scale
    if softcap is not None:
        scores = softcap_scores(scores, softcap)
    bias = torch.zeros_like(scores)
    if causal or window is not None:
        if positions_q is None:
            positions_q = torch.arange(q.shape[1], device=q.device)
        if positions_kv is None:
            positions_kv = torch.arange(k.shape[1], device=q.device)
        delta = positions_q[:, None] - positions_kv[None, :]
        keep = delta >= 0 if causal else torch.ones_like(delta, dtype=torch.bool)
        if window is not None:
            keep = keep & (delta < window)
        bias = torch.where(keep[None, None], bias, -1e30)
    if mask is not None:
        bias = bias + torch.where(mask[:, None, None, :].bool(), 0.0, -1e30)
    probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), v.to(dt))


def cached_attention(q, k_cache, v_cache, *, q_positions, kv_mask=None, window=None,
                     softcap=None, scale=None):
    """Attention of a query chunk against a pre-allocated KV cache (decode path).

    q: (B, S, H, D); k_cache/v_cache: (B, K, Hkv, D) with H = G·Hkv (GQA).
    q_positions: (S,) or (B, S) cache-slot positions of the queries.
    kv_mask: (B, K) validity of cache slots (1 = real token).

    Semantics kept from the JAX version: queries are grouped (B,S,Hkv,G,D) so
    the GQA repeat never materializes; causal and kv_mask exclusions are
    ``-1e30`` biases; sliding windows measure VALID-slot distance when a
    ``kv_mask`` is given, so holes in the cache never stretch a window."""
    B, S, H, D = q.shape
    K, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, G, D)
    dt = torch.promote_types(q.dtype, k_cache.dtype)  # jnp.einsum promotes mixed operands
    scores = torch.einsum("bshgd,bkhd->bhgsk", qg.to(dt), k_cache.to(dt)).float() * scale
    if softcap is not None:
        scores = softcap_scores(scores, softcap)
    if q_positions.ndim == 1:
        q_positions = q_positions[None].expand(B, S)
    slots = torch.arange(K, device=q.device)
    delta = q_positions[:, None, None, :, None] - slots[None, None, None, None, :]
    keep = delta >= 0
    if window is not None:  # sliding window: the last `window` valid tokens
        if kv_mask is not None:
            rank = torch.cumsum(kv_mask.to(torch.int32), dim=1)  # (B, K)
            q_rank = torch.gather(rank, 1, q_positions.to(torch.int64))
            dvalid = q_rank[:, None, None, :, None] - rank[:, None, None, None, :]
            keep = keep & (dvalid < window)
        else:
            keep = keep & (delta < window)
    bias = torch.where(keep, 0.0, -1e30)
    if kv_mask is not None:
        bias = bias + torch.where(kv_mask[:, None, None, None, :].bool(), 0.0, -1e30)
    probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v_cache.dtype)
    out = torch.einsum("bhgsk,bkhd->bshgd", probs.to(dt), v_cache.to(dt))
    return out.reshape(B, S, H, D)


def attention(q, k, v, *, causal=True, mask=None, impl: str = "auto", window=None,
              softcap=None, scale=None):
    """Entry used by the model zoo for the uncached forward. ``auto`` and
    ``dense`` run :func:`dense_attention`; the flash, splash, ring and
    ulysses implementations are not ported yet."""
    if impl not in ("auto", "dense"):
        raise NotImplementedError(
            f"attention impl={impl!r} is not ported yet (ROADMAP.md, kernel "
            "queue: flash and splash attention, ring attention)"
        )
    return dense_attention(q, k, v, causal=causal, mask=mask, window=window,
                           softcap=softcap, scale=scale)
