"""Attention — the counterpart of ``accelerate_tpu/ops/attention.py``.

Layout (B, S, H, D) throughout, as in the JAX package. Ported: the dense
path, the cached (decode) path the paged serving engine runs, causal flash
attention (op ``flash_attention``: the hand-written CUDA kernel of
``csrc/flash_attention.cu`` for CUDA tensors, :func:`flash_attention_reference`
for CPU tensors or ``kernels="off"``) and splash attention, the block-sparse
variant with a local window, a tanh logit softcap and a query scale, which
the Mistral, Gemma-2 and Qwen2 recipes need (op ``splash_attention``:
``csrc/splash_attention.cu``, plain version :func:`splash_attention_reference`).
``impl="ring"`` is sequence-parallel ring attention over a process group
(``parallel/ring.py``, whose blocks are the ring-block kernels of
``csrc/flash_attention.cu``); ``"ulysses"`` is not ported yet and raises.

``impl="auto"`` resolves by :func:`resolve_auto_impl`, for a CUDA tensor at
kernel-friendly shapes from :data:`FLASH_MIN_SEQ` tokens on: splash for a
windowed, softcapped or scaled recipe, flash for plain causal attention;
dense otherwise, and always dense for a CPU tensor. The crossover is a
constant: the port reads no environment variable.
"""

from __future__ import annotations

import math

import torch

from .kernels.flash_attention import HEAD_DIMS as KERNEL_HEAD_DIMS
from .kernels.flash_attention import flash_attention_cuda
from .kernels.splash_attention import HEAD_DIMS as SPLASH_HEAD_DIMS
from .kernels.splash_attention import splash_attention_cuda
from .registry import dispatch, register_op

# Dense/flash crossover: the JAX package's default for a device without an
# entry of its own (``_DEFAULT_FLASH_MIN_SEQ``).
FLASH_MIN_SEQ = 1024
# The library kernels' DEFAULT_MASK_VALUE: added to masked logits by flash,
# put in their place by splash.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


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
    scores = cached_scores(q, k_cache, q_positions=q_positions, kv_mask=kv_mask, window=window,
                           softcap=softcap, scale=scale)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v_cache.dtype)
    out = torch.einsum("bhgsk,bkhd->bshgd", probs.to(dt), v_cache.to(dt))
    return out.reshape(B, S, H, D)


def cached_scores(q, k_cache, *, q_positions, kv_mask=None, window=None, softcap=None,
                  scale=None):
    """The biased f32 scores of :func:`cached_attention`, ``(B, Hkv, G, S,
    K)``: scaled (and softcapped) products plus the ``-1e30`` causal, window
    and validity biases, added as the softmax sees them."""
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
    return scores + bias


def flash_attention_reference(q, k, v, segment_ids=None, causal=True, sm_scale=1.0):
    """Plain version of the flash kernel, with the semantics of the library's
    ``mha_reference`` (``jax/experimental/pallas/ops/tpu/flash_attention.py``)
    in this package's (B, S, H, D) layout: f32 logits times ``sm_scale``,
    ``MASK_VALUE`` added where the causal or segment-id mask excludes a key,
    max-subtracted softmax, weights times V. ``segment_ids``: (B, S) int; a
    query sees only keys of its own segment. Its gradient comes from
    autograd. Returns q's dtype."""
    S, Skv = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if sm_scale != 1.0:
        logits = logits * sm_scale
    mask = None
    if segment_ids is not None:
        mask = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
    if causal:
        rows = torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(Skv, device=q.device)[None, :]
        causal_mask = (cols <= rows)[None, None]
        mask = causal_mask if mask is None else mask & causal_mask
    if mask is not None:
        logits = logits + torch.where(mask, 0.0, MASK_VALUE)
    m = logits.amax(dim=-1, keepdim=True)
    unnormalized = torch.exp(logits - m)
    weights = unnormalized / unnormalized.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.float()).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, mask=None, kernels=None):
    """Flash attention, layout (B, S, H, D); the counterpart of the JAX
    package's ``flash_attention`` (``ops/attention.py:144``).

    ``mask``: (B, S) with 1 for real tokens. Padding rides segment ids as
    in the JAX package: real tokens are segment 2 and pads segment 1, so
    pads see only pads. GQA KV heads (``k.shape[2] < q.shape[2]``) are
    repeated to the query heads first, so the gradients are the repeat's
    VJP (each KV head sums its G query heads). ``sm_scale`` is 1/sqrt(D)."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, v, n_rep)
    segment_ids = None
    if mask is not None:
        segment_ids = torch.where(mask.bool(), 2, 1).to(torch.int32).contiguous()
    return dispatch("flash_attention", q.contiguous(), k.contiguous(), v.contiguous(),
                    segment_ids=segment_ids, causal=causal,
                    sm_scale=1.0 / math.sqrt(q.shape[-1]), kernels=kernels)


def splash_attention_reference(q, k, v, segment_ids=None, window=None, softcap=None):
    """Plain version of the splash kernel, with the semantics of the
    library's ``attention_reference`` and ``_apply_mask_and_soft_cap``
    (``jax/experimental/pallas/ops/tpu/splash_attention/
    splash_attention_kernel.py``) in this package's (B, S, H, D) layout, equal
    head counts: f32 logits ``q·kᵀ`` with no scale (q arrives pre-scaled);
    the softcap ``tanh(l / cap) · cap``; then masked logits are *replaced* by
    ``MASK_VALUE``, where the mask is causal (``0 <= q - k``, and ``q - k <
    window`` with a window) AND segment-id equality; a max-subtracted f32
    softmax; P·V in f32 with V cast to f32 (splash does not round P); the
    output in q's dtype. The weights are normalized after P·V, as the kernel
    does, which keeps one (B, H, S, S) tensor fewer for autograd than
    dividing P first. Its gradient comes from autograd, which equals the
    library's custom backward (softcap factor ``1 - tanh²``)."""
    S = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    keep = cols <= rows
    if window is not None:
        keep = keep & (rows - cols < window)
    keep = keep[None, None]
    if segment_ids is not None:
        keep = keep & (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
    logits = torch.where(keep, logits, MASK_VALUE)
    m = logits.amax(dim=-1, keepdim=True).detach()
    unnormalized = torch.exp(logits - m)
    total = unnormalized.sum(dim=-1)  # (B, H, S)
    out = torch.einsum("bhqk,bkhd->bqhd", unnormalized, v.float())
    return (out / total.transpose(1, 2)[..., None]).to(q.dtype)


def splash_attention(q, k, v, *, causal=True, mask=None, window=None, softcap=None,
                     scale=None, kernels=None):
    """Splash attention, layout (B, S, H, D); the counterpart of the JAX
    package's ``splash_attention`` (``ops/attention.py:180``), step for step:
    causal only, equal q and kv lengths; GQA KV heads repeated; q pre-scaled
    in its own dtype (``scale`` defaults to 1/sqrt(D); Gemma-2 passes
    ``query_pre_attn_scalar ** -0.5``); the window as the local mask ``0 <= q
    - k < window``; padding (``mask`` (B, S), 1 = real) as segment ids, real
    tokens 2 and pads 1. Then op ``splash_attention`` through the registry."""
    if not causal:
        raise ValueError("splash_attention is causal-only (the mask is built causal)")
    if k.shape[1] != q.shape[1]:
        raise ValueError(
            f"splash_attention needs equal q/kv lengths, got {q.shape[1]} vs "
            f"{k.shape[1]}; use impl='dense' for cross-length attention."
        )
    B, S, H, D = q.shape
    k, v = repeat_kv(k, v, H // k.shape[2])
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    # The scale rounded to q's dtype, as jnp.asarray(scale, q.dtype).
    q = (q * torch.tensor(scale, dtype=q.dtype).item()).to(q.dtype)
    segment_ids = None
    if mask is not None:
        segment_ids = torch.where(mask.bool(), 2, 1).to(torch.int32).contiguous()
    return dispatch("splash_attention", q.contiguous(), k.contiguous(), v.contiguous(),
                    segment_ids=segment_ids, window=window, softcap=softcap, kernels=kernels)


def resolve_auto_impl(seq_len: int, head_dim: int, *, kv_len: int | None = None,
                      causal: bool = True, window=None, softcap=None, scale=None, device=None,
                      dtype=None) -> str:
    """What ``impl='auto'`` resolves to for this shape, recipe, device and
    dtype — the single source of the dispatch predicate. A kernel needs a
    CUDA device, a bf16 (or unstated) dtype, equal query and key lengths and
    a sequence that is a multiple of 128 from :data:`FLASH_MIN_SEQ` tokens
    on. Windowed, softcapped or scaled recipes resolve to splash where it is
    also causal and the head width is in :data:`SPLASH_HEAD_DIMS`; plain
    attention resolves to flash at a head width in :data:`KERNEL_HEAD_DIMS`
    (the JAX predicate also admits 96, and 256 for flash, which wait for a
    later kernel). Everything else, and every CPU tensor, resolves to
    dense."""
    kv_len = seq_len if kv_len is None else kv_len
    on_card = device is not None and torch.device(device).type == "cuda"
    dtype_ok = dtype is None or dtype == torch.bfloat16
    kernel_ok = (on_card and dtype_ok and kv_len == seq_len and seq_len % 128 == 0
                 and seq_len >= FLASH_MIN_SEQ)
    if window is not None or softcap is not None or scale is not None:
        return "splash" if kernel_ok and causal and head_dim in SPLASH_HEAD_DIMS else "dense"
    return "flash" if kernel_ok and head_dim in KERNEL_HEAD_DIMS else "dense"


def attention(q, k, v, *, causal=True, mask=None, impl: str = "auto", window=None,
              softcap=None, scale=None, kernels=None, group=None):
    """Entry used by the model zoo for the uncached forward.
    ``impl``: auto | dense | flash | splash | ring. ``window``, ``softcap``
    and ``scale`` take the dense or splash path (``auto`` picks by
    :func:`resolve_auto_impl`); flash and ring cannot apply them. As in the
    JAX package, ``impl="splash"`` without any of the three runs dense.
    ``impl="ring"``: q, k, v and ``mask`` are this rank's sequence shards
    and ``group`` the sp process group (``parallel/ring.ring_attention``;
    dense attention without one). ``kernels`` is the registry spec handed to
    the flash, splash and ring-block ops (``"off"`` runs their plain
    versions)."""
    if impl == "ulysses":
        raise NotImplementedError(
            "attention impl='ulysses' is not ported yet (ROADMAP.md, module queue: "
            "Ulysses sequence parallelism)"
        )
    shaped = window is not None or softcap is not None or scale is not None
    if impl == "ring":
        if shaped:
            raise ValueError("ring attention cannot apply window/softcap/scale options")
        from ..parallel.ring import ring_attention  # parallel.ring imports this module

        return ring_attention(q, k, v, causal=causal, mask=mask, group=group, kernels=kernels)
    if shaped and impl not in ("auto", "dense", "splash"):
        raise ValueError(
            f"window/softcap/scale attention options need the dense path or splash; "
            f"impl={impl!r} cannot apply them."
        )
    if impl == "auto":
        impl = resolve_auto_impl(q.shape[1], q.shape[3], kv_len=k.shape[1], causal=causal,
                                 window=window, softcap=softcap, scale=scale, device=q.device,
                                 dtype=q.dtype)
    if impl == "splash" and shaped:
        return splash_attention(q, k, v, causal=causal, mask=mask, window=window,
                                softcap=softcap, scale=scale, kernels=kernels)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, mask=mask, kernels=kernels)
    if impl not in ("dense", "splash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return dense_attention(q, k, v, causal=causal, mask=mask, window=window, softcap=softcap,
                           scale=scale)


# Causal flash attention, forward and backward (one autograd.Function).
register_op("flash_attention", flash_attention_reference, flash_attention_cuda)
# Causal splash attention with window, softcap and segment ids on pre-scaled
# q, forward and backward (one autograd.Function).
register_op("splash_attention", splash_attention_reference, splash_attention_cuda)
