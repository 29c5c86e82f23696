"""Paged (block-table) KV cache — pool helpers and the gather op.

The PyTorch counterpart of ``accelerate_tpu/ops/paged_attention.py:66-235``.
The serving engine's paged mode keeps each layer's KV cache as a block pool,
``(L, num_blocks + 1, block_size, kv_heads, head_dim)``, plus per-slot block
tables mapping a request's token chain onto pool blocks. Pool invariants,
shared with ``serving.py``:

- Block 0 is the **trash block**: never allocated, and its mask rows stay
  zero, so unassigned table entries (0) gather as masked garbage.
- ``pool["mask"]`` is per-token validity (1 = real token).
- Rope rotations are baked into K at write time from the token position, so
  a full block's K/V is a pure function of (params, token prefix) and can be
  shared by every request whose prompt starts with the same tokens.

:func:`gather_block_view` is the plain version of the gather;
:func:`gather_view` dispatches op ``paged_gather`` (``ops/registry.py``) to
the hand-written CUDA kernel for CUDA tensors (``ops/kernels/paged_gather``).
:func:`paged_attention` is the fused decode attention over block chains, op
``paged_decode``: the CUDA kernel of ``ops/kernels/paged_decode`` for CUDA
tensors, :func:`paged_attention_plain` (the plain gather, then
``cached_attention``) for CPU tensors or ``kernels="off"``;
:func:`paged_decode_split_reference` is the kernel's partition and merge
in plain PyTorch, for the tests. As in the JAX
package, the serving engine does not call it: the engine assembles views
with the gather. ``export_chain_blocks``/``import_chain_blocks`` arrive
with the serving network slice.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from .attention import cached_attention, cached_scores
from .kernels.paged_decode import CONSUMERS, paged_decode_cuda, plan
from .kernels.paged_gather import paged_gather
from .registry import dispatch, register_op


def init_kv_pool(module, num_blocks: int, block_size: int, dtype=torch.bfloat16,
                 quant: str | None = None, device=None):
    """Allocate the per-layer block pool for ``module``'s cache layout.

    Returns ``{"k": (L, N, bs, Hkv, D), "v": same, "mask": (N, bs) int32}``
    with ``N = num_blocks + 1`` (block 0 is the trash block).
    ``quant="int8"`` stores K/V as int8 and adds per-token scale tables
    ``{"k_scale": (L, N, bs) float32, "v_scale": same}``."""
    if quant not in (None, "int8"):
        raise ValueError(f"kv pool quant must be None or 'int8', got {quant!r}")
    dev = resolve_device(device)
    cfg = module.config
    L, hkv, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    n = num_blocks + 1
    store = torch.int8 if quant == "int8" else dtype
    pool = {
        "k": torch.zeros((L, n, block_size, hkv, hd), dtype=store, device=dev),
        "v": torch.zeros((L, n, block_size, hkv, hd), dtype=store, device=dev),
        "mask": torch.zeros((n, block_size), dtype=torch.int32, device=dev),
    }
    if quant == "int8":
        pool["k_scale"] = torch.zeros((L, n, block_size), dtype=torch.float32, device=dev)
        pool["v_scale"] = torch.zeros((L, n, block_size), dtype=torch.float32, device=dev)
    return pool


def pool_is_quantized(pool) -> bool:
    """Whether a pool carries int8 payloads + per-token scale tables."""
    return "k_scale" in pool


def gather_block_view(pool_kv, block_tables, *, active=None, scales=None, out_dtype=None):
    """Plain version: materialize per-slot contiguous KV views from the pool.

    ``pool_kv``: ``(..., N, bs, H, D)`` (one layer or the L-stacked pool);
    ``block_tables``: ``(B, M)`` block ids. Returns ``(..., B, M*bs, H, D)``,
    slot ``b``'s chain left-packed in table order. ``scales`` (``(..., N,
    bs)``) dequantizes an int8 pool per token row (``q.float() * scale``,
    then one cast to ``out_dtype``, float32 by default). ``active`` is
    accepted for signature parity with the kernel, which zeroes inactive
    slots; this version gathers every slot (their rows are masked garbage)."""
    del active
    b, m = block_tables.shape
    idx = block_tables.reshape(-1).long()
    view = pool_kv.index_select(pool_kv.dim() - 4, idx)  # (..., B*M, bs, H, D)
    view = view.reshape(view.shape[:-4] + (b, m * view.shape[-3]) + view.shape[-2:])
    if scales is None:
        return view if out_dtype is None else view.to(out_dtype)
    s = scales.index_select(scales.dim() - 2, idx)  # (..., B*M, bs)
    s = s.reshape(s.shape[:-2] + (b, m * s.shape[-1]))
    deq = view.float() * s[..., None, None].float()
    return deq.to(torch.float32 if out_dtype is None else out_dtype)


def gather_view(pool_kv, block_tables, *, active=None, scales=None, out_dtype=None,
                kernels=None):
    """Registry-dispatched view assembly (op ``paged_gather``): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors or
    ``kernels="off"``. Bitwise equal on active slots."""
    return dispatch("paged_gather", pool_kv, block_tables, active=active, scales=scales,
                    out_dtype=out_dtype, kernels=kernels)


def gather_block_mask(pool_mask, block_tables):
    """Per-slot validity view: ``(N, bs)`` pool mask + ``(B, M)`` tables →
    ``(B, M*bs)``."""
    b, m = block_tables.shape
    return pool_mask.index_select(0, block_tables.reshape(-1).long()).reshape(
        b, m * pool_mask.shape[1])


def paged_attention_reference(q, k_pool, v_pool, block_tables, *, q_positions,
                              pool_mask=None, window=None, softcap=None, scale=None,
                              active=None, k_scale=None, v_scale=None):
    """Gather each slot's chain to a contiguous view, then run
    :func:`~.attention.cached_attention` (causality on chain-slot order,
    validity from the gathered mask, windows in valid-slot distance). The
    gather goes through :func:`gather_view` with every slot active, so on
    the card it is the gather kernel and equals the plain version bitwise.
    The fused kernel that replaces this composition is op ``paged_decode``
    (:func:`paged_attention`)."""
    del active
    k_view = gather_view(k_pool, block_tables, scales=k_scale)
    v_view = gather_view(v_pool, block_tables, scales=v_scale)
    kv_mask = gather_block_mask(pool_mask, block_tables) if pool_mask is not None else None
    return cached_attention(q, k_view, v_view, q_positions=q_positions, kv_mask=kv_mask,
                            window=window, softcap=softcap, scale=scale)


def paged_attention_plain(q, k_pool, v_pool, block_tables, *, q_positions, pool_mask=None,
                          window=None, softcap=None, scale=None, active=None, k_scale=None,
                          v_scale=None):
    """Plain version of op ``paged_decode``: the plain gather
    (:func:`gather_block_view`) of each slot's chain, dequantized to f32
    when ``k_scale``/``v_scale`` are given, then
    :func:`~.attention.cached_attention`. ``active`` is ignored: inactive
    slots get masked garbage here and zeros from the kernel."""
    del active
    k_view = gather_block_view(k_pool, block_tables, scales=k_scale)
    v_view = gather_block_view(v_pool, block_tables, scales=v_scale)
    kv_mask = gather_block_mask(pool_mask, block_tables) if pool_mask is not None else None
    return cached_attention(q, k_view, v_view, q_positions=q_positions, kv_mask=kv_mask,
                            window=window, softcap=softcap, scale=scale)


def paged_decode_split_reference(q, k_pool, v_pool, block_tables, *, q_positions,
                                 pool_mask=None, window=None, softcap=None, scale=None,
                                 active=None, k_scale=None, v_scale=None, split_blocks=None):
    """The decode kernel's arithmetic order in plain f32 PyTorch, for the
    tests (never on the path): the chain cut into the splits of
    :func:`~.kernels.paged_decode.plan` (``split_blocks`` whole blocks, or
    plan's choice), block ``i`` of a split taken by consumer ``i % 3`` with
    an online softmax (running max, sum and unnormalised accumulator), the
    consumers combined in order, then the splits merged in order and
    normalised. The scores are :func:`~.attention.cached_scores` of the
    plainly gathered chain (biases included). Inactive slots give zeros,
    as the kernel's."""
    B, S, H, D = q.shape
    N, bs, Hkv, _ = k_pool.shape
    M = block_tables.shape[1]
    G = H // Hkv
    if split_blocks is None:
        split_blocks = plan(B, S, H, Hkv, D, bs, M, q_dtype=q.dtype, kv_dtype=k_pool.dtype,
                            has_mask=pool_mask is not None,
                            use_rank=window is not None and pool_mask is not None)["split_blocks"]
    k_view = gather_block_view(k_pool, block_tables, scales=k_scale)
    v_view = gather_block_view(v_pool, block_tables, scales=v_scale).float()
    kv_mask = gather_block_mask(pool_mask, block_tables) if pool_mask is not None else None
    scores = cached_scores(q, k_view, q_positions=q_positions, kv_mask=kv_mask, window=window,
                           softcap=softcap, scale=scale)  # (B, Hkv, G, S, T)

    def state(blocks):
        """(m, l, o) of one consumer's blocks, walked in order."""
        m = scores.new_full(scores.shape[:-1], -torch.inf)
        l = scores.new_zeros(scores.shape[:-1])
        o = scores.new_zeros(scores.shape[:-1] + (D,))
        for j in blocks:
            s = scores[..., j * bs:(j + 1) * bs]
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum("bhgsk,bkhd->bhgsd", p,
                                                    v_view[:, j * bs:(j + 1) * bs])
            m = m_new
        return m, l, o

    def combine(states):
        """The fixed-order merge of (m, l, o) states."""
        m = torch.stack([st[0] for st in states]).amax(0)
        l, o = torch.zeros_like(m), m.new_zeros(m.shape + (D,))
        for m_i, l_i, o_i in states:
            e = torch.exp(m_i - m)  # 0 for a state without blocks (m_i = -inf)
            l, o = l + l_i * e, o + o_i * e[..., None]
        return m, l, o

    splits = [combine([state(range(j0 + w, j1, CONSUMERS)) for w in range(CONSUMERS)])
              for j0, j1 in ((j, min(M, j + split_blocks)) for j in range(0, M, split_blocks))]
    _, l, o = combine(splits)
    out = (o / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    if active is not None:
        out = out * (active != 0).reshape(B, 1, 1, 1)
    out_dt = torch.float32 if k_scale is not None else torch.promote_types(q.dtype, v_pool.dtype)
    return out.to(out_dt)


def paged_attention(q, k_pool, v_pool, block_tables, *, q_positions, pool_mask=None,
                    window=None, softcap=None, scale=None, active=None, k_scale=None,
                    v_scale=None, kernels=None):
    """Attention of a query chunk against block-table-addressed KV pools;
    the counterpart of the JAX package's op face
    (``accelerate_tpu/ops/paged_attention.py:238``).

    q: ``(B, S, H, D)``; k_pool/v_pool: ``(N, bs, Hkv, D)`` (one layer);
    block_tables: ``(B, M)``; q_positions: ``(S,)`` or ``(B, S)`` positions
    in each slot's chain-slot index space; pool_mask: ``(N, bs)`` per-token
    validity; ``active``: per-slot flags (the kernel gives zeros for
    inactive slots); ``k_scale``/``v_scale``: ``(N, bs)`` f32 scales of an
    int8 pool. Returns f32 for an int8 pool, else the promotion of q's and
    the pool's types. Dispatches op ``paged_decode``: the CUDA kernel for
    CUDA tensors, :func:`paged_attention_plain` for CPU tensors or
    ``kernels="off"``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: k_scale and v_scale come together")
    return dispatch("paged_decode", q, k_pool, v_pool, block_tables, q_positions=q_positions,
                    pool_mask=pool_mask, window=window, softcap=softcap, scale=scale,
                    active=active, k_scale=k_scale, v_scale=v_scale, kernels=kernels)


# Chain-walk assembly of per-slot KV views (zeros for inactive slots).
register_op("paged_gather", gather_block_view, paged_gather)
# Ragged decode attention over block-table chains (no gathered view).
register_op("paged_decode", paged_attention_plain, paged_decode_cuda)
