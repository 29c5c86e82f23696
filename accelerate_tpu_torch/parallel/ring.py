"""Ring attention — the counterpart of ``accelerate_tpu/parallel/ring.py``.

Sequence parallelism over an ``sp`` group of ranks: each rank holds the
shard ``[r·S/sp, (r+1)·S/sp)`` of q, k and v (layout (B, S/sp, H, D), KV
heads already repeated to the query heads, as the JAX model does before the
ring). KV shards travel around the ring, one hop a step, and each rank folds
every visiting block into running softmax statistics (m, l, acc) in f32, so
no rank ever holds an S x S score matrix. Causality is decided by global
positions: the block that rank r sees at step s is block ``(r - s) mod n``.
The backward is an explicit second ring (a ``torch.autograd.Function``, as
JAX's ``custom_vjp``): dk/dv accumulators travel WITH their KV block, so
after n hops each arrives home; delta = rowsum(dO * O) is computed once per
rank, not once per block.

Per-block compute, ``block_impl``:

- ``"dense"``: :func:`_dense_block_fwd` / :func:`_dense_block_bwd`, the JAX
  package's einsum blocks with the streaming merge (its CPU default);
- ``"flash"`` (the default): ops ``ring_block_fwd`` / ``ring_block_bwd`` of
  the registry, the hand-written kernels of ``csrc/flash_attention.cu`` for
  CUDA tensors and their plain twins :func:`ring_block_fwd_reference` /
  :func:`ring_block_bwd_reference` for CPU tensors or ``kernels="off"``.
  Mode 0 is the diagonal block (causal inside), 1 a fully visible block, 2 a
  skipped one; the ring loop makes no call and no merge for a skipped block,
  which equals merging the zeros and -1e30 stats JAX's skip branch returns.

JAX reads ``ACCELERATE_RING_BLOCK`` to pick the block; the port reads no
environment variable to switch a backend, so the choice is the argument.

The ring loop runs over a small communicator interface with two
implementations; both make the same block calls in the same order, so their
results are bitwise equal on the CPU:

- :class:`ProcessGroupRing`: one rank per process, hops by
  ``dist.batch_isend_irecv`` to rank + 1 and from rank - 1 of the sp group.
  Block j + 1's KV hop is posted before block j's compute and waited after
  it (the overlap XLA gives the JAX ring). The forward makes n - 1 KV hops
  (the JAX ring's last hop only brings the blocks home); the backward's
  dk/dv accumulators hop after each step's compute, n times.
- :class:`LoopbackRing`: all n ranks in one process. Every rank takes step
  s before any rank takes step s + 1, and a hop rotates the list. It lets
  one card drive the kernels exactly as a ring of n cards would
  (``chip_smoke.py``); no entry point uses it.

The block index a rank holds is computed, ``(rank - step) mod n``, where JAX
ships it around the ring with the block; the mask shard, when there is one,
travels with its block (no mask, no mask traffic). An sp group of size 1
runs dense attention, as JAX does on a mesh without an ``sp`` axis.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..ops.attention import MASK_VALUE, dense_attention
from ..ops.kernels.ring_block import (
    DIAGONAL,
    FULL,
    NEG_INF,
    SKIP,
    ring_block_bwd_cuda,
    ring_block_fwd_cuda,
)
from ..ops.registry import dispatch, register_op

BLOCK_IMPLS = ("flash", "dense")


# --------------------------------------------------------------------- blocks
def _dense_block_fwd(q, k_cur, v_cur, mask_cur, pos_q, pos_k, m, l, acc, causal):
    """One visiting KV block, dense: f32 scores + flash-style streaming merge
    (JAX ``ring.py:50-71``)."""
    b, s_loc, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_cur).float() * scale
    bias = torch.zeros((b, 1, s_loc, pos_k.shape[0]), dtype=torch.float32, device=q.device)
    if causal:
        visible = pos_q[:, None] >= pos_k[None, :]
        bias = torch.where(visible[None, None], bias, NEG_INF)
    if mask_cur is not None:
        bias = bias + torch.where(mask_cur[:, None, None, :].bool(), 0.0, NEG_INF)
    scores = scores + bias
    valid = scores > NEG_INF / 2
    m_j = scores.amax(dim=-1)
    m_new = torch.maximum(m, m_j)
    p = torch.exp(scores - m_new[..., None]) * valid
    l_j = p.sum(dim=-1)
    alpha = torch.exp(m - m_new)
    o_j = torch.einsum("bhqk,bkhd->bqhd", p.to(v_cur.dtype), v_cur).float()
    l_new = l * alpha + l_j
    acc_new = acc * alpha.transpose(1, 2)[..., None] + o_j
    return m_new, l_new, acc_new


def _dense_block_bwd(q, k_cur, v_cur, mask_cur, pos_q, pos_k, lse, dout, delta, causal):
    """Gradients of one visiting block, probabilities rebuilt from the global
    lse (JAX ``ring.py:187-206``)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_cur).float() * scale
    bias = torch.zeros_like(scores[:, :1])
    if causal:
        visible = pos_q[:, None] >= pos_k[None, :]
        bias = torch.where(visible[None, None], bias, NEG_INF)
    if mask_cur is not None:
        bias = bias + torch.where(mask_cur[:, None, None, :].bool(), 0.0, NEG_INF)
    scores = scores + bias
    p = torch.exp(scores - lse[..., None])
    dout32 = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout32)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout32, v_cur.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k_cur.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq, dk, dv


def _block_logits(q, k, kv_mask, causal: bool):
    """f32 logits (B, H, S, S) of one block times 1/sqrt(D), with
    ``MASK_VALUE`` added where the causal diagonal or the kv mask excludes a
    key (the library flash kernel's masking). Built in place: at a shard of
    8192 tokens and 32 heads the tensor is 8.6 GB."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s.mul_(1.0 / math.sqrt(q.shape[-1]))
    keep = None
    if kv_mask is not None:
        keep = kv_mask.bool()[:, None, None, :]
    if causal:
        tri = torch.ones((S, S), dtype=torch.bool, device=q.device).tril_()
        keep = tri if keep is None else keep & tri
    if keep is not None:
        s.add_(torch.where(keep, 0.0, MASK_VALUE))
    return s


def ring_block_fwd_reference(q, k, v, kv_mask, mode: int):
    """Plain twin of the ring-block forward kernel (op ``ring_block_fwd``),
    with its contract: ``(o, l, m)`` with ``o`` (B, S, H, D) the
    block-normalised output in q's dtype and ``l``, ``m`` (B, H, S) f32, the
    row sums and maxima of the library kernel's residuals
    (``_flash_attention(..., save_residuals=True)``). ``mode``: 0 diagonal
    (causal inside the block), 1 fully visible, 2 skipped (zeros and
    ``m = -1e30``). ``kv_mask`` (B, S), 1 = real key, or None. A row that sees
    no key gives ``o = 0, l = 0, m = -1e30``."""
    B, S, H, D = q.shape
    if mode == SKIP:
        return (torch.zeros_like(q), torch.zeros((B, H, S), device=q.device),
                torch.full((B, H, S), NEG_INF, device=q.device))
    p = _block_logits(q, k, kv_mask, causal=mode == DIAGONAL)
    m = p.amax(dim=-1)
    p.sub_(m[..., None]).exp_()
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    del p
    none = m < MASK_VALUE / 2  # every logit of the row carried MASK_VALUE
    o.div_(torch.where(none, 1.0, l).transpose(1, 2)[..., None])
    o.masked_fill_(none.transpose(1, 2)[..., None], 0.0)
    return (o.to(q.dtype), torch.where(none, 0.0, l), torch.where(none, NEG_INF, m))


def ring_block_bwd_reference(q, k, v, kv_mask, mode: int, lse, dout, delta, dq, dk, dv):
    """Plain twin of the ring-block backward kernel (op ``ring_block_bwd``):
    adds one block's gradients into the f32 accumulators ``dq`` (the rank's
    query rows), ``dk`` and ``dv`` (the visiting block's rows). ``lse``
    (B, H, S) f32 is the rank's GLOBAL log-sum-exp with +inf mapped to 1e30
    (:func:`_lse_to_m`), so P = exp(s - lse) is the globally normalised
    probability and 0 on a row that sees no key; ``delta`` (B, H, S) is
    rowsum(dO * O). As the library backward: dS = P (dP - delta) * scale,
    then dQ = dS K and dK = dS^T Q. Mode 2 adds nothing."""
    if mode == SKIP:
        return
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _block_logits(q, k, kv_mask, causal=mode == DIAGONAL)
    p.sub_(lse[..., None]).exp_()
    dout32 = dout.float()
    dv.add_(torch.einsum("bhqk,bqhd->bkhd", p, dout32))
    ds = torch.einsum("bqhd,bkhd->bhqk", dout32, v.float())
    ds.sub_(delta[..., None]).mul_(p).mul_(scale)
    del p
    dq.add_(torch.einsum("bhqk,bkhd->bqhd", ds, k.float()))
    dk.add_(torch.einsum("bhqk,bqhd->bkhd", ds, q.float()))


def _merge(m, l, acc, o_j, l_j, m_j):
    """Fold a block's normalised output and stats into the running (m, l,
    acc), all f32 (JAX ``ring.py:131-140``)."""
    m_j = torch.where(l_j > 0, m_j, NEG_INF)  # rows with no valid key
    m_new = torch.maximum(m, m_j)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(torch.where(m_j > NEG_INF / 2, m_j - m_new, NEG_INF))
    l_new = l * alpha + l_j * beta
    acc_new = (acc * alpha.transpose(1, 2)[..., None]
               + o_j.float() * (l_j * beta).transpose(1, 2)[..., None])
    return m_new, l_new, acc_new


def _lse_to_m(lse):
    """Rows with no valid key have lse = +inf; a large finite value keeps
    exp(s - lse) = 0 without NaNs (JAX ``ring.py:310-314``)."""
    return torch.where(torch.isfinite(lse), lse, 1e30).contiguous()


def _block_mode(rank: int, kv_idx: int, causal: bool) -> int:
    if not causal:
        return FULL
    return DIAGONAL if kv_idx == rank else (FULL if kv_idx < rank else SKIP)


# ------------------------------------------------------------- communicators
class LoopbackRing:
    """All ``n`` ranks of a ring in one process: ranks ``0 .. n-1`` are held
    here, a hop rotates the per-rank lists (rank r receives what rank r - 1
    held) and moves nothing."""

    def __init__(self, n: int):
        if int(n) < 1:
            raise ValueError(f"a ring needs at least one rank, got {n}")
        self.size = int(n)
        self.ranks = tuple(range(self.size))

    def start(self, per_rank):
        return per_rank[-1:] + per_rank[:-1]

    def wait(self, handle):
        return handle


class ProcessGroupRing:
    """This process's rank of an sp process group (None: the default
    group). A hop sends each tensor to rank + 1 and receives its
    counterpart from rank - 1 of the group in one ``batch_isend_irecv``."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        rank = dist.get_rank(group)
        self.ranks = (rank,)
        g = dist.group.WORLD if group is None else group
        self._next = dist.get_global_rank(g, (rank + 1) % self.size)
        self._prev = dist.get_global_rank(g, (rank - 1) % self.size)

    def start(self, per_rank):
        (tensors,) = per_rank
        received = [torch.empty_like(t) for t in tensors]
        ops = ([dist.P2POp(dist.isend, t, self._next, group=self.group) for t in tensors]
               + [dist.P2POp(dist.irecv, r, self._prev, group=self.group) for r in received])
        return dist.batch_isend_irecv(ops), [received]

    def wait(self, handle):
        requests, received = handle
        for req in requests:
            req.wait()
        return received


# ----------------------------------------------------------------- ring loop
def _travelling(ks, vs, masks):
    """Per held rank, the tensors that hop with a KV block."""
    if masks is None:
        return [[k, v] for k, v in zip(ks, vs)]
    return [[k, v, mk] for k, v, mk in zip(ks, vs, masks)]


def _ring_forward(comm, qs, ks, vs, masks, causal, block_impl, kernels):
    """Forward ring over the held ranks; returns (outs, lses)."""
    n = comm.size
    B, s_loc, H, D = qs[0].shape
    dev = qs[0].device
    ms = [torch.full((B, H, s_loc), NEG_INF, dtype=torch.float32, device=dev) for _ in qs]
    ls = [torch.zeros((B, H, s_loc), dtype=torch.float32, device=dev) for _ in qs]
    accs = [torch.zeros((B, s_loc, H, D), dtype=torch.float32, device=dev) for _ in qs]
    cur = _travelling(ks, vs, masks)
    for step in range(n):
        hop = comm.start(cur) if step < n - 1 else None
        for i, rank in enumerate(comm.ranks):
            kv_idx = (rank - step) % n
            k_cur, v_cur, *mask_cur = cur[i]
            mask_cur = mask_cur[0] if mask_cur else None
            if block_impl == "dense":
                pos_q = rank * s_loc + torch.arange(s_loc, device=dev)
                pos_k = kv_idx * s_loc + torch.arange(s_loc, device=dev)
                ms[i], ls[i], accs[i] = _dense_block_fwd(qs[i], k_cur, v_cur, mask_cur, pos_q,
                                                         pos_k, ms[i], ls[i], accs[i], causal)
                continue
            mode = _block_mode(rank, kv_idx, causal)
            if mode == SKIP:
                continue
            o_j, l_j, m_j = dispatch("ring_block_fwd", qs[i], k_cur, v_cur, mask_cur, mode,
                                     kernels=kernels)
            ms[i], ls[i], accs[i] = _merge(ms[i], ls[i], accs[i], o_j, l_j, m_j)
        if hop is not None:
            cur = comm.wait(hop)
    outs, lses = [], []
    for q, m, l, acc in zip(qs, ms, ls, accs):
        l_safe = torch.where(l > 0, l, 1.0)
        outs.append((acc / l_safe.transpose(1, 2)[..., None]).to(q.dtype))
        lses.append(torch.where(l > 0, m + torch.log(l_safe), torch.inf))
    return outs, lses


def _ring_backward(comm, qs, ks, vs, masks, outs, lses, douts, causal, block_impl, kernels):
    """Backward ring over the held ranks; returns (dqs, dks, dvs)."""
    n = comm.size
    B, s_loc, H, D = qs[0].shape
    dev = qs[0].device
    deltas = [(o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()
              for o, do in zip(outs, douts)]
    if block_impl == "flash":
        lses = [_lse_to_m(lse) for lse in lses]

    def zeros():
        return torch.zeros((B, s_loc, H, D), dtype=torch.float32, device=dev)

    dqs = [zeros() for _ in qs]
    grads = [[zeros(), zeros()] for _ in qs]  # dk, dv of the block each rank holds
    cur = _travelling(ks, vs, masks)
    for step in range(n):
        hop = comm.start(cur) if step < n - 1 else None
        for i, rank in enumerate(comm.ranks):
            kv_idx = (rank - step) % n
            k_cur, v_cur, *mask_cur = cur[i]
            mask_cur = mask_cur[0] if mask_cur else None
            dk_cur, dv_cur = grads[i]
            if block_impl == "dense":
                pos_q = rank * s_loc + torch.arange(s_loc, device=dev)
                pos_k = kv_idx * s_loc + torch.arange(s_loc, device=dev)
                dq_j, dk_j, dv_j = _dense_block_bwd(qs[i], k_cur, v_cur, mask_cur, pos_q,
                                                    pos_k, lses[i], douts[i], deltas[i], causal)
                dqs[i].add_(dq_j)
                dk_cur.add_(dk_j)
                dv_cur.add_(dv_j)
                continue
            mode = _block_mode(rank, kv_idx, causal)
            if mode != SKIP:
                dispatch("ring_block_bwd", qs[i], k_cur, v_cur, mask_cur, mode, lses[i],
                         douts[i], deltas[i], dqs[i], dk_cur, dv_cur, kernels=kernels)
        if hop is not None:
            cur = comm.wait(hop)
        # The accumulators travel with their block, after its compute: n
        # hops bring each home.
        grads = comm.wait(comm.start(grads))
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [g[0].to(k.dtype) for g, k in zip(grads, ks)],
            [g[1].to(v.dtype) for g, v in zip(grads, vs)])


class _RingAttention(torch.autograd.Function):
    """The whole ring, forward and backward, over the ranks ``comm`` holds.
    Tensor arguments: the held ranks' q shards, then k, v, and (when
    ``has_mask``) the masks."""

    @staticmethod
    def forward(ctx, comm, causal, block_impl, kernels, has_mask, *tensors):
        n = len(comm.ranks)
        qs, ks, vs = tensors[:n], tensors[n:2 * n], tensors[2 * n:3 * n]
        masks = tensors[3 * n:] if has_mask else None
        outs, lses = _ring_forward(comm, qs, ks, vs, masks, causal, block_impl, kernels)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.comm, ctx.causal, ctx.block_impl, ctx.kernels = comm, causal, block_impl, kernels
        ctx.masks = masks
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        n = len(ctx.comm.ranks)
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        douts = [do.contiguous() for do in douts]
        dqs, dks, dvs = _ring_backward(ctx.comm, qs, ks, vs, ctx.masks, outs, lses, douts,
                                       ctx.causal, ctx.block_impl, ctx.kernels)
        n_masks = 0 if ctx.masks is None else n
        return (None,) * 5 + (*dqs, *dks, *dvs) + (None,) * n_masks


# --------------------------------------------------------------------- entry
def ring_attention(q, k, v, *, causal=True, mask=None, group=None, block_impl: str = "flash",
                   kernels=None):
    """Sequence-parallel attention over the ring ``group``.

    - ``group`` a process group, or None for the default group: q, k, v are
      this rank's (B, S/sp, H, D) shards and ``mask`` its (B, S/sp) shard
      (1 = real token); returns this rank's output shard. Without an
      initialised process group, or with a group of one rank, this is dense
      attention on the whole sequence.
    - ``group`` a :class:`LoopbackRing` of n ranks: q, k, v (and ``mask``)
      are sequences of the n shards in rank order; returns the list of n
      output shards.

    ``block_impl``: ``"flash"`` (the registry ops, kernels for CUDA
    tensors) or ``"dense"``. ``kernels``: the registry spec of the flash
    blocks (``"off"`` runs the plain twins)."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}, got {block_impl!r}")
    if isinstance(group, LoopbackRing):
        comm = group
        qs, ks, vs = list(q), list(k), list(v)
        masks = None if mask is None else list(mask)
        for name, shards in (("q", qs), ("k", ks), ("v", vs), ("mask", masks)):
            if shards is not None and len(shards) != comm.size:
                raise ValueError(f"LoopbackRing({comm.size}) takes {comm.size} {name} "
                                 f"shards, got {len(shards)}")
    else:
        if not dist.is_initialized() or dist.get_world_size(group) == 1:
            return dense_attention(q, k, v, causal=causal, mask=mask)
        comm = ProcessGroupRing(group)
        qs, ks, vs = [q], [k], [v]
        masks = None if mask is None else [mask]
    if masks is not None:  # int32 travels over every backend (gloo has no bool)
        masks = [mk.to(torch.int32).contiguous() for mk in masks]
    qs, ks, vs = ([t.contiguous() for t in ts] for ts in (qs, ks, vs))
    outs = _RingAttention.apply(comm, bool(causal), block_impl, kernels, masks is not None,
                                *qs, *ks, *vs, *(masks or ()))
    return list(outs) if isinstance(group, LoopbackRing) else outs[0]


# One visiting KV block of the ring, forward: (o, l, m).
register_op("ring_block_fwd", ring_block_fwd_reference, ring_block_fwd_cuda)
# One visiting KV block, backward: dq, dk, dv added into f32 accumulators.
register_op("ring_block_bwd", ring_block_bwd_reference, ring_block_bwd_cuda)
