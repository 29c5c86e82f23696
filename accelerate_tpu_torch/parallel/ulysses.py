"""Ulysses sequence parallelism — the counterpart of
``accelerate_tpu/parallel/ulysses.py``.

The second sequence-parallel route beside ring attention
(``parallel/ring.py``): two all-to-alls over the ``sp`` group re-shard the
activations around the attention op.

- In: q, k and v go from sequence-sharded ``(B, S/sp, H, D)`` to
  head-sharded ``(B, S, H/sp, D)``: every rank then holds the whole
  sequence for its ``H/sp`` heads (``H`` is a tp rank's heads), and the
  mask is all-gathered over sp.
- The attention op in the middle is the port's own
  (``ops/attention.attention`` with ``impl="auto"``; the JAX package calls
  ``dense_attention`` there), so bf16 or fp16 at a flash shape runs the
  flash kernel on the full sequence: the same function, under flash's pins.
- Out: the mirror all-to-all restores the sequence sharding.

Each all-to-all moves ``(sp - 1) / sp`` of a rank's tensor. Ulysses needs
the heads of a rank to divide by sp; otherwise it raises the JAX package's
``ValueError``.

Two forms, as the ring has: a process group (``dist.all_to_all_single`` on
contiguous buffers, ``utils/operations.all_to_all_along``, inside a
``torch.autograd.Function`` whose backward is the reverse all-to-all), and
:class:`LoopbackUlysses`, all n ranks in one process, where an all-to-all
re-slices the per-rank lists and moves nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.operations import all_gather_along, all_to_all_along


class LoopbackUlysses:
    """All ``n`` ranks of an sp group in one process (module docstring)."""

    def __init__(self, n: int):
        if int(n) < 1:
            raise ValueError(f"an sp group needs at least one rank, got {n}")
        self.size = int(n)
        self.ranks = tuple(range(self.size))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return all_to_all_along(x.contiguous(), split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return all_to_all_along(grad.contiguous(), concat_dim, split_dim, ctx.group), None, None, None


def check_heads(heads: int, sp: int, tp: int = 1, global_heads: int | None = None):
    """JAX's refusal: a tp rank's ``heads`` must divide by sp (the message
    names the model's ``global_heads`` over ``tp``, as JAX's does)."""
    if heads % sp != 0:
        total = heads * tp if global_heads is None else global_heads
        raise ValueError(
            f"Ulysses needs heads divisible by sp: {total} heads / tp={tp} across sp={sp}. "
            "Use ring attention (SequenceParallelPlugin(ring_attention=True)) instead.")


def _loopback_in(shards, n):
    """Per rank j: head chunk j of every rank's shard, the shards in rank
    order along the sequence."""
    h = shards[0].shape[2] // n
    return [torch.cat([s[:, :, j * h:(j + 1) * h] for s in shards], dim=1) for j in range(n)]


def _loopback_out(outs, n):
    """Per rank i: sequence chunk i of every rank's output, heads in rank
    order."""
    s_loc = outs[0].shape[1] // n
    return [torch.cat([o[:, i * s_loc:(i + 1) * s_loc] for o in outs], dim=2) for i in range(n)]


def ulysses_attention(q, k, v, *, causal=True, mask=None, group=None, kernels=None):
    """Sequence-parallel exact attention by the head-sequence all-to-all.

    - ``group`` a process group, or None for the default group: q, k, v are
      this rank's ``(B, S/sp, H, D)`` shards (k and v with q's heads) and
      ``mask`` its ``(B, S/sp)`` shard (1 = real token); returns this
      rank's output shard. Without an initialised process group, or with
      a group of one rank, this is ``attention`` on the whole sequence.
    - ``group`` a :class:`LoopbackUlysses` of n ranks: q, k, v (and
      ``mask``) are sequences of the n shards in rank order; returns the
      list of n output shards.

    ``kernels``: the registry spec of the attention op."""
    from ..ops.attention import attention

    def inner(q, k, v, mask):
        return attention(q, k, v, causal=causal, mask=mask, impl="auto", kernels=kernels)

    if isinstance(group, LoopbackUlysses):
        n = group.size
        qs, ks, vs = list(q), list(k), list(v)
        if any(len(t) != n for t in (qs, ks, vs)):
            raise ValueError(f"LoopbackUlysses({n}) takes {n} shards of q, k and v")
        check_heads(qs[0].shape[2], n)
        full_mask = None if mask is None else torch.cat(list(mask), dim=1)
        heads_q, heads_k, heads_v = (_loopback_in(t, n) for t in (qs, ks, vs))
        outs = [inner(a, b, c, full_mask) for a, b, c in zip(heads_q, heads_k, heads_v)]
        return _loopback_out(outs, n)
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return inner(q, k, v, mask)
    n = dist.get_world_size(group)
    check_heads(q.shape[2], n)
    q, k, v = (_AllToAll.apply(t, 2, 1, group) for t in (q, k, v))
    if mask is not None:
        mask = all_gather_along(mask.to(torch.int32).contiguous(), 1, group)
    out = inner(q, k, v, mask)
    return _AllToAll.apply(out, 1, 2, group)
