"""Tensor parallelism: Megatron's conjugate collectives over the ``tp`` axis.

The JAX package has no counterpart module: it lays the Megatron rules of
``models/llama.py:412-430`` on the ``tp`` mesh axis and GSPMD inserts the
collectives. The port runs one process per rank, so the model calls them
itself, at the boundaries between **replicated** values (a plain tensor,
the same on every tp rank: the residual stream, the norms, the loss) and
**per-rank** values (a list with one tensor per tp rank this process holds:
a rank's heads, its MLP columns, its vocab rows):

- :meth:`copy` (Megatron's ``f``): replicated to per-rank; identity
  forward, gradients summed over the tp ranks backward. Every replicated
  tensor that per-rank work reads goes through it, weights included, so
  its gradient is whole on every rank;
- :meth:`reduce` (Megatron's ``g``): per-rank partial sums to replicated;
  summed forward, identity backward (after a row-parallel product: wo,
  w_down, the vocab-parallel embedding, the loss's statistics);
- :meth:`gather`: per-rank slices to replicated, concatenated along a dim;
  each rank keeps its own slice of the gradient backward (the KV
  projection of a rank split in the middle of a head, the logits of an
  eval forward);
- :meth:`max`: the elementwise maximum over the tp ranks, outside autograd
  (the loss's row maximum).

Two implementations, as ``parallel/ring.py`` has:

- :class:`ProcessGroupTP`: this process's rank of a tp process group; a
  per-rank value is a list of one tensor, and the ops are
  ``torch.autograd.Function`` s over ``torch.distributed``;
- :class:`LoopbackTP`: all n ranks in one process (one card driving the
  kernels as n cards would, ``chip_smoke.py`` phase 15); a per-rank value
  is a list of n tensors. A replicated tensor is held once, :meth:`copy`
  hands the same tensor to every rank (autograd sums the ranks'
  gradients into it), :meth:`reduce` adds the ranks' partials in rank
  order and :meth:`gather` concatenates them: the ranks advance in lockstep
  through each layer by construction.

The same two classes carry expert parallelism (``ops/moe.py``): over the
**expert group**, the ep ranks, the tp ranks, or under ep x tp the joint
group of one data coordinate's ep and tp ranks (ep major, so ``minor`` is
the tp size and a rank's index in the group is ``ep_index * tp +
tp_index``). The routing is replicated over the group; each rank's experts
read the layer's input and the gates through :meth:`copy`, so their
gradients sum over the ranks while the router loss's stays counted once,
and the ranks' partial combines meet in :meth:`reduce`: the one all-reduce
a layer that GSPMD inserts for the JAX package (``ops/moe.py:12-17``).
:meth:`expert_index` names the ep rank of a held piece.

:func:`vocab_parallel_embedding` is the lookup in a table whose rows (the
vocab) are split over tp. ``ops/losses.py`` holds the vocab-parallel
cross-entropies.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..utils.operations import all_gather_along


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim % x.dim(), group
        ctx.size = x.shape[ctx.dim]
        return all_gather_along(x, ctx.dim, group)

    @staticmethod
    def backward(ctx, grad):
        index = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, index * ctx.size, ctx.size).contiguous(), None, None


class ProcessGroupTP:
    """This process's rank of the tp process group ``group`` (or of an
    expert group, ``minor`` its tp size; module docstring)."""

    def __init__(self, group, minor: int = 1):
        self.group = group
        self.size = dist.get_world_size(group)
        self.indices = (dist.get_rank(group),)
        self.minor = int(minor)

    def expert_index(self, piece: int) -> int:
        """The ep index of held piece ``piece``."""
        return self.indices[piece] // self.minor

    def copy(self, x):
        return [_CopyToTP.apply(x, self.group)]

    def reduce(self, parts):
        (part,) = parts
        return _ReduceFromTP.apply(part, self.group)

    def gather(self, parts, dim: int):
        (part,) = parts
        return _GatherFromTP.apply(part, dim, self.group)

    def max(self, parts):
        (part,) = parts
        out = part.detach().contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out


class LoopbackTP:
    """All ``n`` tp ranks (or expert-group ranks, ``minor`` the tp size) in
    one process (module docstring)."""

    def __init__(self, n: int, minor: int = 1):
        if int(n) < 1:
            raise ValueError(f"a tp group needs at least one rank, got {n}")
        self.size = int(n)
        self.indices = tuple(range(self.size))
        self.minor = int(minor)

    def expert_index(self, piece: int) -> int:
        return self.indices[piece] // self.minor

    def _check(self, parts):
        if len(parts) != self.size:
            raise ValueError(f"LoopbackTP({self.size}) takes {self.size} per-rank tensors, "
                             f"got {len(parts)}")

    def copy(self, x):
        return [x] * self.size

    def reduce(self, parts):
        self._check(parts)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def gather(self, parts, dim: int):
        self._check(parts)
        return torch.cat(list(parts), dim)

    def max(self, parts):
        self._check(parts)
        out = parts[0].detach()
        for p in parts[1:]:
            out = torch.maximum(out, p.detach())
        return out


def vocab_parallel_embedding(tp, tables, ids):
    """``table[ids]`` for a table whose rows are split over tp: ``tables``
    holds each held rank's ``(V / tp, h)`` rows (rank t owns
    ``[t·V/tp, (t+1)·V/tp)``); a rank looks up the ids it owns, zeros
    elsewhere, and :meth:`reduce` sums the ranks. Returns the replicated
    ``(..., h)`` embedding."""
    ids = ids.long()
    parts = []
    for t, table in zip(tp.indices, tables):
        n = table.shape[0]
        local = ids - t * n
        inside = (local >= 0) & (local < n)
        e = F.embedding(torch.where(inside, local, torch.zeros_like(local)), table)
        parts.append(torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype,
                                                                   device=e.device)))
    return tp.reduce(parts)
