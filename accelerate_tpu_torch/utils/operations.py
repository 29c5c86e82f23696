"""Collectives the training step needs — the counterpart of the parts of
``accelerate_tpu/utils/operations.py`` that the port runs: ``reduce`` (the
loss's token count, the loss and the gradients, summed over the mesh) and
``broadcast`` (rank 0's parameters at ``prepare``).

Each takes a tensor on this rank's device and a process group (None: the
default group). Without an initialised process group they act as on a job
of one rank: the tensor comes back as it is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

REDUCTIONS = ("sum", "mean")


def _single(group) -> bool:
    return not dist.is_initialized() or dist.get_world_size(group) == 1


def reduce(tensor: torch.Tensor, reduction: str = "sum", group=None) -> torch.Tensor:
    """``tensor`` summed (or averaged) over the group's ranks, in place;
    returns it."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"reduction must be one of {REDUCTIONS}, got {reduction!r}")
    if _single(group):
        return tensor
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    if reduction == "mean":
        tensor.div_(dist.get_world_size(group))
    return tensor


def broadcast(tensor: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``tensor`` of the group's rank ``src`` on every rank, in place;
    returns it."""
    if _single(group):
        return tensor
    g = dist.group.WORLD if group is None else group
    dist.broadcast(tensor, src=dist.get_global_rank(g, src), group=group)
    return tensor
