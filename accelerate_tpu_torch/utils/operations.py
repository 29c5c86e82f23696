"""Collectives and nested-container helpers — the counterpart of
``accelerate_tpu/utils/operations.py``.

The JAX package moves global arrays; the port runs one process per rank, so
every collective here is a ``torch.distributed`` call over a process group
(None: the default group) on tensors of this rank's device. Without an
initialised process group, or in a group of one rank, they act as on a job of
one rank.

- :func:`reduce`: the JAX package's contract (``reduction`` in ``sum``,
  ``mean``, ``none``; default ``mean``; the result times ``scale``), in place;
- :func:`broadcast`: rank ``src``'s tensor on every rank, in place;
- :func:`gather`: every rank's tensor concatenated along dim 0 (all ranks'
  shapes must agree: :func:`pad_across_processes` first where they do not);
- :func:`gather_object` and :func:`broadcast_object_list`: picklable objects,
  over torch's object collectives;
- :func:`recursively_apply`, :func:`send_to_device`, :func:`find_batch_size`
  and :func:`concatenate` walk nested lists, tuples and dicts of tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

REDUCTIONS = ("sum", "mean", "none")


def _single(group) -> bool:
    return not dist.is_initialized() or dist.get_world_size(group) == 1


def _world(group) -> int:
    return 1 if not dist.is_initialized() else dist.get_world_size(group)


def is_tensor_like(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def recursively_apply(func: Callable, data: Any, *args, test_type: Callable = is_tensor_like,
                      error_on_other_type: bool = False, **kwargs):
    """``func`` applied to every tensor leaf of nested lists, tuples
    (namedtuples kept) and mappings; other leaves pass through unless
    ``error_on_other_type``."""
    if isinstance(data, (list, tuple)):
        out = [recursively_apply(func, o, *args, test_type=test_type,
                                 error_on_other_type=error_on_other_type, **kwargs) for o in data]
        if isinstance(data, tuple):
            return type(data)(*out) if hasattr(data, "_fields") else tuple(out)
        return out
    if isinstance(data, Mapping):
        return type(data)({k: recursively_apply(func, v, *args, test_type=test_type,
                                                error_on_other_type=error_on_other_type, **kwargs)
                           for k, v in data.items()})
    if test_type(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(f"Unsupported type {type(data)} passed — only nested containers of "
                        "tensors are supported.")
    return data


def send_to_device(data, device, non_blocking: bool = False, skip_keys=None):
    """Every tensor (or numpy array) leaf of ``data`` on ``device``; the
    values of ``skip_keys`` in mappings, at any depth, stay where they are.
    A numpy leaf becomes a tensor (``torch.as_tensor``) first."""
    if isinstance(skip_keys, str):
        skip_keys = [skip_keys]
    device = torch.device(device)

    def put(t):
        t = torch.as_tensor(t)
        if non_blocking and device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=non_blocking)

    if skip_keys:
        if isinstance(data, Mapping):
            return type(data)({k: v if k in skip_keys else
                               send_to_device(v, device, non_blocking, skip_keys)
                               for k, v in data.items()})
        if isinstance(data, (list, tuple)):
            out = [send_to_device(v, device, non_blocking, skip_keys) for v in data]
            if isinstance(data, tuple):
                return type(data)(*out) if hasattr(data, "_fields") else tuple(out)
            return out
    return recursively_apply(put, data)


def _leaves(data) -> list:
    if isinstance(data, (list, tuple)):
        return [leaf for o in data for leaf in _leaves(o)]
    if isinstance(data, Mapping):
        return [leaf for v in data.values() for leaf in _leaves(v)]
    return [data]


def find_batch_size(data) -> int:
    """The first dimension of the first tensor leaf."""
    leaves = [leaf for leaf in _leaves(data) if is_tensor_like(leaf)]
    if not leaves:
        raise ValueError(f"Cannot find batch size in {type(data)}")
    if leaves[0].ndim == 0:
        raise ValueError("0-d tensor has no batch dimension")
    return leaves[0].shape[0]


def concatenate(data, dim: int = 0):
    """A list of structurally identical containers concatenated leafwise."""
    first = data[0]
    if isinstance(first, (list, tuple)):
        return type(first)(concatenate([d[i] for d in data], dim=dim) for i in range(len(first)))
    if isinstance(first, Mapping):
        return type(first)({k: concatenate([d[k] for d in data], dim=dim) for k in first})
    return torch.cat([torch.as_tensor(d) for d in data], dim=dim)


def reduce(tensor, reduction: str = "mean", scale: float = 1.0, group=None):
    """Every tensor leaf summed (``"sum"``) or averaged (``"mean"``) over the
    group's ranks, then multiplied by ``scale`` — the JAX package's
    ``reduce`` (``accelerate_tpu/utils/operations.py:342``). ``"none"``
    returns ``tensor`` as it is, without ``scale``. Tensors are reduced in
    place and returned (the torch idiom of ``all_reduce``)."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"reduction must be one of {REDUCTIONS}, got {reduction!r}")
    if reduction == "none":
        return tensor

    def one(t):
        if not _single(group):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            if reduction == "mean":
                t.div_(_world(group))
        if scale != 1.0:
            t.mul_(scale)
        return t

    return recursively_apply(one, tensor, test_type=lambda x: isinstance(x, torch.Tensor))


def broadcast(tensor: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``tensor`` of the group's rank ``src`` on every rank, in place;
    returns it."""
    if _single(group):
        return tensor
    g = dist.group.WORLD if group is None else group
    dist.broadcast(tensor, src=dist.get_global_rank(g, src), group=group)
    return tensor


def gather(tensor, group=None):
    """Every tensor leaf all-gathered along dim 0 over the group's ranks, in
    rank order (shape ``(world * B, ...)``); unchanged on one rank. A 0-d
    tensor gathers into shape ``(world,)``."""

    def one(t):
        if _single(group):
            return t
        src = t.contiguous()
        if src.dim() == 0:
            src = src[None]
        parts = [torch.empty_like(src) for _ in range(_world(group))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts)

    return recursively_apply(one, tensor, test_type=lambda x: isinstance(x, torch.Tensor))


def gather_object(obj: Any, group=None) -> list:
    """Every rank's ``obj`` in a list in rank order; a list ``obj`` is
    flattened into it, as the JAX package does."""
    if _single(group):
        return list(obj) if isinstance(obj, list) else [obj]
    out = [None] * _world(group)
    dist.all_gather_object(out, obj, group=group)
    if isinstance(obj, list):
        return [item for part in out for item in part]
    return out


def broadcast_object_list(object_list: list, from_process: int = 0, group=None) -> list:
    """Every slot of ``object_list`` replaced by rank ``from_process``'s, in
    place; returns the list."""
    if _single(group):
        return object_list
    g = dist.group.WORLD if group is None else group
    dist.broadcast_object_list(object_list, src=dist.get_global_rank(g, from_process),
                               group=group)
    return object_list


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False,
                         group=None):
    """Every tensor leaf padded along ``dim`` with ``pad_index`` to the
    largest size any rank holds there, so that :func:`gather` is
    rectangular; at the front with ``pad_first``."""

    def one(t):
        if _single(group) or dim >= t.dim():
            return t
        size = torch.tensor(t.shape, dtype=torch.int64, device=t.device)
        sizes = gather(size[None], group=group)
        max_size = int(sizes[:, dim].max())
        if max_size == t.shape[dim]:
            return t
        shape = list(t.shape)
        shape[dim] = max_size
        out = t.new_full(shape, pad_index)
        index = [slice(None)] * t.dim()
        index[dim] = (slice(max_size - t.shape[dim], max_size) if pad_first
                      else slice(0, t.shape[dim]))
        out[tuple(index)] = t
        return out

    return recursively_apply(one, tensor, test_type=lambda x: isinstance(x, torch.Tensor))
