"""Sharding planners — the counterpart of ``accelerate_tpu/parallel/sharding.py``.

The JAX package maps every parameter to a ``PartitionSpec`` over its mesh
and lets GSPMD insert the collectives. The port keeps the planners as pure
functions of shapes and axis sizes: each returns, per leaf, a **spec**, a
tuple with one entry per leading dim (missing trailing entries mean
``None``), each entry ``None`` (that dim whole), an axis name, or a tuple of
axis names (that dim split over their product, the first axis major), as
``tuple(PartitionSpec(...))`` reads. ``sizes`` maps axis names to their
sizes; an axis it does not name has size 1. The rules are the JAX package's
``(path_regex, spec)`` pairs, matched against ``a/b/c`` leaf paths. They
choose the same dim and the same axes as the JAX planners, leaf by leaf:

- :func:`plan_param_shardings`: the first matching rule (relaxed when it
  does not divide), else the largest dim divisible by the ``fsdp`` axis for
  leaves of at least ``min_shard_size`` elements, else replicated (``()``);
- :func:`plan_zero_shardings`: each base spec further split along ``dp``
  (ZeRO), on the largest free dim that divides, else appended to a dim
  already split whose size still divides;
- :func:`local_leaf_shape`, :func:`data_parallel_degree` and
  :func:`local_batch_size_for`.

``parallel/fsdp.py`` turns these specs into each rank's contiguous shards.
"""

from __future__ import annotations

import logging
import re

import numpy as np

logger = logging.getLogger(__name__)

# The mesh axes a batch's rows split over (JAX utils/constants.py:178); the
# port has no dcn axis, so it has size 1.
BATCH_SHARDING_AXES = ("dcn", "dp", "fsdp")


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def padded_spec(spec, ndim: int) -> tuple:
    """``spec`` with ``None`` entries up to ``ndim``."""
    spec = tuple(spec or ())
    return spec + (None,) * (ndim - len(spec))


def axes_size(sizes: dict, axes) -> int:
    """The product of the sizes of ``axes`` (one entry: None, a name, or a
    tuple of names)."""
    size = 1
    for a in entry_axes(axes):
        size *= int(sizes.get(a, 1))
    return size


def _spec_fits(shape, spec, sizes) -> bool:
    for dim, axes in zip(shape, padded_spec(spec, len(shape))):
        size = axes_size(sizes, axes)
        if size > 1 and dim % size != 0:
            return False
    return True


def _relax_spec(shape, spec, sizes) -> tuple:
    """Drop only the axes that do not divide their dim; per dim, axes are
    kept greedily left to right while their product still divides."""
    relaxed = []
    for dim, axes in zip(shape, padded_spec(spec, len(shape))):
        if axes is None:
            relaxed.append(None)
            continue
        kept, prod = [], 1
        for ax in entry_axes(axes):
            size = int(sizes.get(ax, 1))
            if dim % (prod * size) == 0:
                kept.append(ax)
                prod *= size
        relaxed.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(relaxed)


def _walk(tree, prefix=""):
    """``[(path, leaf)]`` of a nested dict in sorted-key order, the path's
    keys joined by ``/`` (the JAX package's ``path_str``)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(_walk(tree[key], f"{prefix}/{key}" if prefix else str(key)))
        return out
    return [(prefix, tree)]


def _rebuild(like, values):
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(like)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(np.shape(leaf))


def _match_rule(compiled, name, shape, sizes, kind):
    """The spec of the first rule matching ``name`` (relaxed if it does not
    divide), or None when none matches or the match keeps no axis."""
    for pat, spec in compiled:
        if pat.search(name):
            spec = tuple(spec)
            if _spec_fits(shape, spec, sizes):
                return spec
            relaxed = _relax_spec(shape, spec, sizes)
            if any(ax is not None for ax in relaxed):
                logger.warning("%s rule %s -> %s does not divide %s%s; relaxed to %s", kind,
                               pat.pattern, spec, name, shape, relaxed)
                return relaxed
            logger.warning("%s rule %s -> %s does not divide %s%s; using the auto plan", kind,
                           pat.pattern, spec, name, shape)
            return None
    return None


def plan_param_shardings(params, sizes: dict, rules=None, min_shard_size: int = 2**14,
                         fsdp_axis: str = "fsdp"):
    """A spec per parameter (a tree like ``params``; JAX ``sharding.py:
    199-253``): the first matching rule, else the largest dim divisible by
    the fsdp axis for a leaf of at least ``min_shard_size`` elements (ties:
    the first such dim), else ``()`` (replicated)."""
    fsdp_size = int(sizes.get(fsdp_axis, 1))
    compiled = [(re.compile(pat), spec) for pat, spec in (rules or [])]

    def plan_one(name, leaf):
        shape = _shape(leaf)
        spec = _match_rule(compiled, name, shape, sizes, "sharding")
        if spec is not None:
            return spec
        if fsdp_size > 1 and int(np.prod(shape, dtype=np.int64)) >= min_shard_size:
            for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
                if shape[d] % fsdp_size == 0:
                    spec = [None] * len(shape)
                    spec[d] = fsdp_axis
                    return tuple(spec)
        return ()

    return _rebuild(params, [plan_one(n, leaf) for n, leaf in _walk(params)])


def _extend_spec_with_axis(shape, spec, sizes, axis: str):
    """``spec`` further split along ``axis`` (JAX ``sharding.py:261-295``):
    the largest free dim divisible by its size, else an already split dim
    whose size divides the combined degree (``axis`` appended, minor); None
    when no dim can take it or ``spec`` names it already."""
    size = int(sizes.get(axis, 1))
    if size <= 1 or not shape:
        return None
    entries = list(padded_spec(spec, len(shape)))
    if any(axis in entry_axes(e) for e in entries):
        return None
    free = [d for d, e in enumerate(entries) if e is None and shape[d] % size == 0]
    if free:
        d = max(free, key=lambda d: shape[d])
        entries[d] = axis
        return tuple(entries)
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        e = entries[d]
        if e is None:
            continue
        if shape[d] % (axes_size(sizes, e) * size) == 0:
            entries[d] = entry_axes(e) + (axis,)
            return tuple(entries)
    return None


def plan_zero_shardings(params, param_specs, sizes: dict, rules=None, axis: str = "dp",
                        min_shard_size: int = 2**10):
    """ZeRO specs (JAX ``sharding.py:298-355``): each leaf's base spec
    further split along ``axis`` for the optimizer state and the update;
    ``param_specs`` unchanged when ``axis`` has size 1. Per leaf: scalars
    keep their base; the first matching rule; leaves under
    ``min_shard_size`` keep their base; else :func:`_extend_spec_with_axis`
    (or the base when it finds no dim)."""
    if int(sizes.get(axis, 1)) <= 1:
        return param_specs
    compiled = [(re.compile(pat), spec) for pat, spec in (rules or [])]
    bases = [s for _, s in _walk(param_specs)] if isinstance(param_specs, dict) \
        else [param_specs]

    def plan_one(name, leaf, base):
        shape = _shape(leaf)
        if not shape:
            return base
        spec = _match_rule(compiled, name, shape, sizes, "zero sharding")
        if spec is not None:
            return spec
        if int(np.prod(shape, dtype=np.int64)) < min_shard_size:
            return base
        extended = _extend_spec_with_axis(shape, base, sizes, axis)
        return base if extended is None else extended

    walked = _walk(params)
    return _rebuild(params, [plan_one(n, leaf, b) for (n, leaf), b in zip(walked, bases)])


def local_leaf_shape(shape, spec, sizes: dict) -> tuple:
    """A rank's shape of a leaf under ``spec``: each dim divided by the
    product of its axes' sizes, rounded up (JAX ``sharding.py:387-407``)."""
    shape = tuple(int(d) for d in shape)
    if not spec:
        return shape
    return tuple(-(-d // axes_size(sizes, e)) for d, e in zip(shape, padded_spec(spec, len(shape))))


def data_parallel_degree(sizes: dict) -> int:
    """How many ways a batch's rows split: the product of the batch axes."""
    return axes_size(sizes, BATCH_SHARDING_AXES)


def local_batch_size_for(global_batch_size: int, sizes: dict) -> int:
    """The rows each rank feeds a step: the global batch over the
    data-parallel degree, which must divide it. (The JAX package feeds each
    host process its share of the global batch; the port's ranks are
    processes, one a device.)"""
    n_data = data_parallel_degree(sizes)
    if global_batch_size % n_data != 0:
        raise ValueError(f"global batch size {global_batch_size} not divisible by "
                         f"data-parallel degree {n_data}")
    return global_batch_size // n_data


def spec_axes(spec) -> set:
    """Every axis name a spec mentions."""
    return {a for e in tuple(spec or ()) for a in entry_axes(e)}
