"""Nested-dict parameter trees — the port's stand-in for ``jax.tree_util``.

Parameters, gradients and optimizer moments are nested dicts of tensors, as
the JAX package's pytrees are. Leaves are walked in **sorted key order**,
as ``jax.tree_util`` walks a dict, so that a reduction across leaves (the
global gradient norm) adds its terms in the JAX package's order.
"""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """Leaves of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are ``leaves`` (in the order
    :func:`tree_leaves` gives)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` applied leafwise across trees of one structure."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or set(other) != set(tree):
                raise ValueError(f"tree structures differ: {sorted(tree)} vs "
                                 f"{sorted(other) if isinstance(other, dict) else other!r}")
        return {key: tree_map(fn, tree[key], *(o[key] for o in rest)) for key in sorted(tree)}
    return fn(tree, *rest)


def _children(node):
    """``(key, child)`` pairs of a container in ``jax.tree_util``'s order:
    a dict by sorted key, a named tuple by field name, a tuple or list by
    index; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree, prefix: str = "") -> list:
    """``[(path, leaf), ...]`` over dicts, tuples, lists and named tuples,
    the path's keys joined by dots: the JAX package's checkpoint keys
    (``path_str(path).replace("/", ".")``), such as ``layers.wq`` or, in an
    optimizer state, ``0.mu.layers.wq`` and ``0.count``. A container with
    no leaves (an empty named tuple) contributes nothing."""
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    out = []
    for key, child in children:
        out.extend(flatten_with_paths(child, f"{prefix}.{key}" if prefix else key))
    return out


def map_with_paths(fn, tree, prefix: str = ""):
    """The tree with each leaf replaced by ``fn(path, leaf)`` (paths as
    :func:`flatten_with_paths` names them); containers keep their types."""
    children = _children(tree)
    if children is None:
        return fn(prefix, tree)
    mapped = [map_with_paths(fn, child, f"{prefix}.{key}" if prefix else key)
              for key, child in children]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), mapped))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*mapped)
    return type(tree)(mapped)
