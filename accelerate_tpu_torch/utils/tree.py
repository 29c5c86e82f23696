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
