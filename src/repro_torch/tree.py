"""Nested dicts and lists of tensors: the port's pytrees.

The reference maps, flattens and keys its state with ``jax.tree``; the
port's params, optimizer state and batches are plain dicts (and the
layer list), walked here in insertion order. Only dicts and lists are
nodes: a tuple is a leaf (``tree_map`` may return tuples per leaf). A
path joins dict keys and list indices (``layers/3/mixer/wq`` with
``sep="/"``).
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def items(tree, sep: str = "/", path: tuple = ()) -> list:
    """(path joined by ``sep``, leaf) for every leaf, in order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in items(v, sep, path + (str(k),))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in items(v, sep, path + (str(i),))]
    return [(sep.join(path), tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def unflatten(like, values):
    """A tree shaped like ``like`` whose leaves are ``values`` in order."""
    it = iter(values)
    return tree_map(lambda _: next(it), like)
