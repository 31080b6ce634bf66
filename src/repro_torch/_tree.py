"""Pytrees of nested dicts, walked in JAX's order.

``jax.tree`` flattens a dict in sorted key order; these helpers do the
same, so leaf ``i`` of a port pytree is leaf ``i`` of the reference's
(bucket plans, collective ledgers and checkpoints line up leaf for
leaf). Anything that is not a dict is a leaf.
"""
from __future__ import annotations

from typing import Callable, Iterator, List


def tree_leaves(tree) -> List:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves):
    """The structure of ``template`` with ``leaves`` in its leaf order."""
    it = iter(leaves)
    out = _fill(template, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _fill(template, it: Iterator):
    if isinstance(template, dict):
        filled = {k: _fill(template[k], it) for k in sorted(template)}
        return {k: filled[k] for k in template}
    return next(it)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure)."""
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*args) for args in zip(
        tree_leaves(tree), *others)])
