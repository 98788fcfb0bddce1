"""Parameter and state trees of the trainer: nested dicts, lists, tuples
and NamedTuples whose leaves are tensors (or arrays, or numbers).

Leaves are visited in the order ``jax.tree`` visits the same structure:
dict keys sorted, sequences in order, ``None`` holding no leaf.  So a tree
given to both packages flattens to the same list (the gradient compressor
and the checkpoint rely on it).
"""
from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["tree_leaves", "tree_map", "tree_unflatten"]


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # keep the caller's key order
        if isinstance(t, (list, tuple)):
            items = [build(v) for v in t]
            if isinstance(t, list):
                return items
            return type(t)(*items) if hasattr(t, "_fields") \
                else type(t)(items)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), in a tree of that structure."""
    cols = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError(f"trees of {[len(c) for c in cols]} leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])
