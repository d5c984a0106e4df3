"""Parameter trees as nested dicts (the port's stand-in for ``jax.tree_util``).

A tree is a dict whose values are trees or leaves. Traversal visits dict keys
in sorted order, as ``jax.tree_util`` flattens dicts, so a flat list of
leaves (and any sum over it) comes out in the JAX package's order. A leaf's
path is its keys joined by ``/`` (``"enc/w"``), the names the projection
spec's regex matches.
"""

from __future__ import annotations

from typing import Callable, List, Tuple


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """``[(path, leaf), ...]`` in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def leaves_up_to(structure, tree) -> list:
    """``tree``'s nodes at the leaf positions of ``structure``, in
    sorted-key order (``jax.tree_util``'s ``flatten_up_to``): a node where
    ``structure`` has a leaf may itself be a tree, as an int8 moment's
    ``{"q", "s"}`` is where the parameter tree has a tensor."""
    if isinstance(structure, dict):
        out = []
        for k in sorted(structure):
            out += leaves_up_to(structure[k], tree[k])
        return out
    return [tree]


def map_with_path(fn: Callable, tree, prefix: str = ""):
    """The tree with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def tree_map(fn: Callable, tree, *rest):
    """The tree with each leaf replaced by ``fn(leaf, *matching leaves of
    rest)``; every tree in ``rest`` has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten_like(tree, flat: list):
    """A tree of ``tree``'s structure whose leaves, in sorted-key order, are
    ``flat``."""
    return _fill(tree, iter(flat))


def unstack(stack) -> list:
    """The per-layer trees of a stacked tree (every leaf's leading axis),
    each leaf unbound once: the backward stacks the layers' gradients in
    one pass."""
    per = [a.unbind(0) for a in leaves(stack)]
    n = len(per[0]) if per else 0
    return [unflatten_like(stack, [u[i] for u in per]) for i in range(n)]


def _fill(node, it):
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, which would keep ``flat`` (a model's per-layer views
    # of its weights) alive until the next garbage collection
    if isinstance(node, dict):
        return {k: _fill(node[k], it) for k in sorted(node)}
    return next(it)
