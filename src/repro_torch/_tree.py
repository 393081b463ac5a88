"""Nested containers of tensors (the port's counterpart of ``jax.tree``).

A tree is dicts, lists and tuples (NamedTuples included) around leaves.
Leaves are visited as ``jax.tree`` visits them: a dict's values in the
order of its sorted keys, a sequence's in order; ``None`` is a node with
no leaves.  Parameter trees, optimizer states and checkpoints all follow
this order, so a flat list of leaves lines up across the two packages.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


def flatten(tree: Any) -> tuple[list, Callable[[list], Any]]:
    """``(leaves, unflatten)``: ``unflatten(new_leaves)`` rebuilds a tree of
    the same structure (dicts with sorted keys, NamedTuples of their type)."""
    leaves: list = []

    def walk(node):
        if node is None:
            return lambda it: None
        if isinstance(node, dict):
            keys = sorted(node)
            subs = [walk(node[k]) for k in keys]
            return lambda it: {k: f(it) for k, f in zip(keys, subs)}
        if isinstance(node, (list, tuple)):
            subs = [walk(x) for x in node]
            if hasattr(node, "_fields"):
                kind = type(node)
                return lambda it: kind(*(f(it) for f in subs))
            kind = type(node)
            return lambda it: kind(f(it) for f in subs)
        leaves.append(node)
        return lambda it: next(it)

    build = walk(tree)

    def unflatten(new_leaves: list) -> Any:
        if len(new_leaves) != len(leaves):
            raise ValueError(f"{len(new_leaves)} leaves for a tree of {len(leaves)}")
        return build(iter(new_leaves))

    return leaves, unflatten


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat, unflatten = flatten(tree)
    others = [leaves(r) for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError("trees of different structure")
    return unflatten([fn(*xs) for xs in zip(flat, *others)])
