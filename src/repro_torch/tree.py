"""Parameter and optimizer-state trees: nested dicts and tuples of tensors.

Leaves are visited in the reference's (``jax.tree``) order: a dict's keys
sorted, a tuple's or list's entries in order, ``None`` an empty node. So
leaf ``i`` here is leaf ``i`` of the same tree in the reference, which the
checkpoint layout (``checkpoint/store.py``) relies on.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(node) -> Tuple[str, list]:
    """(kind, children) of an inner node; kind "" for a leaf."""
    if isinstance(node, dict):
        return "dict", [node[k] for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return type(node).__name__, list(node)
    if node is None:
        return "none", []
    return "", []


def leaves(tree) -> List[Any]:
    out: List[Any] = []
    kind, kids = _children(tree)
    if not kind:
        return [tree]
    for kid in kids:
        out.extend(leaves(kid))
    return out


def unflatten_like(tree, values):
    """A tree of ``tree``'s structure whose leaves are ``values`` in order."""
    it = iter(values)

    def build(node):
        kind, kids = _children(node)
        if not kind:
            return next(it)
        if kind == "dict":
            return {k: build(node[k]) for k in sorted(node)}
        if kind == "none":
            return None
        return type(node)(build(kid) for kid in kids)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``."""
    return unflatten_like(tree, [fn(leaf) for leaf in leaves(tree)])


def key_paths(tree, prefix: Tuple = ()) -> List[Tuple]:
    """Each leaf's path as a tuple of keys: a dict's key, a tuple's or
    list's index as an ``int`` (``jax.tree_util``'s ``DictKey`` and
    ``SequenceKey``)."""
    kind, _ = _children(tree)
    if not kind:
        return [prefix]
    if kind == "dict":
        return [p for k in sorted(tree) for p in key_paths(tree[k], prefix + (k,))]
    if kind == "none":
        return []
    return [p for i, kid in enumerate(tree) for p in key_paths(kid, prefix + (i,))]


def map_with_path(fn: Callable, tree):
    """``fn(path, leaf)`` over the leaves of ``tree`` (paths of
    ``key_paths``)."""
    return unflatten_like(tree, [fn(p, leaf) for p, leaf
                                 in zip(key_paths(tree), leaves(tree))])


def flatten_up_to(tree, other) -> List[Any]:
    """``other``'s subtrees at the positions of ``tree``'s leaves (a moment
    tree whose int8 leaves are ``{q, scale}`` dicts, against the params)."""
    kind, kids = _children(tree)
    if not kind:
        return [other]
    if kind == "dict":
        if sorted(other) != sorted(tree):
            raise ValueError(f"keys {sorted(other)} != {sorted(tree)}")
        pairs = [(tree[k], other[k]) for k in sorted(tree)]
    else:
        if len(other) != len(kids):
            raise ValueError(f"{len(other)} entries != {len(kids)}")
        pairs = list(zip(kids, other))
    out: List[Any] = []
    for t, o in pairs:
        out.extend(flatten_up_to(t, o))
    return out


def paths(tree, prefix: str = "") -> List[str]:
    """Each leaf's path as ``jax.tree_util.keystr`` writes it, e.g.
    ``['layers'][0]['mlp']['w1']``."""
    kind, _ = _children(tree)
    if not kind:
        return [prefix]
    if kind == "dict":
        return [p for k in sorted(tree) for p in paths(tree[k], f"{prefix}[{k!r}]")]
    if kind == "none":
        return []
    return [p for i, kid in enumerate(tree) for p in paths(kid, f"{prefix}[{i}]")]


def structure(tree) -> str:
    """The tree's shape as jax prints a treedef, e.g. ``PyTreeDef({'a': *,
    'b': (*, *)})``."""

    def fmt(node):
        kind, kids = _children(node)
        if not kind:
            return "*"
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}" for k in sorted(node)) + "}"
        if kind == "none":
            return "None"
        inner = ", ".join(fmt(kid) for kid in kids)
        if kind == "tuple":
            return f"({inner},)" if len(kids) == 1 else f"({inner})"
        return f"[{inner}]"

    return f"PyTreeDef({fmt(tree)})"
