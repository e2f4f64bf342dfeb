"""Nested dicts, lists and tuples of tensors (the reference's pytrees),
walked in jax's order: a dict by sorted key, a list or tuple in order.

The order matters where leaves are numbered, as in a checkpoint
(``checkpoint/io.py``): ``torch.utils._pytree`` walks a dict in insertion
order, which would hand leaf ``a{i}`` of a reference checkpoint to the wrong
tensor.  ``None`` is an empty node, as in jax.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

IsLeaf = Optional[Callable[[Any], bool]]


def _node(x: Any, is_leaf: IsLeaf) -> bool:
    if is_leaf is not None and is_leaf(x):
        return False
    return isinstance(x, (dict, list, tuple)) or x is None


def _children(x: Any) -> list:
    if isinstance(x, dict):
        return [x[k] for k in sorted(x)]
    return [] if x is None else list(x)


def leaves(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    """The leaves in jax's order."""
    if not _node(tree, is_leaf):
        return [tree]
    return [leaf for c in _children(tree) for leaf in leaves(c, is_leaf)]


def unflatten(like: Any, flat: List[Any], is_leaf: IsLeaf = None) -> Any:
    """``like``'s structure with the leaves ``flat``, in :func:`leaves`'
    order."""
    it = iter(flat)

    def build(x):
        if not _node(x, is_leaf):
            return next(it)
        if isinstance(x, dict):
            built = {k: build(x[k]) for k in sorted(x)}
            return {k: built[k] for k in x}          # the caller's key order
        if x is None:
            return None
        return type(x)(build(c) for c in x)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: IsLeaf = None
             ) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure, or with leaves where ``tree``
    has them), in ``tree``'s structure."""
    flat = leaves(tree, is_leaf)
    others = [_leaves_like(tree, r, is_leaf) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(flat, *others)], is_leaf)


def _leaves_like(like: Any, tree: Any, is_leaf: IsLeaf) -> List[Any]:
    """``tree``'s subtrees at the positions of ``like``'s leaves."""
    if not _node(like, is_leaf):
        return [tree]
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in _leaves_like(like[k], tree[k], is_leaf)]
    return [x for a, b in zip(_children(like), _children(tree))
            for x in _leaves_like(a, b, is_leaf)]


def treedef_str(tree: Any) -> str:
    """jax's ``str(treedef)`` of ``tree``, as the reference's checkpoint
    manifest records it: ``PyTreeDef({'a': [*, *], 'b': *})``."""

    def s(x):
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {s(x[k])}" for k in sorted(x)) \
                + "}"
        if isinstance(x, list):
            return "[" + ", ".join(s(c) for c in x) + "]"
        if isinstance(x, tuple):
            inner = ", ".join(s(c) for c in x)
            return f"({inner},)" if len(x) == 1 else f"({inner})"
        return "None" if x is None else "*"

    return f"PyTreeDef({s(tree)})"
