"""Trees of tensors: nested dicts (leaves in sorted key order, as
``jax.tree`` flattens them) and lists or tuples."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def tree_leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree``, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """A tree of ``like``'s structure whose leaves are taken from the
    iterator ``leaves`` in :func:`tree_leaves`'s order."""
    if isinstance(like, dict):
        return {k: tree_unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(tree_unflatten(v, leaves) for v in like)
    return next(leaves)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` of the
    same structure."""
    cols = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, iter([fn(*xs) for xs in zip(*cols)]))
