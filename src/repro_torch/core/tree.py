"""The port's parameter trees: nested dicts, lists and tuples whose leaves
are tensors (or anything else that is not one of those containers).

A leaf's path is the tuple of dict keys and sequence indices that reach it;
`keystr` spells it as jax.tree_util.keystr does ("['layers'][0]['attn']"),
so a checkpoint names every leaf by where it sits.  Dicts are walked in
insertion order.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

_CONTAINERS = (dict, list, tuple)


def leaves_with_path(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """Every (path, leaf) of `tree`, in walk order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items() for item in leaves_with_path(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` and of each of `rest` (same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, _CONTAINERS):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like: Any, new_leaves: list) -> Any:
    """A tree of `like`'s structure holding `new_leaves` in walk order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def keystr(path: tuple) -> str:
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)
