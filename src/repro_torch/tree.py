"""Param trees of the port: nested dicts, lists and tuples of tensors,
and the dataclasses a trainer keeps (``TrainState``, ``AdamWState``).

Keys follow the JAX package's tree paths as its checkpoint manager joins
them with "/": a dict entry by its key, a list entry by its index, a
dataclass field as ".name" (JAX's attribute key). Dict entries go in
sorted key order, as JAX flattens them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return ((str(k), tree[k]) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    return ((f".{f.name}", getattr(tree, f.name))
            for f in dataclasses.fields(tree))


def _is_node(tree) -> bool:
    return (isinstance(tree, (dict, list, tuple))
            or (dataclasses.is_dataclass(tree) and not isinstance(tree, type)))


def items(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(items(child, _join(prefix, key)))
    return out


def leaves(tree) -> list:
    """The leaves in JAX's flattening order."""
    return [leaf for _, leaf in items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure): a new tree of that
    structure."""
    others = [dict(items(r)) for r in rest]
    return map_with_path(lambda k, x: fn(x, *(o[k] for o in others)), tree)


def map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves: a new tree of the same
    structure (paths as :func:`items` gives them)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, _join(prefix, str(k)))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, _join(prefix, str(i)))
                          for i, v in enumerate(tree))
    if _is_node(tree):
        return dataclasses.replace(tree, **{
            f.name: map_with_path(fn, getattr(tree, f.name),
                                  _join(prefix, f".{f.name}"))
            for f in dataclasses.fields(tree)})
    return fn(prefix, tree)


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key
