"""Nested containers of tensors ("trees") as the reference's pytrees order
them: a dict by its sorted keys, a NamedTuple by its fields, a tuple or
list by position; ``None`` holds no leaf. Paths print as
``jax.tree_util.keystr`` prints them (``.opt.m['embed']``), so that a
checkpoint of either package names its leaves alike.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves_with_path", "leaves", "keystr", "tree_map", "unflatten_like"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """``[(key entry, child)]`` of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def _walk(node, path: tuple[str, ...], out: list) -> None:
    # A module-level function, not a closure over ``out``: a nested
    # function that calls itself is a reference cycle, which would keep
    # every leaf it saw alive until the garbage collector runs.
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for key, child in kids:
        _walk(child, path + (key,), out)


def leaves_with_path(tree) -> list[tuple[tuple[str, ...], Any]]:
    """``[(path, leaf)]`` in the reference's leaf order."""
    out = []
    _walk(tree, (), out)
    return out


def keystr(path: tuple[str, ...]) -> str:
    return "".join(path)


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), in leaf order, rebuilding ``tree``'s
    containers (dicts with their keys sorted); a node for which
    ``is_leaf`` holds counts as a leaf."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    kw = {"is_leaf": is_leaf}
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), **kw)
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest), **kw)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, c, *(r[i] for r in rest), **kw)
                          for i, c in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(template, new_leaves: list):
    """``template``'s structure with ``new_leaves`` in leaf order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
