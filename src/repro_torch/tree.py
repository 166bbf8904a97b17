"""Parameter and state trees as the JAX package flattens them.

A tree is nested dicts (keys in sorted order, as ``jax.tree`` flattens
them), lists and tuples (in order), NamedTuples and dataclasses (their
fields, in order) with tensors (or numpy arrays) at the leaves; ``None``
is an empty subtree.  `leaves` gives the reference's leaf order, which
its optimizers follow (the global norm's sum, the update's walk), and
`paths` the reference checkpoint's key of each leaf (``_path_str`` of
`repro/ckpt/checkpoint.py`: a dict key or a sequence index as itself, a
field as ``.name``, joined by ``/``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

__all__ = ["leaves", "paths", "map_leaves"]


def _children(tree) -> list | None:
    """(key string, child) pairs of a node, or None for a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def paths(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(checkpoint key, leaf) of every leaf, in the reference's order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from paths(child, f"{prefix}/{key}" if prefix else key)


def leaves(tree) -> list:
    """The leaves in the reference's flattening order."""
    return [leaf for _, leaf in paths(tree)]


def map_leaves(fn: Callable, tree, *rest):
    """A tree of the same structure with ``fn(leaf, *matching leaves of
    rest)`` at each leaf, called in the order of `leaves`."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):  # visited in sorted key order, as `leaves`
        return {k: map_leaves(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_leaves(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return type(tree)(map_leaves(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree))
