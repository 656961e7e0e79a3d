"""Nested-container utilities: stable key-naming of leaves.

The paper's KVStore names every gradient tensor with an integer key
("MXNET linearly orders all the relevant tensors and assigns unique keys,
starting from zero", §3.3).  Leaves of a nested dict/list tree are
linearly ordered by their path, exactly as ``jax.tree_util`` orders the
reference's pytrees: dict keys sorted, lists in order.  The leaf names
("stage0/0/c1", "stem/conv", "head") are the reference's, so bucket plans
built here and in ``repro`` agree leaf for leaf.

Only ``dict`` and ``list`` are containers; everything else — tensors,
tuples (param specs are tuples of axis names), None — is a leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The container skeleton of a tree: ``kind`` is "leaf", "dict" or
    "list"; ``keys`` the sorted dict keys (dicts only)."""

    kind: str
    keys: tuple = ()
    children: tuple["TreeDef", ...] = ()


def _flatten(tree: Any, prefix: str, out: list) -> TreeDef:
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        kids = tuple(_flatten(tree[k], f"{prefix}{k}/", out) for k in keys)
        return TreeDef("dict", keys, kids)
    if isinstance(tree, list):
        kids = tuple(_flatten(v, f"{prefix}{i}/", out)
                     for i, v in enumerate(tree))
        return TreeDef("list", (), kids)
    out.append((prefix[:-1], tree))
    return TreeDef("leaf")


def flatten_with_names(tree: Any) -> tuple[list[tuple[str, Any]], TreeDef]:
    """Flatten ``tree`` to ``[(name, leaf), ...]`` + treedef, in stable
    order (``repro.utils.trees.flatten_with_names``)."""
    named: list[tuple[str, Any]] = []
    treedef = _flatten(tree, "", named)
    return named, treedef


def tree_leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in flatten_with_names(tree)[0]]


def tree_unflatten(treedef: TreeDef, leaves: list[Any]) -> Any:
    it = iter(leaves)

    def build(td: TreeDef) -> Any:
        if td.kind == "leaf":
            return next(it)
        if td.kind == "dict":
            return {k: build(c) for k, c in zip(td.keys, td.children)}
        return [build(c) for c in td.children]

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map_with_names(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    named, treedef = flatten_with_names(tree)
    return tree_unflatten(treedef, [fn(n, l) for n, l in named])
