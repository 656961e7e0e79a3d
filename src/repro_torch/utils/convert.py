"""Weights from the reference into the port.

``params_from_numpy`` takes the reference's params as numpy arrays keyed
by reference leaf name (``repro.utils.trees.flatten_with_names`` of a
JAX param tree, each leaf through ``np.asarray``) and gives the port's
parameter tree: the same nesting, the same names, torch tensors on
``device``.  Both packages then compute the same function.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def unflatten_names(named: Mapping[str, Any]) -> Any:
    """Nested dicts from "a/b/c" leaf names; a level whose keys are
    exactly "0" … "n-1" becomes a list (the reference's lists of blocks)."""
    root: dict = {}
    for name, leaf in named.items():
        *path, last = name.split("/")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        kids = {k: listify(v) for k, v in node.items()}
        if kids and sorted(kids) == sorted(str(i) for i in range(len(kids))):
            return [kids[str(i)] for i in range(len(kids))]
        return kids

    return listify(root)


def params_from_numpy(named: Mapping[str, np.ndarray],
                      device: str | torch.device = "cpu") -> Any:
    """Reference params (name → numpy array) → the port's param tree."""
    return unflatten_names({
        n: torch.from_numpy(np.array(a, copy=True)).to(device)
        for n, a in named.items()})
