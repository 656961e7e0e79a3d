"""Weights from the reference into the port.

``params_from_numpy`` takes the reference's params as numpy arrays keyed
by reference leaf name (``repro.utils.trees.flatten_with_names`` of a
JAX param tree, each leaf through ``np.asarray``) and gives the port's
parameter tree: the same nesting, the same names, torch tensors on
``device``.  Both packages then compute the same function.  With a
``mesh`` and a ``rank`` it keeps only that rank's block of each leaf
(``parallel/sharding.py::shard_leaf`` by the leaf's spec under
``rules``, with the layer stacks over "stage" on a mesh with pipeline
stages): what the reference's ``device_put`` with a ``NamedSharding``
puts on that device.
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


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a torch tensor of the same dtype and bits.  A
    bf16 JAX leaf comes out of ``np.asarray`` as an ``ml_dtypes``
    bfloat16 array, which torch does not read: its bits are viewed as
    int16 and reinterpreted as ``torch.bfloat16``, exactly."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(named: Mapping[str, np.ndarray],
                      device: str | torch.device = "cpu", *, mesh=None,
                      rank: int = 0, rules=None) -> Any:
    """Reference params (name → numpy array) → the port's param tree; with
    ``mesh`` (and ``rules``, a ``ShardingRules``) rank ``rank``'s blocks."""
    if mesh is None:
        return unflatten_names({n: tensor_from_numpy(a).to(device)
                                for n, a in named.items()})
    from repro_torch.parallel.sharding import STAGE_AXIS, shard_leaf, stage_shard_specs

    coords = mesh.coords(rank)
    specs = {n: rules.spec(n) for n in named}
    if STAGE_AXIS in mesh.axis_names:         # each stage keeps its layers
        specs = stage_shard_specs(specs)
    return unflatten_names({
        n: shard_leaf(tensor_from_numpy(a), specs[n], mesh, coords)
        .contiguous().to(device) for n, a in named.items()})
