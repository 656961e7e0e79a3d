"""Restore onto a DIFFERENT mesh (``repro/checkpoint/reshard.py``).

Checkpoints hold global arrays (``manager.py``), so resharding is
keeping each rank's block under the target mesh's specs, the mechanism
behind elastic scaling (node loss → a smaller mesh; capacity back → a
bigger one).  Divisibility is checked leaf by leaf first, so a bad
target mesh fails before any step runs.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.core.dependency import mesh_rank
from repro_torch.parallel.sharding import ShardingRules, shard_tree
from repro_torch.utils.trees import flatten_with_names


def validate_divisibility(tree: Any, specs: Any, mesh) -> None:
    """Raise ``ValueError`` naming the first leaf whose sharded dim does
    not split over its spec's axes on ``mesh`` (anything with a ``shape``
    mapping of axis sizes)."""
    named, _ = flatten_with_names(tree)
    spec_named, _ = flatten_with_names(specs)
    for (name, leaf), (_, spec) in zip(named, spec_named):
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
            n = math.prod(mesh.shape[a] for a in axes)
            if leaf.shape[dim] % n:
                raise ValueError(
                    f"{name}: dim {dim} ({leaf.shape[dim]}) not divisible "
                    f"by mesh axes {axes} (={n})")


def reshard(tree: Any, rules: ShardingRules, mesh, rank: int | None = None) -> Any:
    """A host (global) tree → this rank's blocks on ``mesh`` (``rank``:
    the mesh rank, by default this process's)."""
    specs = rules.tree_specs(tree)
    validate_divisibility(tree, specs, mesh)
    if rank is None:
        rank = mesh_rank(mesh)
    return shard_tree(tree, specs, mesh, rank)
