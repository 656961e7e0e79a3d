"""Sharding rules, the subset the data-parallel slice uses.

A param spec is a tuple with one entry per dim: the mesh axis (or tuple
of axes) the dim is sharded over, or None (``()`` = replicated) — the
reference's ``PartitionSpec`` as a plain tuple.  ``missing_axes(spec,
mesh)`` gives the mesh axes a gradient for that param must still be
reduced over: the complement of the axes in its spec — the rule every
grad-sync strategy in ``repro_torch.core`` follows
(``repro/parallel/sharding.py``).  ``ShardingRules`` maps leaf names to
specs by regex, first match wins, so the bucket plans group leaves by
the reference's reduce axes.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterable

MODEL_AXIS = "model"
DP_AXES = ("pod", "data")  # subset actually present in the mesh is used


def dp_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def flat_spec_axes(spec: Iterable) -> set[str]:
    out: set[str] = set()
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            out.update(entry)
        else:
            out.add(entry)
    return out


def missing_axes(spec: Iterable, mesh) -> tuple[str, ...]:
    """Mesh axes NOT appearing in ``spec`` — grads are summed over these."""
    have = flat_spec_axes(spec)
    return tuple(a for a in mesh.axis_names if a not in have)


def local_batch(global_batch: int, mesh) -> int:
    n = 1
    for a in dp_axes_of(mesh):
        n *= mesh.shape[a]
    if global_batch % n:
        raise ValueError(f"global_batch {global_batch} not divisible by DP={n}")
    return global_batch // n


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Regex → spec table, first match wins; unmatched names get
    ``default`` (replicated)."""

    rules: tuple[tuple[str, tuple], ...]
    default: tuple = ()

    def spec(self, name: str) -> tuple:
        for pat, spec in self.rules:
            if re.search(pat, name):
                return spec
        return self.default

    def tree_specs(self, params: Any) -> Any:
        from repro_torch.utils.trees import tree_map_with_names

        return tree_map_with_names(lambda n, _l: self.spec(n), params)


def spec_for_param(rules: ShardingRules, name: str) -> tuple:
    return rules.spec(name)


def reduce_axes_tree(rules: ShardingRules, params: Any, prefix: str,
                     mesh_axes: tuple[str, ...]) -> list[tuple[str, ...]]:
    """Per-leaf gradient-reduction axes (depcha's in-backward sync): for
    each leaf of ``params`` (named ``prefix + path``), the axes of
    ``mesh_axes`` NOT in its spec.  A flat list in the tree's leaf order."""
    from repro_torch.utils.trees import flatten_with_names

    axes = []
    for n, _ in flatten_with_names(params)[0]:
        have = flat_spec_axes(rules.spec(prefix + n))
        axes.append(tuple(a for a in mesh_axes if a not in have))
    return axes
