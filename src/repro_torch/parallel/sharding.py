"""Sharding rules, the subset the data-parallel slice uses.

A param spec is a tuple of the mesh axis names its dims are sharded over
(``()`` = replicated).  ``missing_axes(spec, mesh)`` gives the mesh axes
a gradient for that param must still be reduced over: the complement of
the axes in its spec — the rule every grad-sync strategy in
``repro_torch.core`` follows (``repro/parallel/sharding.py``).
"""
from __future__ import annotations

from typing import Iterable

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
