"""Sharding rules, and the cut of a global tree into one rank's shards.

A param spec is a tuple with one entry per dim: the mesh axis (or tuple
of axes) the dim is sharded over, or None (``()`` = replicated) — the
reference's ``PartitionSpec`` as a plain tuple.  ``missing_axes(spec,
mesh)`` gives the mesh axes a gradient for that param must still be
reduced over: the complement of the axes in its spec — the rule every
grad-sync strategy in ``repro_torch.core`` follows
(``repro/parallel/sharding.py``).  ``ShardingRules`` maps leaf names to
specs by regex, first match wins, so the bucket plans group leaves by
the reference's reduce axes.

``shard_tree`` is the port's counterpart of ``jax.device_put(tree,
NamedSharding(mesh, spec))``: it keeps the block of each leaf that a
rank holds, by the rank's coordinates (``Mesh.coords``).

``Mesh`` is the reference mesh's shape alone: axis names and sizes.  Its
ranks follow the reference mesh's device order, row-major over the axes
(the last fastest): on ("data", "model") rank d·tp + m is at (d, m); on
("pod", "data", "model") rank (p·data + d)·tp + m is at (p, d, m).  A
mesh may span fewer ranks than the process group (a rung of an elastic
ladder, ``repro_torch.elastic``): ``ranks`` lists the world ranks it
spans, ascending, mesh rank i being world rank ``ranks[i]``; by default
the first ``size`` world ranks, so the mesh rank is the world rank.
``localize_structs`` gives the shapes of those blocks, as the
reference's does for its ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Iterable

MODEL_AXIS = "model"
STAGE_AXIS = "stage"       # pipeline stages (DESIGN.md §15), between data and model
DP_AXES = ("pod", "data")  # subset actually present in the mesh is used


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    shape: dict[str, int]
    # the world ranks the mesh spans, ascending; None: range(size)
    ranks: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.ranks is not None:
            r = tuple(self.ranks)
            if len(r) != self.size or list(r) != sorted(set(r)) or r[0] < 0:
                raise ValueError(f"a mesh of {self.size} ranks cannot span the world "
                                 f"ranks {r}: want {self.size} distinct ones, ascending")
            object.__setattr__(self, "ranks", r)

    @property
    def size(self) -> int:
        return math.prod(self.shape[a] for a in self.axis_names)

    @property
    def world_ranks(self) -> tuple[int, ...]:
        """The world ranks of mesh ranks 0, 1, ... (ascending)."""
        return tuple(range(self.size)) if self.ranks is None else self.ranks

    def rank_in(self, world_rank: int) -> int | None:
        """A world rank's mesh rank, or None for a rank outside the mesh."""
        if self.ranks is None:
            return world_rank if 0 <= world_rank < self.size else None
        try:
            return self.ranks.index(world_rank)
        except ValueError:
            return None

    def coords(self, rank: int) -> dict[str, int]:
        """Rank → its coordinate on every axis (row-major, the last axis
        fastest: the reference mesh's device order)."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a mesh of {self.size}")
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords.get(a, 0)
        return r


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


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def local_shape(shape: Iterable[int], spec: Iterable, mesh) -> tuple[int, ...]:
    """A leaf's global shape → the shape of one rank's block under
    ``spec``: each dim divided by the sizes of the axes it is sharded
    over (the reference's ``localize_structs`` of one leaf)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if out[dim] % mesh.shape[a]:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                                 f"over {a!r} of {mesh.shape[a]}")
            out[dim] //= mesh.shape[a]
    return tuple(out)


def localize_structs(tree: Any, specs: Any, mesh) -> Any:
    """Global leaves (anything with ``shape`` and ``dtype``: tensors,
    ``meta`` tensors) → ``meta`` tensors of each rank's block shape
    (``repro/parallel/sharding.py::localize_structs``)."""
    import torch

    from repro_torch.utils.trees import flatten_with_names, tree_unflatten

    named, treedef = flatten_with_names(tree)
    spec_of = dict(flatten_with_names(specs)[0])
    return tree_unflatten(treedef, [
        torch.empty(local_shape(l.shape, spec_of[n], mesh), dtype=l.dtype, device="meta")
        for n, l in named])


def shard_leaf(x, spec: Iterable, mesh, coords: dict[str, int]):
    """The block of ``x`` (a tensor, or a numpy array) that the rank at
    ``coords`` holds under ``spec`` (a view; a dim sharded over several
    axes is split row-major over them, as the reference's mesh lays them
    out)."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n = 1
        idx = 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coords[a]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
        size = x.shape[dim] // n
        x = x[(slice(None),) * dim + (slice(idx * size, (idx + 1) * size),)]
    return x


def shard_tree(tree: Any, specs: Any, mesh, rank: int) -> Any:
    """Rank ``rank``'s blocks of a global tree (``shard_leaf`` of every
    leaf by its spec; replicated leaves whole).  The counterpart of
    ``jax.device_put(tree, NamedSharding(mesh, specs))`` for one device."""
    from repro_torch.utils.trees import flatten_with_names, tree_unflatten

    coords = mesh.coords(rank)
    named, treedef = flatten_with_names(tree)
    spec_of = dict(flatten_with_names(specs)[0])
    return tree_unflatten(treedef, [shard_leaf(l, spec_of[n], mesh, coords)
                                    for n, l in named])


def stage_shard_specs(specs: Any, *, axis: str = STAGE_AXIS,
                      prefixes: tuple[str, ...] = ("blocks/",)) -> Any:
    """Overlay pipeline-stage sharding on a spec tree (the reference's
    ``stage_shard_specs``): dim 0, the layer stack, of every leaf under
    ``prefixes`` is sharded over ``axis``, so each stage holds a
    contiguous slice of the stacked layers.  Every other leaf keeps its
    spec, replicated over the stage axis, which ``missing_axes`` turns
    into a gradient sum over it (the stages that do not use the leaf
    add exact zeros)."""
    from repro_torch.utils.trees import flatten_with_names, tree_unflatten

    named, treedef = flatten_with_names(specs)
    out = []
    for n, s in named:
        if any(n.startswith(p) for p in prefixes):
            entries = list(s) if len(s) else [None]
            if entries[0] is not None:
                raise ValueError(f"stage overlay: {n} already shards its stack dim "
                                 f"over {entries[0]!r}")
            entries[0] = axis
            s = tuple(entries)
        out.append(s)
    return tree_unflatten(treedef, out)


def batch_spec(mesh) -> tuple:
    """Batch dim sharded over every data-parallel axis present."""
    dp = dp_axes_of(mesh)
    return (dp if len(dp) > 1 else (dp[0] if dp else None),)


def dp_index(rank: int, mesh) -> int:
    """The mesh rank's data-parallel index: its coordinates on the dp
    axes, row-major (the batch slice ``batch_spec`` gives it).  The dp
    axes lead the mesh, so it is the rank over the extent of the axes
    after them: every rank of a replica ("stage" × "model") reads the
    same one."""
    return rank // math.prod(mesh.shape[a] for a in mesh.axis_names if a not in DP_AXES)


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
