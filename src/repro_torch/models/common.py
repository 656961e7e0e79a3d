"""Shared model building blocks (``repro/models/common.py``).

The reference writes these for execution inside ``shard_map`` on local
shards, with explicit tensor-parallel collectives over the "model" axis.
Here each rank holds its shards and the collectives run on a
``ModelAxis``: the communicator of the rank's model group, its
coordinate on the axis and the axis's extent, built from the mesh
(``model_axis``) and passed down.

FSDP's per-layer gather runs on an ``FsdpAxes``: the communicator of the
rank's dp group (its own, shared with no gradient sync), its dp index
and the dp extent (``fsdp_axes``).  ``fsdp_all_gather`` is the
reference's tiled ``all_gather`` over the dp axes, whose transpose under
``check_vma=False`` is ``psum_scatter``: the backward reduce-scatters
the cotangent to the rank's shard.

``model_all_gather`` is the reference's tiled ``all_gather`` over
"model" (RWKV's channel mix gathers its receptance), with the same
reduce-scatter backward on the model group.

``model_psum`` is the reference's ``psum`` over "model" under
``shard_map(check_vma=False)``: an all-reduce whose backward is the same
all-reduce of the cotangent (psum's transpose there is psum).  So every
gradient comes out tp × its per-shard value, as the reference's does, and
the train step divides by tp; a leaf replicated over "model" holds a
partial gradient on each model rank, which the gradient sync sums over
"model".  ``pmax`` runs on detached values only.

The numerics are the reference's: norms in f32 and cast back, RoPE
products promoted to f32 before the cast back, the cross-entropy in f32.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import dependency as dep
from repro_torch.parallel.sharding import (
    MODEL_AXIS,
    STAGE_AXIS,
    dp_index,
    shard_tree,
    stage_shard_specs,
)
from repro_torch.utils.trees import tree_map_with_names


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The "model" mesh axis as one rank sees it: ``group`` the
    communicator of its model group (None at extent 1), ``index`` its
    coordinate (the reference's ``axis_index("model")``), ``size`` the
    extent (tp)."""

    group: dist.ProcessGroup | None
    index: int
    size: int


NO_MODEL_AXIS = ModelAxis(None, 0, 1)


def model_axis(mesh, device: str | torch.device = "cuda") -> ModelAxis:
    """This rank's ``ModelAxis``: the communicator of its model group
    (the ranks that share its other coordinates), its coordinate on
    "model" and the axis's extent.  Collective: every world rank creates
    every model group (none at extent 1); a rank outside the mesh gets
    no group."""
    tp = mesh.shape.get(MODEL_AXIS, 1)
    if tp == 1:
        return NO_MODEL_AXIS
    group = dep.coset_groups([(MODEL_AXIS,)], mesh, dep.resolve_device(device))[(MODEL_AXIS,)]
    me = dep.mesh_rank(mesh)
    return ModelAxis(group, 0 if me is None else mesh.coords(me)[MODEL_AXIS], tp)


class _ModelPsum(torch.autograd.Function):
    """psum over "model" with psum as its transpose."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.contiguous().clone()
        dep.collective(dist.all_reduce, group, out).wait()
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        out = g.contiguous().clone()
        dep.collective(dist.all_reduce, ctx.group, out).wait()
        return out, None


def model_psum(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Sum ``x`` over the model group (identity at tp=1); its backward
    sums the cotangent over the group too."""
    if axis.size == 1:
        return x
    return _ModelPsum.apply(x, axis.group)


def model_pmax(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Max of a detached ``x`` over the model group (no gradient)."""
    if axis.size == 1:
        return x
    out = x.detach().contiguous().clone()
    dep.collective(functools.partial(dist.all_reduce, op=dist.ReduceOp.MAX),
                   axis.group, out).wait()
    return out


@dataclasses.dataclass(frozen=True)
class FsdpAxes:
    """The dp axes as one rank sees them for FSDP's gathers: ``group`` the
    communicator of its dp group (None at extent 1), ``index`` its dp
    index (pod-major: the chunk of a sharded dim it holds,
    ``parallel/sharding.py::shard_leaf``), ``size`` the dp extent."""

    group: dist.ProcessGroup | None
    index: int
    size: int


NO_FSDP = FsdpAxes(None, 0, 1)


def fsdp_axes(mesh, dp_axes, device: str | torch.device = "cuda") -> FsdpAxes:
    """This rank's ``FsdpAxes`` over ``dp_axes``: a communicator of its
    own for its dp group (the ranks that share its model coordinate;
    the group's ranks in rank order, so group rank i is dp index i), its
    dp index and the extent.  Collective: every world rank creates every
    dp group (none at extent 1); a rank outside the mesh gets no group."""
    size = math.prod(mesh.shape.get(a, 1) for a in dp_axes)
    if size == 1:
        return NO_FSDP
    key = dep.reduce_key(dp_axes, mesh)
    group = dep.coset_groups([key], mesh, dep.resolve_device(device))[key]
    me = dep.mesh_rank(mesh)
    return FsdpAxes(group, 0 if me is None else dp_index(me, mesh), size)


class _TiledGather(torch.autograd.Function):
    """Tiled all-gather of a shard along ``dim`` over the group of
    ``axes`` (an ``FsdpAxes`` or a ``ModelAxis``: chunk i from group rank
    i); the backward reduce-scatters (sums) the cotangent back to the
    shard: an all-to-all of its chunks and the peers' chunks added in rank
    order, so every rank sums in one order."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        ctx.dim, ctx.axes = dim, axes
        g = axes.size
        parts = x.new_empty((g * x.shape[0], *x.shape[1:]))
        dep.collective(dist.all_gather_into_tensor, axes.group, parts, x.contiguous()).wait()
        shape = list(x.shape)
        shape[dim] *= g
        return parts.view(g, *x.shape).movedim(0, dim).reshape(shape)

    @staticmethod
    def backward(ctx, gy: torch.Tensor):
        dim, g = ctx.dim, ctx.axes.size
        shape = list(gy.shape)
        shape[dim:dim + 1] = [g, shape[dim] // g]
        chunks = gy.reshape(shape).movedim(dim, 0).contiguous()
        recv = torch.empty_like(chunks)
        dep.collective(dist.all_to_all_single, ctx.axes.group, recv, chunks).wait()
        out = recv[0].clone()
        for i in range(1, g):
            out.add_(recv[i])
        return out, None, None


def fsdp_all_gather(x: torch.Tensor, dim: int, axes: FsdpAxes) -> torch.Tensor:
    """The whole of a dp-sharded tensor along ``dim`` (identity at dp
    extent 1); its backward is the reduce-scatter of the cotangent."""
    if axes.size == 1:
        return x
    return _TiledGather.apply(x, dim, axes)


def model_all_gather(x: torch.Tensor, axis: ModelAxis, dim: int = -1) -> torch.Tensor:
    """The reference's tiled ``all_gather`` over "model" along ``dim``
    (identity at tp=1): each rank's chunk at its model coordinate.  Its
    backward reduce-scatters the cotangent over "model", all_gather's
    transpose: the cotangents of the model ranks summed, so the gradient
    comes out tp × its per-shard value, as ``model_psum``'s convention
    has it and the train step's ÷tp expects."""
    if axis.size == 1:
        return x
    return _TiledGather.apply(x, dim % x.dim(), axis)


def _check_axis(tp: int, axis: ModelAxis) -> None:
    if axis.size != tp:
        raise ValueError(f"tp={tp} but the model axis has extent {axis.size}: pass "
                         f"the rank's ModelAxis (models/common.py::model_axis)")


# ---------------------------------------------------------------- numerics
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "silu": F.silu,
    "relu": F.relu,
    "relu2": lambda x: F.relu(x).square(),
}


# ------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int → cos/sin (..., head_dim/2) f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2).  Half-split
    rotation; a bf16 ``x`` times the f32 angles is computed in f32 and
    cast back once."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# -------------------------------------------------------------- init utils
def init_tree(draw: Callable, specs: Callable, cfg, *, seed: int,
              device: str | torch.device, mesh=None, rank: int | None = None) -> dict:
    """A family's ``init_params``: ``draw(cfg, seed, device)``, its global
    tree; with a ``mesh`` (and this process's ``rank``, by default the
    process group's) the global tree is drawn and only the rank's blocks
    under ``specs(tree, cfg)`` kept (``parallel/sharding.py::shard_tree``),
    so a leaf replicated over an axis is equal on every rank of it and the
    shards of any layout put together are the one-rank tree of the same
    seed.  On a mesh with a "stage" axis each rank keeps its stage's
    slice of the stacked layers too (``stage_shard_specs``).  A config
    whose storage is sharded (tp > 1, FSDP) needs the
    mesh, except on ``meta``, where only shapes are made."""
    device = dep.resolve_device(device)
    if mesh is not None:
        if rank is None:
            rank = dep.mesh_rank(mesh)
            if rank is None:
                raise ValueError(f"rank {dist.get_rank()} is outside the mesh over the "
                                 f"world ranks {mesh.world_ranks}: pass the mesh rank "
                                 f"whose blocks to keep")
        if mesh.shape.get(MODEL_AXIS, 1) != cfg.tp:
            raise ValueError(f"tp={cfg.tp} on a mesh with model extent "
                             f"{mesh.shape.get(MODEL_AXIS, 1)}")
        full = draw(cfg, seed, device)
        sp = specs(full, cfg)
        if STAGE_AXIS in mesh.axis_names:       # each stage keeps its layers
            sp = stage_shard_specs(sp)
        local = shard_tree(full, sp, mesh, rank)
        out = tree_map_with_names(lambda _n, t: t.contiguous().clone(), local)
        del full, local
        return out
    fsdp = getattr(cfg, "fsdp", False)
    if (cfg.tp != 1 or fsdp) and device.type != "meta":
        raise ValueError(f"tp={cfg.tp}, fsdp={fsdp}: pass the mesh and the rank, "
                         f"whose shards init_params keeps")
    return draw(cfg, seed, device)


def dense_init(gen: torch.Generator, shape, in_dim: int, dtype,
               device: torch.device) -> torch.Tensor:
    """Normal(0, 1/in_dim) drawn in f32 from ``gen`` (a generator on
    ``device``) and cast to ``dtype``; on ``meta`` only the shape."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


# -------------------------------------------------- TP matmuls (explicit)
def col_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x replicated, w column-sharded → output sharded (no collective)."""
    return x @ w


def row_parallel(x_sharded: torch.Tensor, w: torch.Tensor,
                 axis: ModelAxis) -> torch.Tensor:
    """x sharded on the contraction dim, w row-sharded → psum over model."""
    return model_psum(x_sharded @ w, axis)


# ------------------------------------------- vocab-sharded embedding/loss
def embed_lookup(emb_local: torch.Tensor, ids: torch.Tensor, tp: int,
                 axis: ModelAxis = NO_MODEL_AXIS) -> torch.Tensor:
    """emb_local: (V/tp, d), this rank's vocab shard; ids: (B, S) global
    vocab ids → (B, S, d).  Each rank looks up the ids inside its shard
    (others → a zero row) and the psum over model rebuilds the full
    embedding; at tp=1 an id outside [0, V) looks up a zero row."""
    _check_axis(tp, axis)
    v_local = emb_local.shape[0]
    local_ids = ids - axis.index * v_local
    in_shard = (local_ids >= 0) & (local_ids < v_local)
    out = emb_local[local_ids.clamp(0, v_local - 1)]
    out = torch.where(in_shard[..., None], out,
                      torch.zeros((), dtype=emb_local.dtype, device=emb_local.device))
    return model_psum(out, axis)


def sharded_softmax_xent(logits_local: torch.Tensor, labels: torch.Tensor,
                         tp: int, axis: ModelAxis = NO_MODEL_AXIS) -> torch.Tensor:
    """Per-token cross-entropy (B, S) over a vocab sharded on the model
    axis: logits_local (B, S, V/tp), labels (B, S) global ids, in f32.
    The max shift is held with no gradient (the loss does not depend on
    it; the pmax over model runs on detached values); the sum of
    exponentials and the true logit are psums over model.  A label
    outside the vocab scores its true logit as 0."""
    _check_axis(tp, axis)
    logits = logits_local.float()
    v_local = logits.shape[-1]
    gmax = model_pmax(logits.amax(dim=-1).detach(), axis)
    shifted = logits - gmax[..., None]
    sumexp = model_psum(torch.exp(shifted).sum(dim=-1), axis)
    local_ids = labels.long() - axis.index * v_local
    in_shard = (local_ids >= 0) & (local_ids < v_local)
    true_logit = shifted.gather(-1, torch.where(in_shard, local_ids, 0)[..., None])[..., 0]
    true_logit = model_psum(torch.where(in_shard, true_logit, 0.0), axis)
    return torch.log(sumexp) - true_logit


# ------------------------------------------------------------ GQA helpers
@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """How q and kv heads distribute over the TP axis.  When kv_heads <
    tp, each rank slices the replicated kv projection to the kv head(s)
    its local q heads read (its gradient: the slice's transpose, summed
    over model by the gradient sync of a replicated leaf)."""

    n_heads: int          # possibly padded up to a multiple of tp
    kv_heads: int
    head_dim: int
    tp: int

    @property
    def q_local(self) -> int:
        return self.n_heads // self.tp

    @property
    def group(self) -> int:          # q heads per kv head
        return self.n_heads // self.kv_heads

    @property
    def kv_sharded(self) -> bool:
        return self.kv_heads >= self.tp

    @property
    def kv_local(self) -> int:
        if self.kv_sharded:
            return self.kv_heads // self.tp
        return max(self.q_local // self.group, 1)

    def kv_slice_start(self, index: int) -> int:
        """First kv head the rank at model coordinate ``index`` needs
        (only when not kv_sharded)."""
        return (index * self.q_local) // self.group


def pad_heads(n_heads: int, tp: int) -> int:
    """Round up so heads shard evenly (starcoder2: 24 → 32 on tp=16)."""
    return int(-(-n_heads // tp) * tp)
