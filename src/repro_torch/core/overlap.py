"""DepCha's compute/comm overlap: each layer's gradient collective issued
INSIDE the backward pass — the port of ``repro/core/overlap.py``.

Paper §4.3: the push (the copy into the comm buffer) is scheduled the
moment a gradient is produced, and the allreduce runs while the rest of
back-propagation goes on.  The reference puts each layer's psum inside
the backward scan body (a ``custom_vjp`` around the layer function) and
lets XLA overlap it.  PyTorch runs eagerly, so the port does it directly:

  - ``scan_layers`` runs the layer function over the stacked layer
    params, unbound ONCE a forward (``layer_rows``): ``unbind``'s
    backward is one ``stack``, where indexing ``w[li]`` would make every
    layer's backward write a zero tensor of the whole stack.  A stack
    that runs in groups between the layers of another (the
    transformer's self blocks around its cross blocks) runs a range at a
    time from the same rows (``run_layers``); each stack then has its
    ``LayerSync``, the second sharing the first's communicators and
    stream, behind one ``StackSyncs``.
  - with a ``LayerSync``, each layer's param slices first pass through
    ``sync_in_backward``, an identity ``torch.autograd.Function``.
    Autograd sums every use of a tensor before it runs the node that made
    it, so the Function's backward receives the layer's whole parameter
    cotangent, exactly once.  It copies the cotangents into the layer's
    slot of a buffer the syncer owns (the pack kernel, row 1: one launch,
    at scale 1 into a buffer of the cotangents' own dtype, a bit copy),
    issues the layer's collective on the syncer's stream, ordered after
    the copy by a stream wait, and returns no gradient for the params.
    The compute stream never waits on the collective, and a transport
    never reads a tensor that autograd may free or reuse.
  - after the backward, ``LayerSync.finish`` waits on every layer's
    collective and unpacks (row 2) each reduced slot into the layer's
    rows of the stacked ``.grad`` tensors (rows of the outermost dim:
    contiguous).
  - ``remat`` checkpoints the layer body: ``"full"`` recomputes all of
    it in the backward, ``"dots"`` keeps the matmul outputs (``aten.mm``,
    ``bmm``, ``addmm``: ``jax.checkpoint_policies.dots_saveable``) and
    recomputes the rest.  The identity sits outside the checkpoint, so
    its backward still fires once a layer.

The reduction runs in the cotangent's dtype, as the reference's psum
does, and sums (the loss is already divided by the global token count).
Its branches are the reference's (``overlap.py:61–90``): the flat sum;
``hierarchical`` (the three stages of ``core/hierarchical.py``) when a
leaf reduces over both "pod" and "data"; ``compressed`` (the int8
two-phase allreduce of ``core/compression.py`` over "data", in f32, with
an f32 sum across the pods) when ``intra_size > 1`` and the leaf reduces
over "data".  In both, a replicated leaf's sum over "model" follows on
its own communicator.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import dependency as dep
from repro_torch.core.buckets import Bucket, LeafInfo
from repro_torch.core.compression import compressed_allreduce
from repro_torch.core.hierarchical import hierarchical_allreduce
from repro_torch.kernels.collectives import ops as coll_ops
from repro_torch.utils.trees import flatten_with_names

REMATS = ("none", "dots", "full")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


class LayerSync:
    """The in-backward gradient sync of one stack of layers, set up once
    per step function.

    ``stacked``: the stack's leaves (name → tensor of shape (L, ...);
    shapes and dtypes only, ``meta`` works), named ``prefix + name`` in
    the port's tree.  ``axes``: each leaf's reduce axes, in the stack's
    leaf order (``parallel/sharding.py::reduce_axes_tree``).  A layer's
    leaves are grouped by (axes, dtype) into one slot each: one
    collective a group a layer (at tp=1 one a layer; at tp > 1 the
    model-sharded leaves reduce over the dp axes and the replicated ones
    over the dp axes and "model", each group on its own communicator).
    ``reducer`` is ``cfg.depcha_reducer``, ``intra_size`` the "data"
    size the compressed branch shards over.

    A leaf with no reduce axes (FSDP's: sharded over every mesh axis,
    its gradient already the dp sum of its shard) takes no slot: its
    cotangent passes through the identity's backward to autograd, which
    writes the stacked leaf's ``.grad`` (``passthrough`` names them).

    Construction is collective: it creates the syncer's communicators,
    one a reduce set (and on a pod mesh for ``hierarchical`` or
    ``compressed`` its intra- and inter-pod groups), on every rank in the
    same order.  With ``share`` (another stack's ``LayerSync`` on the same
    mesh) it creates none and uses that one's communicators and stream.
    """

    def __init__(self, stacked: dict, axes: Sequence[tuple[str, ...]], mesh, *,
                 prefix: str = "blocks/", reducer: str = "flat",
                 intra_size: int = 0, device: str | torch.device = "cuda",
                 share: "LayerSync | None" = None):
        named = flatten_with_names(stacked)[0]
        if len(axes) != len(named):
            raise ValueError(f"{len(named)} leaves but {len(axes)} axis groups")
        self.names = tuple(prefix + n for n, _ in named)
        self.n_layers = int(named[0][1].shape[0])
        self.device = dep.resolve_device(device)
        self.mesh_shape = dict(mesh.shape)
        self.reducer = reducer
        self.intra_size = intra_size
        groups: dict[tuple, list[int]] = {}
        self.passthrough = frozenset(self.names[j] for j, ax in enumerate(axes) if not ax)
        for j, ((_, w), ax) in enumerate(zip(named, axes)):
            if int(w.shape[0]) != self.n_layers:
                raise ValueError(f"{self.names[j]} stacks {w.shape[0]} layers, "
                                 f"not {self.n_layers}")
            if ax:
                groups.setdefault((tuple(ax), w.dtype), []).append(j)
        # (bucket over the layer's cotangent list, reduce axes, slot dtype)
        self.buckets: list[tuple[Bucket, tuple[str, ...], torch.dtype]] = []
        for k, ((ax, dt), idx) in enumerate(groups.items()):
            leaves = tuple(LeafInfo(self.names[j], j, tuple(named[j][1].shape[1:]), dt,
                                    named[j][1][0].numel()) for j in idx)
            slot_dt = torch.float32 if self._compressed(ax) else dt
            self.buckets.append((Bucket(leaves, ax, 0, k), ax, slot_dt))
        # a communicator for each reduce set, and for the stages the
        # hierarchical and compressed branches split a set into
        sets = {ax for _, ax, _ in self.buckets}
        if reducer in ("hierarchical", "compressed"):
            sets |= {_rest(ax) for ax in sets} | {("data",)}
        if share is not None:
            self.comms, self.pod, self.stream = share.comms, share.pod, share.stream
            for ax in sets:
                self.comms.get(ax)          # raises if the shared sync lacks the set
        else:
            self.comms = dep.mesh_comms([0], sets, mesh, self.device)[0]
            self.pod = None
            if "pod" in self.mesh_shape and reducer in ("hierarchical", "compressed"):
                self.pod = dep.pod_comms([0], self.mesh_shape["pod"], self.mesh_shape["data"],
                                         self.device, self.mesh_shape.get("model", 1),
                                         ranks=getattr(mesh, "world_ranks", None))[0]
            self.stream = (torch.cuda.Stream(self.device)
                           if self.device.type == "cuda" else None)
        self._slots: dict[int, torch.Tensor] = {}
        self.pending: dict[int, list] = {}
        self.collectives = 0          # issued in the current step's backward

    def _compressed(self, ax: tuple[str, ...]) -> bool:
        return self.reducer == "compressed" and self.intra_size > 1 and "data" in ax

    def _psum_rest(self, out: torch.Tensor, ax: tuple[str, ...]) -> torch.Tensor:
        """Sum ``out`` over the axes of ``ax`` besides "pod" and "data"
        (the model axis of a replicated leaf), on their communicator."""
        group = self.comms.get(_rest(ax))
        if group is not None and _rest(ax):
            dep.collective(dist.all_reduce, group, out).wait()
        return out

    def _reduce(self, slot: torch.Tensor, ax: tuple[str, ...]):
        """Issue one slot's reduction on the current stream: (work, the
        tensor that holds the result once the work is waited on)."""
        group = self.comms.get(ax)
        if not ax or group is None:          # a group of one: nothing to sum
            return dep.DONE, slot
        if self.reducer == "hierarchical" and "pod" in ax and "data" in ax:
            return dep.DONE, self._psum_rest(hierarchical_allreduce(slot, self.pod), ax)
        if self._compressed(ax):
            if self.intra_size != self.mesh_shape["data"]:
                raise ValueError(f"intra_size {self.intra_size} is not the mesh's "
                                 f"data size {self.mesh_shape['data']}")
            inter = self.pod.inter if "pod" in ax and self.pod is not None else None
            out = compressed_allreduce(slot, ("data",), self.mesh_shape, self.comms,
                                       inter=inter)
            return dep.DONE, self._psum_rest(out, ax)
        return dep.collective(dist.all_reduce, group, slot), slot

    def _slot(self, k: int, li: int) -> torch.Tensor:
        bucket, _, dt = self.buckets[k]
        if k not in self._slots:      # kept across steps: the syncer owns it
            self._slots[k] = torch.empty(self.n_layers * bucket.size, dtype=dt,
                                         device=self.device)
        return self._slots[k][li * bucket.size:(li + 1) * bucket.size]

    def begin(self) -> None:
        """Start a step: no layer has issued its collective yet."""
        self.pending = {}
        self.collectives = 0

    def issue(self, li: int, grads: Sequence[torch.Tensor]) -> None:
        """Layer ``li``'s backward: stage its cotangents and issue its
        collectives, never waiting on one."""
        if li in self.pending:
            raise RuntimeError(f"layer {li}'s cotangent arrived twice in one backward")
        issued = []
        for k, (bucket, ax, dt) in enumerate(self.buckets):
            slot = coll_ops.fused_pack(bucket, grads, dt, out=self._slot(k, li))
            ctx = contextlib.nullcontext()
            if self.stream is not None:
                self.stream.wait_stream(torch.cuda.current_stream(self.device))
                ctx = torch.cuda.stream(self.stream)
            with ctx:
                issued.append((k, *self._reduce(slot, ax)))
            self.collectives += 1
        self.pending[li] = issued

    def finish(self, stacked: Sequence[torch.Tensor]) -> None:
        """After the backward: wait on every layer's collectives and write
        the reduced cotangents into the ``.grad`` of the stacked leaves
        (``stacked``: the leaves of ``self.names``, in order), which the
        backward left unset."""
        missing = [li for li in range(self.n_layers) if li not in self.pending]
        if missing:
            raise RuntimeError(f"no in-backward gradient for layers {missing} of "
                               f"{self.names}")
        if len(stacked) != len(self.names):
            raise ValueError(f"expected {len(self.names)} stacked leaves, got {len(stacked)}")
        for name, w in zip(self.names, stacked):
            if name in self.passthrough:
                continue
            if w.grad is not None:
                raise RuntimeError(f"{name} got a gradient outside the in-backward sync")
            w.grad = torch.empty_like(w)
        for issued in self.pending.values():
            for _, work, _ in issued:
                work.wait()
        if self.stream is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self.stream)
        for li, issued in self.pending.items():
            rows = [w.grad[li] for w in stacked]
            for k, _, out in issued:
                if self.stream is not None:
                    out.record_stream(cur)
                coll_ops.fused_unpack(self.buckets[k][0], out, rows)


class StackSyncs:
    """The in-backward syncs of several stacks of layers (the
    transformer's ``blocks`` and ``cross_blocks``) as the train step sees
    one ``LayerSync``: ``names`` in the stacks' order, ``begin`` and
    ``finish`` over each, ``collectives`` summed.  ``of(prefix)`` is one
    stack's ``LayerSync``, which the forward hands that stack's layers."""

    def __init__(self, syncs: Sequence[LayerSync]):
        self.syncs = tuple(syncs)
        self.names = tuple(n for s in self.syncs for n in s.names)

    def of(self, prefix: str) -> LayerSync:
        for s in self.syncs:
            if s.names[0].startswith(prefix):
                return s
        raise KeyError(f"no stack under {prefix!r} in {[s.names[0] for s in self.syncs]}")

    @property
    def collectives(self) -> int:
        return sum(s.collectives for s in self.syncs)

    def begin(self) -> None:
        for s in self.syncs:
            s.begin()

    def finish(self, stacked: Sequence[torch.Tensor]) -> None:
        """``LayerSync.finish`` of each stack, on its share of ``stacked``
        (the leaves of ``names``, in order)."""
        if len(stacked) != len(self.names):
            raise ValueError(f"expected {len(self.names)} stacked leaves, got {len(stacked)}")
        start = 0
        for s in self.syncs:
            s.finish(stacked[start:start + len(s.names)])
            start += len(s.names)


def _rest(ax: tuple[str, ...]) -> tuple[str, ...]:
    return tuple(a for a in ax if a not in ("pod", "data"))


class _SyncInBackward(torch.autograd.Function):
    """Identity on a layer's parameter slices; its backward hands the
    layer's cotangents to the ``LayerSync`` and returns only those of its
    pass-through leaves."""

    @staticmethod
    def forward(ctx, sync: LayerSync, li: int, *params: torch.Tensor):
        ctx.sync, ctx.li = sync, li
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        ctx.sync.issue(ctx.li, grads)
        keep = ctx.sync.passthrough
        return (None, None) + tuple(g if n in keep else None
                                    for n, g in zip(ctx.sync.names, grads))


def sync_in_backward(params: dict, li: int, sync: LayerSync) -> dict:
    """Layer ``li``'s params (name → slice, in the stack's leaf order), as
    views whose gradient ``sync`` reduces inside the backward."""
    names = list(params)
    return dict(zip(names, _SyncInBackward.apply(sync, li, *params.values())))


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def rematted(fn: Callable, remat: str) -> Callable:
    """``fn(params, x)`` under the activation-checkpointing policy ``remat``."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"unknown remat {remat!r}, want one of {REMATS}")


def layer_rows(stacked: dict) -> list[dict]:
    """The layers of ``stacked`` (a flat dict of (L, ...) leaves), each a
    dict of its slices in the stack's leaf order, from ONE ``unbind`` a
    leaf (whose backward is one ``stack``)."""
    names = sorted(stacked)            # the stack's leaf order
    rows = {n: stacked[n].unbind(0) for n in names}
    return [{n: rows[n][li] for n in names} for li in range(len(rows[names[0]]))]


def run_layers(layer_fn: Callable[[dict, Any], Any], rows: Sequence[dict], x: Any,
               layers: Sequence[int], *, sync: LayerSync | None = None,
               remat: str = "none") -> Any:
    """``layer_fn(rows[li], x) -> x`` for ``li`` in ``layers``, in order,
    under ``remat``; with ``sync`` each layer's gradient is reduced inside
    the backward in slot ``li``.  A stack that runs in groups (the
    transformer's self blocks between its cross blocks) unbinds once
    (``layer_rows``) and runs a range at a time."""
    f = rematted(layer_fn, remat)
    for li in layers:
        p = rows[li]
        if sync is not None:
            p = sync_in_backward(p, li, sync)
        x = f(p, x)
    return x


def scan_layers(layer_fn: Callable[[dict, Any], Any], stacked: dict, x: Any, *,
                sync: LayerSync | None = None, remat: str = "none") -> Any:
    """``layer_fn(params_i, x) -> x`` over the layers of ``stacked`` (a
    flat dict of (L, ...) leaves), in order; returns the last ``x``.  With
    ``sync`` each layer's gradient is reduced inside the backward."""
    rows = layer_rows(stacked)
    return run_layers(layer_fn, rows, x, range(len(rows)), sync=sync, remat=remat)
