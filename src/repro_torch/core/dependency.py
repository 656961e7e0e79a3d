"""Dependency engine: MXNET read/write tags → explicit issue order.

MXNET's engine (paper §3.1) orders tasks with read/mutate tags on
objects; DepCha (§4.3) serializes collectives by making each one *write*
a shared dummy variable.  The reference reproduces that in XLA with
tokens threaded through optimization barriers (``repro/core/
dependency.py``).  PyTorch runs eagerly, so the port states the order
directly:

  - every schedule chain gets its own communicators (``mesh_comms``, a
    ``ChainComms`` per chain — the paper's per-channel communicator): one
    for each set of mesh axes a reduction of the chain spans.  The group
    of a reduce set is the ranks that share the coordinates of every
    other axis (``coset_ranks``): ("data",) groups the ranks of one model
    coordinate, ("data", "model") is the world.  Collectives on one
    communicator complete in issue order; those on different
    communicators may overlap.
  - on a ("pod", "data", "model") mesh the hierarchical reducers also
    read the chain's ``PodComm`` (``ChainComms.pod``, from
    ``pod_comms``): its intra-pod and inter-pod communicators, both at
    the rank's model coordinate, so concom's chains still overlap stage
    by stage.
  - an issued collective is a ``Handle``; ``gate`` waits on the handles
    of an op's ``depends_on`` before the op is issued (the read-tag).
    On NCCL a wait orders the current CUDA stream after the collective
    without blocking the host; on gloo it blocks until the collective
    is done.
  - on CUDA each chain stages its buckets on its own stream
    (``ChainStreams``), so a wait in one chain never holds up the
    staging of another.
  - every communicator the port creates comes from ``coset_groups`` or
    ``pod_comms`` (one ``new_group`` call site, ``_new_group``), and is
    recorded in the innermost open ``comm_scope``: its owner (a train
    step, a ``GradSync``) destroys what it recorded with
    ``destroy_groups`` when its life ends.  Each chain keeps its own
    groups: nothing caches or merges two chains' communicators.
  - every collective the port issues goes through ``collective`` or
    ``exchange``.  On NCCL they pass device tensors straight through.
    On a gloo group with CUDA tensors they stage through pinned host
    memory: gloo reads ``data_ptr()`` as host memory.  The backend is
    the caller's choice (``launch/mesh.py::init_dist``); nothing falls
    back from one to the other.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Iterable, Mapping, Sequence

import torch
import torch.distributed as dist


class Done:
    """The work of a collective that already ran to its end: a
    host-staged one, or a reducer that is a sequence of collectives."""

    def wait(self) -> bool:
        return True


DONE = Done()


class Recorded:
    """The work of kernels issued on the current CUDA stream (a group of
    one, the ring collectives, a shard update): waiting on it orders the
    caller's current stream after them, without blocking the host.  On
    the CPU the work is done when it returns."""

    def __init__(self, device: torch.device):
        self._device = device
        self._event = None
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def wait(self) -> bool:
        if self._event is not None:
            torch.cuda.current_stream(self._device).wait_event(self._event)
        return True


class Handle:
    """One issued collective (the write to the paper's dummy variable).

    ``wait()`` orders the caller after the collective and returns its
    output, multiplied once by ``scale`` (a reducer's data-parallel
    mean) the first time it is waited on.  ``work`` is the collective's
    ``torch.distributed`` work, or ``DONE``.
    """

    def __init__(self, work, out: torch.Tensor, scale: float = 1.0):
        self._work = work
        self._out = out
        self._scale = scale

    @property
    def out(self) -> torch.Tensor:
        """The output tensor; its value is defined once waited on."""
        return self._out

    def wait(self) -> torch.Tensor:
        self._work.wait()
        if self._scale != 1.0:
            self._out.mul_(self._scale)
            self._scale = 1.0
        return self._out

    def release(self) -> None:
        """Drop the output once its consumer has read it: later waits
        still order the caller after the work, and return None."""
        self.wait()
        self._out = None


def gate(handles: Mapping[int, Handle], deps: Iterable[int]) -> None:
    """Read-dependency: wait on every dependency's collective."""
    for d in deps:
        handles[d].wait()


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    absent — the port never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def backend_for(device: torch.device) -> str:
    """The backend of communicators for tensors on ``device``: gloo on
    the CPU; on CUDA the default group's (NCCL unless ``init_dist`` was
    asked for gloo), or NCCL before a default group exists."""
    if device.type != "cuda":
        return "gloo"
    return dist.get_backend() if dist.is_initialized() else "nccl"


def _host_staged(group: dist.ProcessGroup, tensors: Sequence[torch.Tensor]) -> bool:
    return (dist.get_backend(group) == "gloo"
            and any(t.device.type == "cuda" for t in tensors))


def _pinned(t: torch.Tensor, copy: bool) -> torch.Tensor:
    """A pinned host tensor like ``t``, holding ``t``'s values if ``copy``
    (a synchronous copy: the device work that produced ``t`` is done)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if copy:
        h.copy_(t)
    return h


def collective(fn, group: dist.ProcessGroup, out: torch.Tensor,
               *ins: torch.Tensor):
    """Issue ``fn(out, *ins, group=group, async_op=True)`` — a
    ``torch.distributed`` collective that writes ``out`` (in place when
    there are no ``ins``) — and return its work.

    On a gloo group with CUDA tensors the collective runs on pinned host
    copies to its end and ``out`` is written back before this returns
    (the work is ``DONE``).  Any other group gets the tensors as they
    are."""
    if not _host_staged(group, (out, *ins)):
        return fn(out, *ins, group=group, async_op=True)
    h_out = _pinned(out, copy=not ins)
    fn(h_out, *[_pinned(t, copy=True) for t in ins], group=group,
       async_op=True).wait()
    out.copy_(h_out)
    return DONE


def exchange(group: dist.ProcessGroup,
             sends: Sequence[tuple[torch.Tensor, int, int]],
             recvs: Sequence[tuple[torch.Tensor, int, int]]) -> None:
    """One batch of point-to-point transfers on ``group``, waited on.
    ``sends`` and ``recvs`` are ``(tensor, peer, tag)``, peers given as
    ranks of ``group``.  Transfers between one pair of ranks match in
    the order they are listed (NCCL) and by tag (gloo), so every rank
    must list them alike.  On NCCL the wait orders the current stream
    after the transfers; on a gloo group with CUDA tensors they run on
    pinned host copies and the received values are written back."""
    staged = _host_staged(group, [t for t, _, _ in (*sends, *recvs)])
    ops, back = [], []
    for t, peer, tag in sends:
        ops.append(dist.P2POp(dist.isend, _pinned(t, True) if staged else t,
                              dist.get_global_rank(group, peer), group, tag))
    for t, peer, tag in recvs:
        h = _pinned(t, False) if staged else t
        back.append((t, h))
        ops.append(dist.P2POp(dist.irecv, h, dist.get_global_rank(group, peer),
                              group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for t, h in back:
            t.copy_(h)


# stage-ring hops made (``ring_exchange``, forward and backward), their
# payload bytes and the host seconds spent in them (the transfer's wait
# with gloo, its issue with NCCL), for the card's accounting
# (``chip_smoke.py``); a ring of one makes none
HOPS = 0
HOP_BYTES = 0
HOP_S = 0.0


def ring_exchange(group: dist.ProcessGroup | None, index: int, size: int, shift: int,
                  xs: Sequence[torch.Tensor],
                  tags: Sequence[int] | None = None) -> list[torch.Tensor]:
    """One hop of every tensor of ``xs`` along a ring of the ``size``
    ranks of ``group``: group rank ``index`` sends to index + ``shift``
    and receives from index − ``shift`` (mod ``size``), tensor k under
    ``tags[k]`` (k by default), in one ``exchange``; counted in
    ``HOPS``/``HOP_BYTES``/``HOP_S``.  A ring of one gives ``xs`` back."""
    global HOPS, HOP_BYTES, HOP_S
    if size == 1:
        return list(xs)
    t0 = time.perf_counter()
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    tags = range(len(xs)) if tags is None else tags
    exchange(group, [(x, (index + shift) % size, k) for k, x in zip(tags, xs)],
             [(o, (index - shift) % size, k) for k, o in zip(tags, outs)])
    HOPS += 1
    HOP_BYTES += sum(x.numel() * x.element_size() for x in xs)
    HOP_S += time.perf_counter() - t0
    return outs


# the open ``comm_scope``s, innermost last: each a list of the
# communicators made while it was the innermost
_SCOPES: list[list[dist.ProcessGroup]] = []


@contextlib.contextmanager
def comm_scope():
    """Record every communicator this rank joins while the scope is the
    innermost one (``coset_groups``, ``pod_comms``), in creation order:
    ``with comm_scope() as groups: ...``, then ``destroy_groups(groups)``
    when their owner is done.  A scope opened inside another keeps its
    groups from the outer one, so each owner destroys only its own."""
    made: list[dist.ProcessGroup] = []
    _SCOPES.append(made)
    try:
        yield made
    finally:
        _SCOPES.pop()


def _new_group(ranks: list[int], backend: str) -> dist.ProcessGroup | None:
    """``new_group`` (collective over the world: every world rank calls it
    for every group, in one order); the group if this rank is a member,
    recorded in the innermost ``comm_scope``, else None."""
    g = dist.new_group(ranks, backend=backend)
    if dist.get_rank() not in ranks:
        return None
    if _SCOPES:
        _SCOPES[-1].append(g)
    return g


def destroy_groups(groups: list[dist.ProcessGroup]) -> None:
    """Destroy the communicators of ``groups`` (a ``comm_scope``'s list),
    in creation order, emptying the list.  Collective in the sense that
    every world rank calls it for the same owner at the same point of
    its program: each destroys the groups it is a member of."""
    while groups:
        dist.destroy_process_group(groups.pop(0))


def live_groups() -> int:
    """The process groups this rank holds, the default one included (the
    size of c10d's group map)."""
    return len(dist.distributed_c10d._world.pg_map) if dist.is_initialized() else 0


def reduce_key(axes: Iterable[str], mesh) -> tuple[str, ...]:
    """The axes of ``axes`` with a size above 1, in the mesh's order: a
    reduction over ``axes`` needs exactly their communicator (an axis of
    size 1 adds no rank)."""
    axes = set(axes)
    return tuple(a for a in mesh.axis_names if a in axes and mesh.shape[a] > 1)


def coset_ranks(axes: Iterable[str], mesh) -> list[list[int]]:
    """The rank groups of a reduction over ``axes``: the ranks that share
    the coordinates of every other axis, each group in rank order, the
    groups by their first rank.  Ranks are row-major over the mesh's
    axes (``parallel/sharding.py::Mesh``)."""
    names = tuple(mesh.axis_names)
    sizes = [mesh.shape[a] for a in names]
    axes = set(axes)
    strides = [math.prod(sizes[i + 1:]) for i in range(len(names))]
    red = [i for i, a in enumerate(names) if a in axes]
    groups: dict[int, list[int]] = {}
    for r in range(math.prod(sizes)):
        base = r - sum(((r // strides[i]) % sizes[i]) * strides[i] for i in red)
        groups.setdefault(base, []).append(r)
    return [groups[b] for b in sorted(groups)]


def mesh_rank(mesh) -> int | None:
    """This process's rank in ``mesh`` (``Mesh.rank_in`` of its world
    rank; 0 without a process group), or None outside the mesh."""
    world_rank = dist.get_rank() if dist.is_initialized() else 0
    rank_in = getattr(mesh, "rank_in", None)
    return rank_in(world_rank) if rank_in is not None else world_rank


def _world_ranks(mesh) -> tuple[int, ...]:
    ranks = getattr(mesh, "world_ranks", None)
    size = math.prod(mesh.shape[a] for a in mesh.axis_names)
    return tuple(ranks) if ranks is not None else tuple(range(size))


def coset_groups(keys: Iterable[tuple[str, ...]], mesh, device: torch.device
                 ) -> dict[tuple[str, ...], dist.ProcessGroup | None]:
    """For each reduce set of ``keys``, under its ``reduce_key``, this
    rank's communicator on ``backend_for(device)``, or None for a group
    of one in a larger world (nothing to reduce) and on a rank outside
    the mesh.  Collective over the WORLD: every world rank creates the
    group of every coset (``new_group`` is), the sets in sorted order,
    the cosets by first rank, and keeps its own; a mesh that spans fewer
    ranks than the world (``Mesh.ranks``) groups its own world ranks, and
    the ranks outside it create the groups too and keep none."""
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "repro_torch.launch.mesh.init_dist(device) first")
    world = dist.get_world_size()
    members = _world_ranks(mesh)
    if members[-1] >= world:
        raise ValueError(f"a mesh over the world ranks {members} ({dict(mesh.shape)}) "
                         f"does not fit a world of {world}")
    backend = backend_for(device)
    out: dict[tuple[str, ...], dist.ProcessGroup | None] = {}
    for key in sorted({reduce_key(k, mesh) for k in keys}):
        out[key] = None
        if not key and world > 1:
            continue
        for ranks in coset_ranks(key, mesh):
            g = _new_group([members[r] for r in ranks], backend)
            if g is not None:
                out[key] = g
    return out


class ChainComms:
    """One chain's communicators, one per reduce set (``get(axes)``), on
    a mesh; ``pod`` is the chain's ``PodComm`` for the hierarchical
    reducers on a mesh with a pod axis, else None."""

    def __init__(self, groups: Mapping[tuple[str, ...], dist.ProcessGroup | None],
                 mesh, pod: "PodComm | None" = None):
        self.groups = dict(groups)
        self.mesh = mesh
        self.pod = pod

    def get(self, axes: Iterable[str]) -> dist.ProcessGroup | None:
        """The communicator of a reduction over ``axes``; None for a
        group of one in a larger world."""
        key = reduce_key(axes, self.mesh)
        if key not in self.groups:
            raise KeyError(f"no communicator over {key} on this chain "
                           f"(it holds {sorted(self.groups)})")
        return self.groups[key]


def mesh_comms(chains: Iterable[int], reduce_sets: Iterable[Iterable[str]], mesh,
               device: torch.device) -> dict[int, ChainComms]:
    """A ``ChainComms`` per chain, each with a communicator for every
    reduce set of ``reduce_sets`` and for the whole world.  Collective:
    chains in sorted order, then ``coset_groups``'s order."""
    keys = {reduce_key(ax, mesh) for ax in reduce_sets}
    keys.add(reduce_key(mesh.axis_names, mesh))
    return {c: ChainComms(coset_groups(keys, mesh, device), mesh)
            for c in sorted(set(chains))}


@dataclasses.dataclass
class PodComm:
    """One chain's stage communicators on a ("pod", "data") mesh, the
    ``pod`` of its ``ChainComms`` (the hierarchical reducers read them).

    ``intra`` holds this rank's pod at its model coordinate m, the ranks
    (p, d', m) (group rank d); ``inter`` holds the ranks (p', d, m) of
    every pod (group rank p).  ``ring`` is the intra-pod peer-memory
    ring of ``hierarchical_ring`` on CUDA
    (``kernels/collectives/kernel.py::PeerRing``), None otherwise."""

    intra: dist.ProcessGroup | None
    inter: dist.ProcessGroup | None
    ring: Any = None


def pod_comms(chains: Iterable[int], pods: int, data: int, device: torch.device,
              model: int = 1, ranks: Sequence[int] | None = None) -> dict[int, PodComm]:
    """A ``PodComm`` per chain: one intra-pod group per (pod, model
    coordinate) and one inter-pod group
    per (data, model coordinate), created anew for each chain on
    ``backend_for(device)``, mesh rank (p·data + d)·model + m at (p, d,
    m), world rank ``ranks[mesh rank]`` (by default the mesh rank).
    Collective over the world: every world rank creates every group
    (``new_group`` is), chains in sorted order, the intra-pod groups
    before the inter-pod ones, each by first rank; a rank outside the
    mesh keeps None for both."""
    size = pods * data * model
    ranks = tuple(range(size)) if ranks is None else tuple(ranks)
    if size != len(ranks) or ranks[-1] >= dist.get_world_size():
        raise ValueError(f"a mesh of {pods} pods x {data} x {model} ranks over the world "
                         f"ranks {ranks} does not fit a world of {dist.get_world_size()}")
    backend = backend_for(device)

    def group(mesh_ranks):
        return _new_group([ranks[r] for r in mesh_ranks], backend)

    out = {}
    for c in sorted(set(chains)):
        intra = [group([(q * data + j) * model + mm for j in range(data)])
                 for q in range(pods) for mm in range(model)]
        inter = [group([(q * data + j) * model + mm for q in range(pods)])
                 for j in range(data) for mm in range(model)]
        out[c] = PodComm(next((g for g in intra if g is not None), None),
                         next((g for g in inter if g is not None), None))
    return out


class ChainStreams:
    """Per-chain CUDA streams for one schedule's execution.

    Entering makes every chain stream wait for the current stream (the
    gradients are ready); ``on(chain)`` runs staging on that chain's
    stream; leaving makes the current stream wait for every chain (the
    reduced gradients are ready).  On the CPU every method is a no-op.
    """

    def __init__(self, chains: Iterable[int], device: torch.device):
        self.device = device
        self.streams = ({c: torch.cuda.Stream(device) for c in sorted(set(chains))}
                        if device.type == "cuda" else {})

    def __enter__(self) -> "ChainStreams":
        if self.streams:
            cur = torch.cuda.current_stream(self.device)
            for s in self.streams.values():
                s.wait_stream(cur)
        return self

    def __exit__(self, *exc) -> None:
        if self.streams:
            cur = torch.cuda.current_stream(self.device)
            for s in self.streams.values():
                cur.wait_stream(s)

    def on(self, chain: int):
        if not self.streams:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[chain])
