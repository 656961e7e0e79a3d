"""Dependency engine: MXNET read/write tags → explicit issue order.

MXNET's engine (paper §3.1) orders tasks with read/mutate tags on
objects; DepCha (§4.3) serializes collectives by making each one *write*
a shared dummy variable.  The reference reproduces that in XLA with
tokens threaded through optimization barriers (``repro/core/
dependency.py``).  PyTorch runs eagerly, so the port states the order
directly:

  - every schedule chain gets its own communicator (``chain_groups``:
    one ``dist.new_group`` over the same ranks per chain — the paper's
    per-channel communicator).  Collectives on one communicator complete
    in issue order; those on different communicators may overlap.
  - on a ("pod", "data") mesh the hierarchical reducers take a
    ``PodComm`` per chain instead (``pod_comms``): the chain's world
    communicator plus its own intra-pod and inter-pod sub-communicators,
    so concom's chains still overlap stage by stage.
  - an issued collective is a ``Handle``; ``gate`` waits on the handles
    of an op's ``depends_on`` before the op is issued (the read-tag).
    On NCCL a wait orders the current CUDA stream after the collective
    without blocking the host; on gloo it blocks until the collective
    is done.
  - on CUDA each chain stages its buckets on its own stream
    (``ChainStreams``), so a wait in one chain never holds up the
    staging of another.
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


def chain_groups(chains: Iterable[int], device: torch.device
                 ) -> dict[int, dist.ProcessGroup]:
    """One communicator per chain, each over every rank, on
    ``backend_for(device)``.  Collective: every rank must call it with
    the same chains in the same order."""
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "repro_torch.launch.mesh.init_dist(device) first")
    ranks = list(range(dist.get_world_size()))
    return {c: dist.new_group(ranks, backend=backend_for(device))
            for c in sorted(set(chains))}


@dataclasses.dataclass
class PodComm:
    """One chain's communicators on a ("pod", "data") mesh, handed to a
    reducer as its ``group`` (the reducer signature stays
    ``(buf, bucket, group) -> Handle``; the hierarchical reducers read
    the sub-groups from it, every other reducer is never given one).

    ``world`` spans every rank (the chain's ``chain_groups`` entry);
    ``intra`` holds this rank's pod, ranks p·D .. p·D + D − 1 (group
    rank d); ``inter`` holds the ranks of this rank's data index d in
    every pod (group rank p).  ``ring`` is the intra-pod peer-memory ring
    of ``hierarchical_ring`` on CUDA (``kernels/collectives/kernel.py::
    PeerRing``), None otherwise."""

    world: dist.ProcessGroup
    intra: dist.ProcessGroup
    inter: dist.ProcessGroup
    ring: Any = None


def pod_comms(world_groups: Mapping[int, dist.ProcessGroup], pods: int,
              data: int, device: torch.device) -> dict[int, PodComm]:
    """A ``PodComm`` per chain of ``world_groups``: one intra-pod group
    per pod and one inter-pod group per data index, created anew for
    each chain on ``backend_for(device)``.  Collective: every rank
    creates every group (``new_group`` is), chains in sorted order, the
    pods' groups before the data indices'."""
    if pods * data != dist.get_world_size():
        raise ValueError(f"a mesh of {pods} pods x {data} ranks does not fit a "
                         f"world of {dist.get_world_size()}")
    p, d = divmod(dist.get_rank(), data)
    backend = backend_for(device)
    out = {}
    for c in sorted(world_groups):
        intra = [dist.new_group([q * data + j for j in range(data)], backend=backend)
                 for q in range(pods)][p]
        inter = [dist.new_group([q * data + j for q in range(pods)], backend=backend)
                 for j in range(data)][d]
        out[c] = PodComm(world_groups[c], intra, inter)
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
