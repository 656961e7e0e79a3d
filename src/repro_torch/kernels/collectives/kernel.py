"""Build and binding of the Hopper collectives kernels: the staging
kernels (``csrc/staging.cu``), the ring-hop combine
(``csrc/ring_accum.cu``) and the peer-memory rings (``csrc/ring_p2p.cu``).

``pack_bucket_kernel``/``unpack_bucket_kernel``/``ring_accum_kernel``
are the CUDA counterparts of ``repro/kernels/collectives/kernel.py``'s
Pallas kernels of the same names (``ring_accum_pairs_kernel`` is the
combine's entry for a whole ring hop, up to ``MAX_PAIRS`` pairs in one
launch), ``ring_reduce_scatter_kernel``/
``ring_all_gather_kernel`` those of ``ring_reduce_scatter_tpu``/
``ring_all_gather_tpu``; each source says what it replaces, what bounds
it and how it is laid out.  The rings run over a ``PeerRing``: one
rank's buffer of an intra-pod group, opened by its ring neighbours
through CUDA IPC, so the group's ranks must share one host.  A ring call
enqueues ``peer_memops(g, bidirectional)`` stream waits and g launches,
whose blocks signal the neighbours themselves; ``stream_memops`` counts
the waits the library enqueued.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use (``kernels/_build.py``)
and loaded with ``ctypes``.  Nothing here runs when the module is
imported.

The wrappers take CUDA tensors only: they check device, dtype, size and
contiguity and raise on anything else, launch on the current stream,
never synchronize, and count their launches in ``PACK_LAUNCHES`` /
``UNPACK_LAUNCHES`` / ``ACCUM_LAUNCHES`` / ``RS_LAUNCHES`` /
``AG_LAUNCHES`` (a ring call launches once a hop, g times).  There is no fallback: a
failed build or launch raises.

The combine and the staging kernels keep their host path short, since a
ring hop or a bucket moves only a few MB: the combine packs the pairs'
pointers and lengths into a preallocated buffer (one a thread) with one
``struct`` call, and pack and unpack share each bucket's layout
(offsets, sizes, launch groups: ``bucket_layout``), keyed by the
leaves' dtypes and sizes and the buffer's dtype, so that a call packs
only the leaves' pointers — the training loop's ``.grad`` tensors are
new each step.  Each tensor is checked by one condition; the detailed
checks run only to word a refusal (the peer rings' input likewise).
All read the current stream's raw handle without building a ``Stream``.
"""
from __future__ import annotations

import ctypes
import functools
import socket
import struct
import threading
import weakref
from pathlib import Path
from typing import Iterator, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import _build

PACK_LAUNCHES = 0
UNPACK_LAUNCHES = 0
ACCUM_LAUNCHES = 0
RS_LAUNCHES = 0
AG_LAUNCHES = 0
LAYOUTS_BUILT = 0   # bucket layouts built by pack or unpack (the rest of the calls reused one)

MAX_LEAVES = 64   # kMaxLeaves in csrc/staging.cu
MAX_PAIRS = 8     # kMaxPairs in csrc/ring_accum.cu
MAX_LAYOUTS = 256   # bucket layouts kept for reuse, oldest dropped first
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float64: 3}

ACCUM_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = (_CSRC / "staging.cu",)
_ACCUM_SOURCES = (_CSRC / "ring_accum.cu",)
_P2P_SOURCES = (_CSRC / "ring_p2p.cu",)
PEER_TIMEOUT_S = 120.0   # the longest a peer ring's stream waits on a neighbour
# return codes of csrc/ring_p2p.cu besides cudaError_t
_P2P_ERRORS = {90001: "the driver's stream memory operations are missing",
               90002: "a chunk larger than the ring's message slots",
               90003: "the ring has failed"}
_P2P_DRIVER = 100000
_P2P_HEADER_BYTES = 4096   # kHeaderBytes


def build() -> Path:
    """Compile the staging kernels unless this source is built; return
    the library's path."""
    return _build.build("staging", _SOURCES)


def build_ring_accum() -> Path:
    """Compile the ring-hop combine unless this source is built; return
    the library's path."""
    return _build.build("ring_accum", _ACCUM_SOURCES)


def build_ring_p2p() -> Path:
    """Compile the peer-memory rings unless this source is built; return
    the library's path."""
    return _build.build("ring_p2p", _P2P_SOURCES)


@functools.cache
def _p2p_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_ring_p2p()))
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.p2p_create.argtypes = [I, I, I, I, I64, I, ctypes.c_double,
                               ctypes.POINTER(P), ctypes.c_char_p]
    lib.p2p_open.argtypes = [P, ctypes.c_char_p, ctypes.c_char_p, I]
    for fn in (lib.p2p_reduce_scatter, lib.p2p_all_gather):
        fn.argtypes = [P, P, P, I64, I, I, P]   # ring, in, out, c, dtype, bidi, stream
    for fn in (lib.p2p_check, lib.p2p_message):
        fn.argtypes = [P, ctypes.c_char_p, I]
    lib.p2p_destroy.argtypes = [P]
    lib.p2p_memops.argtypes = [ctypes.POINTER(I64)]
    for fn in (lib.p2p_create, lib.p2p_open, lib.p2p_reduce_scatter,
               lib.p2p_all_gather, lib.p2p_check, lib.p2p_message, lib.p2p_destroy,
               lib.p2p_memops):
        fn.restype = I
    return lib


class PeerRingError(RuntimeError):
    """A peer ring's wait ran out (here or on a neighbour), or its set-up
    or a launch failed."""


def _p2p_error(rc: int, what: str, msg: bytes = b"") -> PeerRingError:
    if rc >= _P2P_DRIVER:
        why = f"CUDA driver error {rc - _P2P_DRIVER} in cuStreamWaitValue32"
    else:
        why = _P2P_ERRORS.get(rc, f"CUDA error {rc}")
    detail = msg.decode(errors="replace").strip()
    return PeerRingError(f"{what}: {why}" + (f": {detail}" if detail else ""))


def _free_ring(lib: ctypes.CDLL, ptr: int) -> None:
    lib.p2p_check(ptr, ctypes.create_string_buffer(8), 8)   # the ring's work first
    lib.p2p_destroy(ptr)


class PeerRing:
    """This rank's peer buffer of one intra-pod ring (one per chain).

    Collective over ``group`` (every rank of it constructs one, in the
    same order): each rank allocates a header of flag words and
    ``peer_slots(g)`` message slots per direction of ``slot_bytes`` each,
    ``bytes`` in all (``cudaMalloc``, not PyTorch's allocator, whose IPC
    handle names a whole segment), the 64-byte IPC handles travel over
    ``group`` with the host names, and each rank opens its two ring
    neighbours' buffers.  Ranks on different hosts, or a handle that
    does not open, raise: nothing falls back to another transport.
    ``timeout_s`` bounds every wait of the ring's streams.  ``close()``
    (collective) frees the buffers; a ring that is garbage-collected
    unclosed frees its own after its work, without waiting for the
    neighbours.
    """

    def __init__(self, group: dist.ProcessGroup, slot_bytes: int, *,
                 chain: int = 0, timeout_s: float = PEER_TIMEOUT_S):
        self.group = group
        self.g = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.chain = chain
        self.device = torch.device("cuda", torch.cuda.current_device())
        if self.g < 2:
            raise ValueError("a peer ring needs at least two ranks")
        lib = _p2p_lib()
        self.slots = peer_slots(self.g)
        ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(64)
        rc = lib.p2p_create(self.device.index, self.g, self.rank, chain, int(slot_bytes),
                            self.slots, float(timeout_s), ctypes.byref(ptr), handle)
        if rc:
            raise _p2p_error(rc, f"peer ring set-up (rank {self.rank}, chain {chain})")
        self._ptr = ptr.value
        self._finalizer = weakref.finalize(self, _free_ring, lib, self._ptr)
        self.slot_bytes = int(slot_bytes)
        # the header's page, then the slots, each rounded up to 256 bytes
        self.bytes = _P2P_HEADER_BYTES + 2 * self.slots * (-(-self.slot_bytes // 256) * 256)
        card = str(torch.cuda.get_device_properties(self.device).uuid)
        mine = (socket.gethostname(), card, handle.raw)
        every = [None] * self.g
        dist.all_gather_object(every, mine, group=group)
        right, left = every[(self.rank + 1) % self.g], every[(self.rank - 1) % self.g]
        for who, (host, _, _) in ((self.rank + 1, right), (self.rank - 1, left)):
            if host != mine[0]:
                raise PeerRingError(
                    f"peer ring set-up: rank {who % self.g} of the intra-pod group is "
                    f"on host {host!r}, this rank on {mine[0]!r}; a pod's ranks "
                    f"must share one host")
        # the hop kernels fence and signal at system scope when a neighbour's
        # buffer is on another card, at GPU scope when all share this one
        self.system_scope = right[1] != card or left[1] != card
        rc = lib.p2p_open(self._ptr, right[2], left[2], int(self.system_scope))
        if rc:
            raise _p2p_error(rc, f"peer ring set-up: opening the neighbours' buffers "
                                 f"(rank {self.rank}, chain {chain})")

    def _message(self) -> bytes:
        buf = ctypes.create_string_buffer(1024)
        _p2p_lib().p2p_message(self._ptr, buf, len(buf))
        return buf.value

    def check(self) -> None:
        """Wait for the ring's last call; raise ``PeerRingError`` if a
        wait of this ring ran out, here or on a neighbour."""
        buf = ctypes.create_string_buffer(1024)
        rc = _p2p_lib().p2p_check(self._ptr, buf, len(buf))
        if rc:
            raise _p2p_error(rc, f"peer ring (rank {self.rank}, chain {self.chain})",
                             buf.value)

    def close(self) -> None:
        """Collective: wait for every rank's ring work, then close the
        neighbours' buffers and free this rank's."""
        if not self._finalizer.alive:
            return
        err = None
        try:
            self.check()
        except PeerRingError as e:
            err = e
        dist.barrier(group=self.group)
        self._finalizer()
        if err is not None:
            raise err


def peer_slots(g: int) -> int:
    """Message slots a direction of a peer ring of ``g`` ranks (K).

    A link carries at most g - 1 messages a call and a slot is written
    again K messages later, so at K = 2(g - 1) a hop's credit wait refers
    to a message of the call before last, which the ring's ready waits of
    the last call already show read: the wait is enqueued but does not
    block.  K = 2g keeps two messages more of margin (csrc/ring_p2p.cu)."""
    return 2 * g


def peer_memops(g: int, bidirectional: bool) -> int:
    """Stream memory operations (``cuStreamWaitValue32``) one peer-ring
    call enqueues on a ring of ``g`` ranks: per hop, one ready wait per
    neighbour it reads from (not at hop 0) and one credit wait per
    neighbour it writes to (not at the last hop).  Both directions share
    the one neighbour at g = 2.  A chunk of one element runs one
    direction: pass ``bidirectional=False`` for it."""
    neighbours = 2 if bidirectional and g > 2 else 1
    return 2 * (g - 1) * neighbours


def stream_memops() -> dict:
    """The stream memory operations this process's peer rings have
    enqueued so far, by kernel: ``{"rs": n, "ag": n}``."""
    out = (ctypes.c_int64 * 2)()
    _p2p_lib().p2p_memops(out)
    return {"rs": out[0], "ag": out[1]}


def _peer_call(ring: PeerRing, fn, what: str, x: torch.Tensor, out: torch.Tensor,
               c: int, bidirectional: bool) -> None:
    if (x.device != ring.device or x.dtype not in ACCUM_DTYPE_CODES or x.dim() != 1
            or not x.is_contiguous()):
        if x.device != ring.device:
            raise ValueError(f"{what} takes tensors on {ring.device}, got {x.device}")
        if x.dtype not in ACCUM_DTYPE_CODES:
            raise ValueError(f"{what} takes one of {sorted(map(str, ACCUM_DTYPE_CODES))}, "
                             f"got {x.dtype}")
        raise ValueError(f"{what} takes a contiguous 1-D tensor, got {tuple(x.shape)}")
    rc = fn(ring._ptr, x.data_ptr(), out.data_ptr(), c, ACCUM_DTYPE_CODES[x.dtype],
            int(bidirectional), _stream(ring.device.index))
    if rc:
        raise _p2p_error(rc, f"{what} (rank {ring.rank}, chain {ring.chain})",
                         ring._message())


def ring_reduce_scatter_kernel(ring: PeerRing, x: torch.Tensor, *,
                               bidirectional: bool = True) -> torch.Tensor:
    """(g·c,) per-rank buffer → (c,) chunk ``ring.rank`` of the sum over
    the ring's ranks, through the neighbours' memory: g launches on the
    current stream, none waited for on the host."""
    global RS_LAUNCHES
    if x.numel() % ring.g:
        raise ValueError(f"{x.numel()} elements do not split into {ring.g} chunks")
    c = x.numel() // ring.g
    out = x.new_empty(c)
    if c:
        _peer_call(ring, _p2p_lib().p2p_reduce_scatter, "ring_reduce_scatter_kernel",
                   x, out, c, bidirectional)
        RS_LAUNCHES += ring.g
    return out


def ring_all_gather_kernel(ring: PeerRing, shard: torch.Tensor, *,
                           bidirectional: bool = True) -> torch.Tensor:
    """(c,) chunk ``ring.rank`` → (g·c,) every rank's chunk in rank order,
    through the neighbours' memory: g launches on the current stream."""
    global AG_LAUNCHES
    c = shard.numel()
    out = shard.new_empty(c * ring.g)
    if c:
        _peer_call(ring, _p2p_lib().p2p_all_gather, "ring_all_gather_kernel",
                   shard, out, c, bidirectional)
        AG_LAUNCHES += ring.g
    return out


# ``AccumArgs`` of csrc/ring_accum.cu, packed in one call: the count, then
# (a, b, out, n) a pair, out = a + b over n elements; one format a count.
_ACCUM_ARGS = [struct.Struct("<q" + "QQQq" * k) for k in range(MAX_PAIRS + 1)]


class _Layout(ctypes.Structure):
    """``Layout`` of ``csrc/staging.cu``: leaf i is
    ``buf[offset[i]:offset[i] + size[i]]``; its pointer comes per call."""
    _fields_ = [("offset", ctypes.c_int64 * MAX_LEAVES),
                ("size", ctypes.c_int64 * MAX_LEAVES), ("count", ctypes.c_int32)]


# the leaves' pointers of one staging launch, packed in one call
_LEAF_PTRS = [struct.Struct(f"<{k}Q") for k in range(MAX_LEAVES + 1)]

_local = threading.local()


def _leaf_ptr_table() -> tuple[ctypes.Array, int]:
    """This thread's column of leaf pointers for a staging launch and
    its address; the launch copies it into the kernel's arguments."""
    try:
        return _local.leaf_ptrs
    except AttributeError:
        buf = ctypes.create_string_buffer(_LEAF_PTRS[MAX_LEAVES].size)
        _local.leaf_ptrs = (buf, ctypes.addressof(buf))
        return _local.leaf_ptrs


def _accum_table() -> tuple[ctypes.Array, int]:
    """This thread's combine table and its address; a launch copies it
    into the kernel's arguments, so one table serves every call."""
    try:
        return _local.accum
    except AttributeError:
        buf = ctypes.create_string_buffer(_ACCUM_ARGS[MAX_PAIRS].size)
        _local.accum = (buf, ctypes.addressof(buf))
        return _local.accum


def _stream(index: int) -> int:
    """The current stream's raw handle on card ``index``."""
    return torch._C._cuda_getCurrentRawStream(index)


@functools.cache
def _accum_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_ring_accum()))
    lib.ring_accum_pairs.argtypes = [
        ctypes.c_void_p,                                     # AccumArgs*
        ctypes.c_int,                                        # dtype code
        ctypes.c_int,                                        # device index
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    lib.ring_accum_pairs.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for fn in (lib.staging_pack, lib.staging_unpack):
        fn.argtypes = [
            ctypes.c_void_p,               # Layout*
            ctypes.c_void_p,               # leaf pointers
            ctypes.c_int,                  # leaf dtype code
            ctypes.c_void_p,               # comm buffer
            ctypes.c_int,                  # comm dtype code
            ctypes.c_float,                # scale
            ctypes.c_int,                  # scale != 1
            ctypes.c_int,                  # device index
            ctypes.c_void_p,               # cudaStream_t
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, what: str, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(
            f"{what} has dtype {t.dtype}; the staging kernels take "
            f"{sorted(map(str, DTYPE_CODES))}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def _launch_groups(dtypes: Sequence[torch.dtype], sizes: Sequence[int]
                   ) -> Iterator[tuple[torch.dtype, list[int]]]:
    """(dtype, leaf indexes) per launch: leaves grouped by dtype (the
    kernel's template parameter), at most MAX_LEAVES per launch; empty
    leaves need no launch."""
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, (dt, n) in enumerate(zip(dtypes, sizes)):
        if n:
            by_dtype.setdefault(dt, []).append(i)
    for dt, idx in by_dtype.items():
        for i in range(0, len(idx), MAX_LEAVES):
            yield dt, idx[i:i + MAX_LEAVES]


_LAYOUTS: dict[tuple, tuple[int, tuple]] = {}


def bucket_layout(key: tuple) -> tuple[int, tuple]:
    """The layout of a bucket, from its ``key``: the buffer's dtype, then
    each leaf's dtype and size, flattened.  Returns (elements, one
    (``_Layout``, its address, leaf dtype code, the group's leaf indexes)
    per launch group).  Built from the key alone, once, and kept under it
    for pack and unpack alike."""
    global LAYOUTS_BUILT
    rec = _LAYOUTS.get(key)
    if rec is not None:
        return rec
    LAYOUTS_BUILT += 1
    dtypes, sizes = key[1::2], key[2::2]
    offsets, off = [], 0
    for n in sizes:
        offsets.append(off)
        off += n
    groups = []
    for dt, idx in _launch_groups(dtypes, sizes):
        args = _Layout()
        for j, i in enumerate(idx):
            args.offset[j], args.size[j] = offsets[i], sizes[i]
        args.count = len(idx)
        groups.append((args, ctypes.addressof(args), DTYPE_CODES[dt], tuple(idx)))
    if len(_LAYOUTS) >= MAX_LAYOUTS:
        del _LAYOUTS[next(iter(_LAYOUTS))]
    rec = _LAYOUTS[key] = (off, tuple(groups))
    return rec


def _key(buf_dtype: torch.dtype, leaves: Sequence[torch.Tensor], device: torch.device,
         what: str) -> tuple[tuple, list[int]]:
    """A bucket's layout key and its leaves' pointers; each leaf is
    checked by one condition, and ``_check`` words a refusal."""
    key, ptrs = [buf_dtype], []
    for t in leaves:
        if t.device != device or t.dtype not in DTYPE_CODES or not t.is_contiguous():
            for i, u in enumerate(leaves):
                _check(u, f"{what} {i}", device)
        key += (t.dtype, t.numel())
        ptrs.append(t.data_ptr())
    return tuple(key), ptrs


def _launch(fn, name: str, groups: tuple, ptrs: list[int], buf: torch.Tensor,
            scale: float) -> None:
    """One launch of ``fn`` per launch group of a layout."""
    index = buf.device.index
    stream, ptr, comm = _stream(index), buf.data_ptr(), DTYPE_CODES[buf.dtype]
    column, column_addr = _leaf_ptr_table()
    for _, addr, code, idx in groups:
        _LEAF_PTRS[len(idx)].pack_into(column, 0, *[ptrs[i] for i in idx])
        rc = fn(addr, column_addr, code, ptr, comm, float(scale), int(scale != 1.0),
                index, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def pack_bucket_kernel(leaves: Sequence[torch.Tensor], comm_dtype, *,
                       scale: float = 1.0, out: torch.Tensor | None = None) -> torch.Tensor:
    """Leaves (contiguous CUDA tensors, any shapes) → one 1-D
    ``comm_dtype`` buffer holding them back to back, times ``scale``:
    a new tensor, or ``out`` (1-D, contiguous, of the leaves' total
    size).  One launch per group of at most ``MAX_LEAVES`` leaves of one
    dtype."""
    global PACK_LAUNCHES
    if not leaves:
        raise ValueError("pack_bucket_kernel needs at least one leaf")
    device = leaves[0].device
    if device.type != "cuda":
        raise ValueError(f"pack_bucket_kernel takes CUDA tensors, got {device}")
    if comm_dtype not in DTYPE_CODES:
        raise ValueError(f"comm dtype {comm_dtype} is not supported")
    key, ptrs = _key(comm_dtype, leaves, device, "leaf")
    total, groups = bucket_layout(key)
    if out is None:
        out = torch.empty(total, dtype=comm_dtype, device=device)
    elif (out.device != device or out.dtype != comm_dtype or out.dim() != 1
          or out.numel() != total or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous 1-D {comm_dtype} tensor of {total} "
                         f"elements on {device}; got {out.dtype}{tuple(out.shape)} on "
                         f"{out.device}")
    _launch(_lib().staging_pack, "pack_bucket_kernel", groups, ptrs, out, scale)
    PACK_LAUNCHES += len(groups)
    return out


def unpack_bucket_kernel(buf: torch.Tensor, outs: Sequence[torch.Tensor], *,
                         scale: float = 1.0) -> None:
    """Inverse of ``pack_bucket_kernel``: write ``buf``'s consecutive
    slices, times ``scale`` and cast to each output's dtype, into
    ``outs``.  The outputs are written in place — on the training path
    they are the ``.grad`` tensors themselves, which saves a copy and the
    memory of a second gradient set.  One launch per group of at most
    ``MAX_LEAVES`` leaves of one dtype."""
    global UNPACK_LAUNCHES
    device = buf.device
    if device.type != "cuda":
        raise ValueError(f"unpack_bucket_kernel takes CUDA tensors, got {device}")
    _check(buf, "buffer", device)
    if buf.dim() != 1:
        raise ValueError(f"buffer must be 1-D, got shape {tuple(buf.shape)}")
    key, ptrs = _key(buf.dtype, outs, device, "output")
    total, groups = bucket_layout(key)
    if total != buf.numel():
        raise ValueError(f"outputs hold {total} elements, buffer {buf.numel()}")
    _launch(_lib().staging_unpack, "unpack_bucket_kernel", groups, ptrs, buf, scale)
    UNPACK_LAUNCHES += len(groups)


def _check_accum(t: torch.Tensor, what: str, name: str, device: torch.device,
                 dtype: torch.dtype, n: int) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype or dtype not in ACCUM_DTYPE_CODES:
        raise ValueError(
            f"{what} has dtype {t.dtype}; {name} takes one of "
            f"{sorted(map(str, ACCUM_DTYPE_CODES))} for all its operands")
    if t.dim() != 1 or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{what} must be 1-D, contiguous, of {n} elements; "
                         f"got {tuple(t.shape)}")


def _launch_accum(pairs: list, dtype: torch.dtype, device: torch.device, name: str) -> None:
    """One launch over ``pairs``, (a, b, out, n) flattened."""
    buf, addr = _accum_table()
    k = len(pairs) // 4
    _ACCUM_ARGS[k].pack_into(buf, 0, k, *pairs)
    rc = _accum_lib().ring_accum_pairs(addr, ACCUM_DTYPE_CODES[dtype], device.index,
                                       _stream(device.index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def ring_accum_kernel(msg: torch.Tensor, chunk: torch.Tensor, *,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """One ring hop's combine: ``msg + chunk`` (1-D, one dtype of f32,
    bf16, f16, contiguous CUDA tensors), written into ``out`` — a new
    tensor by default, or ``msg`` itself."""
    global ACCUM_LAUNCHES
    device = msg.device
    if device.type != "cuda":
        raise ValueError(f"ring_accum_kernel takes CUDA tensors, got {device}")
    if out is None:
        out = torch.empty_like(msg)
    n = msg.numel()
    for what, t in (("msg", msg), ("chunk", chunk), ("out", out)):
        _check_accum(t, what, "ring_accum_kernel", device, msg.dtype, n)
    if n == 0:
        return out
    _launch_accum([msg.data_ptr(), chunk.data_ptr(), out.data_ptr(), n], msg.dtype,
                  device, "ring_accum_kernel")
    ACCUM_LAUNCHES += 1
    return out


def ring_accum_pairs_kernel(msgs: Sequence[torch.Tensor],
                            chunks: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """One ring hop's combine for every direction at once:
    ``msgs[i] += chunks[i]`` in place for 1 to ``MAX_PAIRS`` pairs (each
    1-D and contiguous, all of one dtype of f32, bf16, f16, on one card),
    in one launch; returns ``msgs``.  Empty pairs are skipped."""
    global ACCUM_LAUNCHES
    name = "ring_accum_pairs_kernel"
    if len(msgs) != len(chunks) or not 1 <= len(msgs) <= MAX_PAIRS:
        raise ValueError(f"{name} takes 1 to {MAX_PAIRS} pairs, got {len(msgs)} "
                         f"messages and {len(chunks)} chunks")
    device, dtype = msgs[0].device, msgs[0].dtype
    if device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {device}")
    if dtype not in ACCUM_DTYPE_CODES:
        _check_accum(msgs[0], "msgs[0]", name, device, dtype, 0)
    pairs = []
    for m, c in zip(msgs, chunks):
        n = m.numel()
        if (m.device != device or c.device != device or m.dtype != dtype
                or c.dtype != dtype or m.dim() != 1 or c.dim() != 1
                or c.numel() != n or not m.is_contiguous() or not c.is_contiguous()):
            for i, (m_i, c_i) in enumerate(zip(msgs, chunks)):   # raises
                _check_accum(m_i, f"msgs[{i}]", name, device, dtype, m_i.numel())
                _check_accum(c_i, f"chunks[{i}]", name, device, dtype, m_i.numel())
        if n:
            p = m.data_ptr()
            pairs += (p, c.data_ptr(), p, n)      # in place
    if pairs:
        _launch_accum(pairs, dtype, device, name)
        ACCUM_LAUNCHES += 1
    return msgs
