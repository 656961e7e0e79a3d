"""Build and binding of the Hopper collectives kernels: the staging
kernels (``csrc/staging.cu``) and the ring-hop combine
(``csrc/ring_accum.cu``).

``pack_bucket_kernel``/``unpack_bucket_kernel``/``ring_accum_kernel``
are the CUDA counterparts of ``repro/kernels/collectives/kernel.py``'s
Pallas kernels of the same names; each source says what it replaces,
what bounds it and how it is laid out.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use (``kernels/_build.py``)
and loaded with ``ctypes``.  Nothing here runs when the module is
imported.

The wrappers take CUDA tensors only: they check device, dtype, size and
contiguity and raise on anything else, launch on the current stream,
never synchronize, and count their launches in ``PACK_LAUNCHES`` /
``UNPACK_LAUNCHES`` / ``ACCUM_LAUNCHES``.  There is no fallback: a
failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Iterator, Sequence

import torch

from repro_torch.kernels import _build

PACK_LAUNCHES = 0
UNPACK_LAUNCHES = 0
ACCUM_LAUNCHES = 0

MAX_LEAVES = 64   # kMaxLeaves in csrc/staging.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float64: 3}

ACCUM_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = (_CSRC / "staging.cu",)
_ACCUM_SOURCES = (_CSRC / "ring_accum.cu",)


def build() -> Path:
    """Compile the staging kernels unless this source is built; return
    the library's path."""
    return _build.build("staging", _SOURCES)


def build_ring_accum() -> Path:
    """Compile the ring-hop combine unless this source is built; return
    the library's path."""
    return _build.build("ring_accum", _ACCUM_SOURCES)


@functools.cache
def _accum_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_ring_accum()))
    lib.ring_accum.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # msg, chunk, out
        ctypes.c_int64,                                      # elements
        ctypes.c_int,                                        # dtype code
        ctypes.c_int,                                        # device index
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    lib.ring_accum.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for fn in (lib.staging_pack, lib.staging_unpack):
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),   # leaf pointers
            ctypes.POINTER(ctypes.c_int64),    # offsets in the buffer
            ctypes.POINTER(ctypes.c_int64),    # sizes
            ctypes.c_int,                      # number of leaves
            ctypes.c_int,                      # leaf dtype code
            ctypes.c_void_p,                   # comm buffer
            ctypes.c_int,                      # comm dtype code
            ctypes.c_float,                    # scale
            ctypes.c_int,                      # scale != 1
            ctypes.c_int,                      # device index
            ctypes.c_void_p,                   # cudaStream_t
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


def _launch_groups(leaves: Sequence[torch.Tensor], offsets: Sequence[int]
                   ) -> Iterator[tuple[torch.dtype, list, list]]:
    """(dtype, leaves, offsets) per launch: leaves grouped by dtype (the
    kernel's template parameter), at most MAX_LEAVES per launch; empty
    leaves need no launch."""
    by_dtype: dict[torch.dtype, list[tuple[torch.Tensor, int]]] = {}
    for t, off in zip(leaves, offsets):
        if t.numel():
            by_dtype.setdefault(t.dtype, []).append((t, off))
    for dt, items in by_dtype.items():
        for i in range(0, len(items), MAX_LEAVES):
            chunk = items[i:i + MAX_LEAVES]
            yield dt, [t for t, _ in chunk], [o for _, o in chunk]


def _stage(fn, name: str, leaves, offsets, buf: torch.Tensor,
           scale: float) -> int:
    """Launch ``fn`` once per group; returns the number of launches."""
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    launches = 0
    for dt, ts, offs in _launch_groups(leaves, offsets):
        n = len(ts)
        rc = fn((ctypes.c_void_p * n)(*[t.data_ptr() for t in ts]),
                (ctypes.c_int64 * n)(*offs),
                (ctypes.c_int64 * n)(*[t.numel() for t in ts]),
                n, DTYPE_CODES[dt], buf.data_ptr(), DTYPE_CODES[buf.dtype],
                float(scale), int(scale != 1.0), buf.device.index, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
        launches += 1
    return launches


def pack_bucket_kernel(leaves: Sequence[torch.Tensor], comm_dtype, *,
                       scale: float = 1.0) -> torch.Tensor:
    """Leaves (contiguous CUDA tensors, any shapes) → one 1-D
    ``comm_dtype`` buffer holding them back to back, times ``scale``."""
    global PACK_LAUNCHES
    if not leaves:
        raise ValueError("pack_bucket_kernel needs at least one leaf")
    device = leaves[0].device
    if device.type != "cuda":
        raise ValueError(f"pack_bucket_kernel takes CUDA tensors, got {device}")
    for i, t in enumerate(leaves):
        _check(t, f"leaf {i}", device)
    if comm_dtype not in DTYPE_CODES:
        raise ValueError(f"comm dtype {comm_dtype} is not supported")
    offsets, off = [], 0
    for t in leaves:
        offsets.append(off)
        off += t.numel()
    buf = torch.empty(off, dtype=comm_dtype, device=device)
    PACK_LAUNCHES += _stage(_lib().staging_pack, "pack_bucket_kernel",
                            leaves, offsets, buf, scale)
    return buf


def unpack_bucket_kernel(buf: torch.Tensor, outs: Sequence[torch.Tensor], *,
                         scale: float = 1.0) -> None:
    """Inverse of ``pack_bucket_kernel``: write ``buf``'s consecutive
    slices, times ``scale`` and cast to each output's dtype, into
    ``outs``.  The outputs are written in place — on the training path
    they are the ``.grad`` tensors themselves, which saves a copy and the
    memory of a second gradient set."""
    global UNPACK_LAUNCHES
    device = buf.device
    if device.type != "cuda":
        raise ValueError(f"unpack_bucket_kernel takes CUDA tensors, got {device}")
    _check(buf, "buffer", device)
    if buf.dim() != 1:
        raise ValueError(f"buffer must be 1-D, got shape {tuple(buf.shape)}")
    offsets, off = [], 0
    for i, t in enumerate(outs):
        _check(t, f"output {i}", device)
        offsets.append(off)
        off += t.numel()
    if off != buf.numel():
        raise ValueError(f"outputs hold {off} elements, buffer {buf.numel()}")
    UNPACK_LAUNCHES += _stage(_lib().staging_unpack, "unpack_bucket_kernel",
                              outs, offsets, buf, scale)


def ring_accum_kernel(msg: torch.Tensor, chunk: torch.Tensor, *,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """One ring hop's combine: ``msg + chunk`` (1-D, one dtype of f32,
    bf16, f16, contiguous CUDA tensors), written into ``out`` — a new
    tensor by default; the ring passes the received buffer ``msg``."""
    global ACCUM_LAUNCHES
    device = msg.device
    if device.type != "cuda":
        raise ValueError(f"ring_accum_kernel takes CUDA tensors, got {device}")
    if out is None:
        out = torch.empty_like(msg)
    for what, t in (("msg", msg), ("chunk", chunk), ("out", out)):
        if t.device != device:
            raise ValueError(f"{what} is on {t.device}, expected {device}")
        if t.dtype != msg.dtype or t.dtype not in ACCUM_DTYPE_CODES:
            raise ValueError(
                f"{what} has dtype {t.dtype}; ring_accum_kernel takes one of "
                f"{sorted(map(str, ACCUM_DTYPE_CODES))} for all three")
        if t.dim() != 1 or t.numel() != msg.numel() or not t.is_contiguous():
            raise ValueError(f"{what} must be 1-D, contiguous, of "
                             f"{msg.numel()} elements; got {tuple(t.shape)}")
    if msg.numel() == 0:
        return out
    rc = _accum_lib().ring_accum(
        msg.data_ptr(), chunk.data_ptr(), out.data_ptr(), msg.numel(),
        ACCUM_DTYPE_CODES[msg.dtype], device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ring_accum_kernel launch failed: CUDA error {rc}")
    ACCUM_LAUNCHES += 1
    return out
