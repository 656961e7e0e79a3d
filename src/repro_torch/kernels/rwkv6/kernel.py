"""Build and binding of the Hopper WKV kernel (``csrc/wkv.cu``).

One kernel, two entries.  ``wkv_sequence_kernel`` runs a whole layer's
WKV in one launch — every chunk of the sequence in order, the state
carried across chunks on chip — on the model's ``(B, S, H, N)`` layout:
it takes the place of ``repro/kernels/rwkv6/kernel.py``'s Pallas kernel
and of the scan around it in ``repro/models/rwkv.py::wkv_chunked``.
``wkv_chunk_kernel`` is its one-chunk case on the TPU kernel's flat
layout — r, k, v, logw ``(BH, C, N)`` and the state ``(BH, N, N)`` —
except that u is ``(H, N)``, read by row ``bh % H``, so that the model's
per-head bonus is not broadcast over the batch (the TPU kernel takes it
broadcast, ``(BH, 1, N)``).  ``csrc/wkv.cu`` says what it replaces, what
bounds it and how it is laid out.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use (``kernels/_build.py``)
and loaded with ``ctypes``.  Nothing here runs when the module is
imported.  The wrappers take contiguous, 16-byte aligned CUDA tensors
only, check each by one condition (``_check`` words a refusal), launch
on the current stream, never synchronize, write the new state to a new
tensor (``wkv_sequence_kernel``: or to ``out``, which may be the state
itself), and count their launches in ``WKV_LAUNCHES`` (one a call).
``wkv_sequence_kernel`` cuts the state's columns over ``choose_splits``
blocks a row, picked from the grid's rows and the card's SMs, and
logged.  For training it also writes, when given ``states``, the state
each chunk starts from (``ops._WKVSequence``'s backward recomputes the
chunks from those).  There is no fallback: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
import logging
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

WKV_LAUNCHES = 0

HEAD_SIZES = (16, 64)                  # instantiated in csrc/wkv.cu
MAX_CHUNK = 64
SPLITS = {16: (1,), 64: (1, 2)}       # column splits built, by head size
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # of r, k, v
MAX_GRID_X = 2 ** 31 - 1

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "wkv.cu",)
_log = logging.getLogger(__name__)


def build() -> Path:
    """Compile the kernel unless this source is built; return the
    library's path."""
    return _build.build("wkv", _SOURCES)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptrs = [ctypes.c_void_p] * 8             # r, k, v, logw, u, state, y, s1
    lib.wkv_chunk_fwd.argtypes = ptrs + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # BH, C, N
        ctypes.c_int,                                        # H (rows of u)
        ctypes.c_int,                                        # dtype code
        ctypes.c_int,                                        # device index
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    lib.wkv_seq_fwd.argtypes = ptrs + [
        ctypes.c_void_p,                                          # states or null
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # B, S, H, N
        ctypes.c_int, ctypes.c_int,                               # C, splits
        ctypes.c_int, ctypes.c_int,                               # dtype code, device
        ctypes.c_void_p,                                          # cudaStream_t
    ]
    lib.wkv_chunk_fwd.restype = lib.wkv_seq_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def choose_splits(rows: int, n: int, c: int, sms: int) -> int:
    """Blocks a (b, h) row for ``rows`` rows of head size ``n`` in chunks of
    ``c`` on a card of ``sms`` SMs: the built split whose grid comes
    closest to one block an SM (the smaller on a tie), 1 for chunks above
    32 rows.  Each split recomputes the scores and the decay factors and
    takes narrower tiles, so a split pays only where it fills idle SMs: on
    an H100, RWKV-6 7B's prefill layer ran fastest at 1 split at B 4 (256
    rows) and at 2 at B 1 (64 rows; PERF.md).  Logged once for each
    shape."""
    splits = 1
    if c <= 32:
        splits = min(SPLITS[n], key=lambda s: abs(math.log(rows * s / sms)))
    _log.info("wkv_sequence_kernel: %d rows, N %d, C %d on %d SMs -> %d column "
              "split(s)", rows, n, c, sms, splits)
    return splits


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, r on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} {tuple(t.shape)}: want {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous and 16-byte aligned, strides "
                         f"{t.stride()}")


def _fits(t: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device) -> bool:
    """``_check``'s conditions as one test, for the launch path."""
    return (t.device == device and t.dtype == dtype and t.shape == shape
            and t.is_contiguous() and not t.data_ptr() % 16)


def _check_all(want: dict, device: torch.device) -> None:
    """``want``: name → (tensor, dtype, shape).  One condition each; the
    detailed checks run only to word a refusal."""
    if not all(_fits(t, dtype, shape, device) for t, dtype, shape in want.values()):
        for what, (t, dtype, shape) in want.items():
            _check(t, what, dtype, shape, device)


def _head(r: torch.Tensor, u: torch.Tensor, name: str) -> None:
    if r.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {r.device}")
    if r.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} takes r, k, v in {sorted(map(str, DTYPE_CODES))}, "
                         f"got {r.dtype}")
    if u.dim() != 2 or u.shape[1] not in HEAD_SIZES:
        raise ValueError(f"u {tuple(u.shape)}: want (H, N) with N in {HEAD_SIZES}")


def wkv_sequence_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                        chunk: int, out: torch.Tensor | None = None,
                        states: torch.Tensor | None = None):
    """One layer's WKV in one launch, in chunks of C = min(chunk, S), over
    ``choose_splits`` blocks a (b, h) row.  r, k, v (B, S, H, N) CUDA
    tensors of one dtype (f32 or bf16); logw (B, S, H, N), u (H, N) and
    state (B, H, N, N) in f32; all contiguous and 16-byte aligned.  Returns
    (y (B, S, H, N) in r's dtype, the final state (B, H, N, N) f32): in
    ``out`` where given, which may be ``state`` itself (each block reads
    its slice of the state before it writes it), else in a new tensor.
    ``states``, where given (an f32 tensor of (T, B, H, N, N), T = ⌈S / C⌉
    chunks), gets the state each chunk starts from (the backward's input);
    without it the launch writes no more than before."""
    global WKV_LAUNCHES
    _head(r, u, "wkv_sequence_kernel")
    if r.dim() != 4:
        raise ValueError(f"r {tuple(r.shape)}: want (B, S, H, N)")
    B, S, H, N = r.shape
    device = r.device
    shape = (B, S, H, N)
    _check_all({"r": (r, r.dtype, shape), "k": (k, r.dtype, shape),
                "v": (v, r.dtype, shape), "logw": (logw, torch.float32, shape),
                "u": (u, torch.float32, (H, N)),
                "state": (state, torch.float32, (B, H, N, N)),
                **({} if out is None else
                   {"out": (out, torch.float32, (B, H, N, N))}),
                **({} if states is None else
                   {"states": (states, torch.float32, (-(-S // min(max(chunk, 1), S)),
                                                       B, H, N, N))})}, device)
    if B < 1 or S < 1 or H < 1 or B * H > MAX_GRID_X:
        raise ValueError(f"(B, S, H) = {(B, S, H)}: want B, S, H >= 1 and B·H <= "
                         f"{MAX_GRID_X}")
    if chunk < 1:
        raise ValueError(f"chunk {chunk} < 1")
    C = min(chunk, S)
    if C > MAX_CHUNK:
        raise ValueError(f"chunk length {C} above {MAX_CHUNK}")
    splits = choose_splits(B * H, N, C, _sm_count(device.index))
    y = torch.empty(shape, dtype=r.dtype, device=device)
    s1 = torch.empty((B, H, N, N), dtype=torch.float32, device=device) if out is None else out
    index = device.index
    rc = _lib().wkv_seq_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        state.data_ptr(), y.data_ptr(), s1.data_ptr(),
        None if states is None else states.data_ptr(), B, S, H, N, C, splits,
        DTYPE_CODES[r.dtype], index, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"wkv_seq_fwd launch failed: CUDA error {rc}")
    WKV_LAUNCHES += 1
    return y, s1


def wkv_chunk_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """One chunk: r, k, v (BH, C, N) CUDA tensors of one dtype (f32 or
    bf16); logw (BH, C, N), u (H, N) with H dividing BH, and state (BH, N,
    N) in f32; all contiguous and 16-byte aligned.  Returns (y (BH, C, N)
    f32, new state (BH, N, N) f32)."""
    global WKV_LAUNCHES
    _head(r, u, "wkv_chunk_kernel")
    if r.dim() != 3:
        raise ValueError(f"r {tuple(r.shape)}: want (BH, C, N)")
    BH, C, N = r.shape
    H = u.shape[0]
    device = r.device
    rows = (BH, C, N)
    _check_all({"r": (r, r.dtype, rows), "k": (k, r.dtype, rows),
                "v": (v, r.dtype, rows), "logw": (logw, torch.float32, rows),
                "u": (u, torch.float32, (H, N)),
                "state": (state, torch.float32, (BH, N, N))}, device)
    if not 1 <= C <= MAX_CHUNK:
        raise ValueError(f"chunk length {C} outside 1..{MAX_CHUNK}")
    if H < 1 or BH % H:
        raise ValueError(f"{BH} rows do not cycle over the {H} heads of u")
    if BH > MAX_GRID_X:
        raise ValueError(f"{BH} rows above the grid's {MAX_GRID_X}")
    y = torch.empty(rows, dtype=torch.float32, device=device)
    s1 = torch.empty((BH, N, N), dtype=torch.float32, device=device)
    if BH == 0:
        return y, s1
    index = device.index
    rc = _lib().wkv_chunk_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        state.data_ptr(), y.data_ptr(), s1.data_ptr(), BH, C, N, H,
        DTYPE_CODES[r.dtype], index, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"wkv_chunk_fwd launch failed: CUDA error {rc}")
    WKV_LAUNCHES += 1
    return y, s1
