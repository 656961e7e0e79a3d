"""Build and binding of the Hopper WKV chunk kernel (``csrc/wkv.cu``).

``wkv_chunk_kernel`` is the CUDA counterpart of
``repro/kernels/rwkv6/kernel.py``'s Pallas kernel of the same name;
``csrc/wkv.cu`` says what it replaces, what bounds it and how it is laid
out.  It takes the TPU kernel's flat layout — r, k, v, logw ``(BH, C, N)``
and the state ``(BH, N, N)`` — except that u is ``(H, N)``, read by row
``bh % H``, so that the model's per-head bonus is not broadcast over the
batch (the TPU kernel takes it broadcast, ``(BH, 1, N)``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use (``kernels/_build.py``)
and loaded with ``ctypes``.  Nothing here runs when the module is
imported.  The wrapper takes CUDA tensors only, checks them and raises
on anything the kernel does not take, launches on the current stream,
never synchronizes, and counts its launches in ``WKV_LAUNCHES``.  There
is no fallback: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

WKV_LAUNCHES = 0

HEAD_SIZES = (16, 64)                  # instantiated in csrc/wkv.cu
MAX_CHUNK = 64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # of r, k, v
MAX_GRID_X = 2 ** 31 - 1

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "wkv.cu",)


def build() -> Path:
    """Compile the kernel unless this source is built; return the
    library's path."""
    return _build.build("wkv", _SOURCES)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fn = lib.wkv_chunk_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # r, k, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # logw, u, state
        ctypes.c_void_p, ctypes.c_void_p,                    # y, s1
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # BH, C, N
        ctypes.c_int,                                        # H (rows of u)
        ctypes.c_int,                                        # dtype code
        ctypes.c_int,                                        # device index
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return lib


def wkv_chunk_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """r, k, v (BH, C, N) CUDA tensors of one dtype (f32 or bf16); logw
    (BH, C, N), u (H, N) with H dividing BH, and state (BH, N, N) in f32;
    all contiguous.  Returns (y (BH, C, N) f32, new state (BH, N, N) f32)."""
    global WKV_LAUNCHES
    if r.device.type != "cuda":
        raise ValueError(f"wkv_chunk_kernel takes CUDA tensors, got {r.device}")
    if r.dim() != 3:
        raise ValueError(f"r {tuple(r.shape)}: want (BH, C, N)")
    BH, C, N = r.shape
    if u.dim() != 2:
        raise ValueError(f"u {tuple(u.shape)}: want (H, N)")
    want = {"k": (k, r.dtype, (BH, C, N)), "v": (v, r.dtype, (BH, C, N)),
            "logw": (logw, torch.float32, (BH, C, N)),
            "u": (u, torch.float32, (u.shape[0], N)),
            "state": (state, torch.float32, (BH, N, N))}
    for what, (t, dtype, shape) in want.items():
        if t.device != r.device:
            raise ValueError(f"{what} is on {t.device}, r on {r.device}")
        if t.dtype != dtype:
            raise ValueError(f"{what} has dtype {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} {tuple(t.shape)}: want {shape}")
    for what, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("state", state)):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous, strides {t.stride()}")
    if r.dtype not in DTYPE_CODES:
        raise ValueError(f"wkv_chunk_kernel takes r, k, v in "
                         f"{sorted(map(str, DTYPE_CODES))}, got {r.dtype}")
    if N not in HEAD_SIZES:
        raise ValueError(f"head size {N} not built; the kernel takes {HEAD_SIZES}")
    if not 1 <= C <= MAX_CHUNK:
        raise ValueError(f"chunk length {C} outside 1..{MAX_CHUNK}")
    H = u.shape[0]
    if H < 1 or BH % H:
        raise ValueError(f"{BH} rows do not cycle over the {H} heads of u")
    if BH > MAX_GRID_X:
        raise ValueError(f"{BH} rows above the grid's {MAX_GRID_X}")
    y = torch.empty((BH, C, N), dtype=torch.float32, device=r.device)
    s1 = torch.empty((BH, N, N), dtype=torch.float32, device=r.device)
    if BH == 0:
        return y, s1
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _lib().wkv_chunk_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        state.data_ptr(), y.data_ptr(), s1.data_ptr(), BH, C, N, H,
        DTYPE_CODES[r.dtype], r.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"wkv_chunk_fwd launch failed: CUDA error {rc}")
    WKV_LAUNCHES += 1
    return y, s1
