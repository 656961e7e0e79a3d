"""Build and binding of the Hopper flash-attention forward kernel
(``csrc/flash_attention.cu``).

``flash_attention_fwd`` is the CUDA counterpart of
``repro/kernels/flash_attention/kernel.py``'s Pallas kernel of the same
name; ``csrc/flash_attention.cu`` says what it replaces, what bounds it
and how it is laid out.  It takes the GQA layout of ``ops.py`` directly
— q ``(B, S, Hq, D)``, k/v ``(B, S, Hkv, D)``, read through their
strides — so neither the kv-head repeat nor the transposes of the JAX
wrapper happen here.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use (``kernels/_build.py``)
and loaded with ``ctypes``.  Nothing here runs when the module is
imported.  The wrapper takes CUDA tensors only, checks them and raises
on anything the kernel does not take, launches on the current stream,
never synchronizes, and counts its launches in ``FLASH_LAUNCHES``.
There is no fallback: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

FLASH_LAUNCHES = 0

HEAD_DIMS = (16, 64, 128, 256)         # instantiated in csrc/flash_attention.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535                    # q heads (grid y) and batch (grid z)

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)


def build() -> Path:
    """Compile the kernel unless this source is built; return the
    library's path."""
    return _build.build("flash_attention", _SOURCES)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fn = lib.flash_attention_fwd
    i64p = ctypes.POINTER(ctypes.c_int64)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p,                                     # o
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, S, Hq
        ctypes.c_int, ctypes.c_int,                          # Hkv, D
        i64p, i64p, i64p,                                    # (b, s, h) strides
        ctypes.c_int,                                        # dtype code
        ctypes.c_int,                                        # causal
        ctypes.c_float,                                      # scale
        ctypes.c_int,                                        # device index
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return lib


def _strides(t: torch.Tensor, what: str):
    if t.stride(3) != 1:
        raise ValueError(f"{what}: the head dim must be contiguous, "
                         f"strides {t.stride()}")
    return (ctypes.c_int64 * 3)(t.stride(0), t.stride(1), t.stride(2))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, S, Hkv, D) CUDA tensors of one dtype
    (f32 or bf16) → (B, S, Hq, D) contiguous, in q's dtype."""
    global FLASH_LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd takes CUDA tensors, got {q.device}")
    for t, what in ((k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"{what} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{what} has dtype {t.dtype}, q {q.dtype}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention_fwd takes {sorted(map(str, DTYPE_CODES))}, "
                         f"got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B, S, H, D) each")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, D) or Hq % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not built; the kernel takes {HEAD_DIMS}")
    if B > MAX_GRID_YZ or Hq > MAX_GRID_YZ:
        raise ValueError(f"batch {B} or q heads {Hq} above {MAX_GRID_YZ}")
    o = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S, Hq, Hkv, D, _strides(q, "q"), _strides(k, "k"), _strides(v, "v"),
        DTYPE_CODES[q.dtype], int(causal), 1.0 / (D ** 0.5), q.device.index,
        stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {rc}")
    FLASH_LAUNCHES += 1
    return o
