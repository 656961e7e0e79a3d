"""Build and binding of the Hopper int8 block kernels (``csrc/quantize.cu``).

``quantize_blocks_kernel``/``dequantize_blocks_kernel`` are the CUDA
counterparts of ``repro/kernels/quantize/kernel.py``'s Pallas kernels of
the same names; ``csrc/quantize.cu`` says what they replace, what bounds
them and how they are laid out.  Like the TPU kernels they take f32 only.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use (``kernels/_build.py``)
and loaded with ``ctypes``.  Nothing here runs when the module is
imported.  The wrappers take contiguous, 16-byte aligned CUDA tensors
only, check them and raise on anything else, launch on the current
stream, never synchronize, and count their launches in
``QUANTIZE_LAUNCHES``/``DEQUANTIZE_LAUNCHES``.  There is no fallback: a
failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

QUANTIZE_LAUNCHES = 0
DEQUANTIZE_LAUNCHES = 0

BLOCK = 256      # kBlock in csrc/quantize.cu

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "quantize.cu",)


def build() -> Path:
    """Compile the kernels unless this source is built; return the
    library's path."""
    return _build.build("quantize", _SOURCES)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for fn in (lib.quantize_blocks, lib.dequantize_blocks):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # in, in/out, out
            ctypes.c_int64,                                     # blocks
            ctypes.c_int,                                       # device index
            ctypes.c_void_p,                                    # cudaStream_t
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{what} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} is not contiguous and 16-byte aligned")


def _blocks(t: torch.Tensor, what: str) -> int:
    if t.dim() != 2 or t.shape[1] != BLOCK or t.shape[0] < 1:
        raise ValueError(f"{what} must be (n_blocks >= 1, {BLOCK}), got "
                         f"{tuple(t.shape)}")
    return t.shape[0]


def quantize_blocks_kernel(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n_blocks, 256) f32 → (q int8 (n_blocks, 256), scales (n_blocks,))."""
    global QUANTIZE_LAUNCHES
    n = _blocks(x, "x")
    _check(x, "x", torch.float32, (n, BLOCK), x.device)
    q = torch.empty((n, BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty(n, dtype=torch.float32, device=x.device)
    rc = _lib().quantize_blocks(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), n, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize_blocks_kernel launch failed: CUDA error {rc}")
    QUANTIZE_LAUNCHES += 1
    return q, s


def dequantize_blocks_kernel(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q: (n_blocks, 256) int8, s: (n_blocks,) f32 → (n_blocks, 256) f32."""
    global DEQUANTIZE_LAUNCHES
    n = _blocks(q, "q")
    _check(q, "q", torch.int8, (n, BLOCK), q.device)
    _check(s, "scales", torch.float32, (n,), q.device)
    x = torch.empty((n, BLOCK), dtype=torch.float32, device=q.device)
    rc = _lib().dequantize_blocks(
        q.data_ptr(), s.data_ptr(), x.data_ptr(), n, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequantize_blocks_kernel launch failed: CUDA error {rc}")
    DEQUANTIZE_LAUNCHES += 1
    return x
