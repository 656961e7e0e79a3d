"""Build and binding of the Hopper int8 block kernels (``csrc/quantize.cu``).

``quantize_blocks_kernel``/``dequantize_blocks_kernel`` are the CUDA
counterparts of ``repro/kernels/quantize/kernel.py``'s Pallas kernels of
the same names; ``dequantize_sum_blocks_kernel`` is the dequantize's
entry for the compressed reducer's phase 2, g peers' shards dequantized
and summed in peer order in one pass.  ``csrc/quantize.cu`` says what
they replace, what bounds them and how they are laid out.  Like the TPU
kernels they take f32 only.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use (``kernels/_build.py``)
and loaded with ``ctypes``.  Nothing here runs when the module is
imported.  The wrappers take contiguous CUDA tensors only (int8 and f32
elements 16-byte aligned), check them and raise on anything else,
launch on the current stream, never synchronize, and count their
launches in ``QUANTIZE_LAUNCHES``/``DEQUANTIZE_LAUNCHES``/
``DEQUANTIZE_SUM_LAUNCHES``.  The dequantize entries check each tensor
by one condition (``_check`` words a refusal) and read the current
stream's raw handle, since a launch moves only a few MB.  There is no
fallback: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

QUANTIZE_LAUNCHES = 0
DEQUANTIZE_LAUNCHES = 0
DEQUANTIZE_SUM_LAUNCHES = 0

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
    lib.dequantize_sum_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # q, scales, out
        ctypes.c_int64, ctypes.c_int,                           # blocks a peer, peers
        ctypes.c_int, ctypes.c_void_p,                          # device index, stream
    ]
    lib.dequantize_sum_blocks.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
           device: torch.device, align: int = 16) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{what} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{what} is not contiguous and {align}-byte aligned")


def _fits(t: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device,
          align: int = 16) -> bool:
    """``_check``'s conditions as one test, for the launch path."""
    return (t.device == device and t.dtype == dtype and t.shape == shape
            and t.is_contiguous() and not t.data_ptr() % align)


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


def _dequantize_out(q: torch.Tensor, s: torch.Tensor, out: torch.Tensor | None,
                    shapes: tuple, name: str) -> tuple[torch.Tensor, int]:
    """Check q (int8), s (f32) and ``out`` (f32; made when None) against
    ``shapes``, one condition each; return ``out`` and the card's index."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got q on {device}")
    q_shape, s_shape, out_shape = shapes
    if out is None:              # a new tensor is contiguous and aligned
        out = q.new_empty(out_shape, dtype=torch.float32)
    elif not _fits(out, torch.float32, out_shape, device):
        _check(out, "out", torch.float32, out_shape, device)
    if not (_fits(q, torch.int8, q_shape, device)
            and _fits(s, torch.float32, s_shape, device, align=4)):
        _check(q, "q", torch.int8, q_shape, device)
        _check(s, "scales", torch.float32, s_shape, device, align=4)
    return out, device.index


def dequantize_blocks_kernel(q: torch.Tensor, s: torch.Tensor, *,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """q: (n_blocks, 256) int8, s: (n_blocks,) f32 → (n_blocks, 256) f32:
    a new tensor, or ``out``."""
    global DEQUANTIZE_LAUNCHES
    name = "dequantize_blocks_kernel"
    n = _blocks(q, "q")
    out, index = _dequantize_out(q, s, out, ((n, BLOCK), (n,), (n, BLOCK)), name)
    rc = _lib().dequantize_blocks(q.data_ptr(), s.data_ptr(), out.data_ptr(), n, index,
                                  torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    DEQUANTIZE_LAUNCHES += 1
    return out


def dequantize_sum_blocks_kernel(q: torch.Tensor, s: torch.Tensor, *,
                                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The compressed reducer's phase 2 in one pass: q (g, k·256) int8
    and s (g, k) f32, row p peer p's shard → (k·256,) f32, ``q[0]·s[0] +
    q[1]·s[1] + … + q[g-1]·s[g-1]`` added in peer order, each product
    and each add rounded once; a new tensor, or ``out``.  Any g ≥ 1."""
    global DEQUANTIZE_SUM_LAUNCHES
    name = "dequantize_sum_blocks_kernel"
    if q.dim() != 2 or q.shape[0] < 1 or q.shape[1] < BLOCK or q.shape[1] % BLOCK:
        raise ValueError(f"{name}: q must be (peers >= 1, n_blocks >= 1 times {BLOCK}), "
                         f"got {tuple(q.shape)}")
    g, k = q.shape[0], q.shape[1] // BLOCK
    out, index = _dequantize_out(q, s, out, ((g, k * BLOCK), (g, k), (k * BLOCK,)), name)
    rc = _lib().dequantize_sum_blocks(q.data_ptr(), s.data_ptr(), out.data_ptr(), k, g,
                                      index, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    DEQUANTIZE_SUM_LAUNCHES += 1
    return out
