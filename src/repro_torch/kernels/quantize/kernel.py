"""Build and binding of the Hopper int8 block kernels (``csrc/quantize.cu``).

``quantize_blocks_kernel``/``dequantize_blocks_kernel`` are the CUDA
counterparts of ``repro/kernels/quantize/kernel.py``'s Pallas kernels of
the same names.  The quantize reads an unpadded buffer as if it were
zero-padded to its block count, so the compressed reducer makes no padded
copy.  Two more entries serve the compressed reducer:
``dequantize_sum_blocks_kernel`` (phase 2: g peers' shards dequantized
and summed in peer order in one pass) and
``dequantize_sum_quantize_blocks_kernel`` (phases 2 and 3: that sum,
quantized where it is made, in one launch a bucket).
``csrc/quantize.cu`` says what they replace, what bounds them and how
they are laid out.  Like the TPU kernels they take f32 only.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use (``kernels/_build.py``)
and loaded with ``ctypes``.  Nothing here runs when the module is
imported.  The wrappers take contiguous CUDA tensors only (int8 and f32
elements 16-byte aligned, scales 4-byte aligned), launch on the current
stream, never synchronize, and count their launches in
``QUANTIZE_LAUNCHES``/``DEQUANTIZE_LAUNCHES``/``DEQUANTIZE_SUM_LAUNCHES``/
``SUM_QUANTIZE_LAUNCHES``.  A launch moves only a few MB, so the launch
path is lean: each tensor is checked by one condition (``_check`` only
words a refusal), the current stream's raw handle is read, and outputs
may be passed in (``out=``, ``q_out=``/``s_out=``).  There is no
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
SUM_QUANTIZE_LAUNCHES = 0

BLOCK = 256      # kBlock in csrc/quantize.cu

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "quantize.cu",)


def build() -> Path:
    """Compile the kernels unless this source is built; return the
    library's path."""
    return _build.build("quantize", _SOURCES)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.quantize_blocks.argtypes = [
        ptr, ptr, ptr,          # x, q, scales
        i64, i64,               # blocks, valid elements
        i32, ptr]               # device index, cudaStream_t
    lib.dequantize_blocks.argtypes = [ptr, ptr, ptr, i64, i32, ptr]
    lib.dequantize_sum_blocks.argtypes = [
        ptr, ptr, ptr,          # q, scales, out
        i64, i32,               # blocks a peer, peers
        i32, ptr]
    lib.dequantize_sum_quantize_blocks.argtypes = [
        ptr, ptr, ptr, ptr,     # q, scales, q2, s2
        i64, i32,               # blocks a peer, peers
        i32, ptr]
    for fn in (lib.quantize_blocks, lib.dequantize_blocks, lib.dequantize_sum_blocks,
               lib.dequantize_sum_quantize_blocks):
        fn.restype = ctypes.c_int
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


def _out(t: torch.Tensor | None, what: str, dtype: torch.dtype, shape: tuple,
         device: torch.device, align: int = 16) -> torch.Tensor:
    """An output: ``t`` checked by one condition, or a new tensor (which
    is contiguous and aligned)."""
    if t is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if not _fits(t, dtype, shape, device, align):
        _check(t, what, dtype, shape, device, align)
    return t


def _cuda(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {t.device}")
    return t.device


def _blocks(t: torch.Tensor, what: str) -> int:
    if t.dim() != 2 or t.shape[1] != BLOCK or t.shape[0] < 1:
        raise ValueError(f"{what} must be (n_blocks >= 1, {BLOCK}), got "
                         f"{tuple(t.shape)}")
    return t.shape[0]


def _peers(q: torch.Tensor, name: str) -> tuple[int, int]:
    if q.dim() != 2 or q.shape[0] < 1 or q.shape[1] < BLOCK or q.shape[1] % BLOCK:
        raise ValueError(f"{name}: q must be (peers >= 1, n_blocks >= 1 times {BLOCK}), "
                         f"got {tuple(q.shape)}")
    return q.shape[0], q.shape[1] // BLOCK


def quantize_blocks_kernel(x: torch.Tensor, *, n_blocks: int | None = None,
                           q_out: torch.Tensor | None = None,
                           s_out: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n,) f32 → (q int8 (n_blocks·256,), scales (n_blocks,)), x read
    as zero-padded to ``n_blocks``·256 elements (default: n rounded up to
    a block), with no padded copy.  New tensors, or ``q_out``/``s_out``."""
    global QUANTIZE_LAUNCHES
    name = "quantize_blocks_kernel"
    device = _cuda(x, name)
    n = x.numel()
    if n_blocks is None:
        n_blocks = -(-n // BLOCK)
    if x.dim() != 1 or n_blocks < 1 or n > n_blocks * BLOCK:
        raise ValueError(f"{name}: x must be 1-D and fit {n_blocks} blocks of {BLOCK}, "
                         f"got {tuple(x.shape)}")
    if not _fits(x, torch.float32, x.shape, device):
        _check(x, "x", torch.float32, tuple(x.shape), device)
    q_out = _out(q_out, "q_out", torch.int8, (n_blocks * BLOCK,), device)
    s_out = _out(s_out, "s_out", torch.float32, (n_blocks,), device, align=4)
    index = device.index
    rc = _lib().quantize_blocks(x.data_ptr(), q_out.data_ptr(), s_out.data_ptr(),
                                n_blocks, n, index,
                                torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    QUANTIZE_LAUNCHES += 1
    return q_out, s_out


def _check_in(q: torch.Tensor, s: torch.Tensor, q_shape: tuple, s_shape: tuple,
              device: torch.device) -> None:
    """q (int8) and s (f32) against their shapes, one condition each."""
    if not (_fits(q, torch.int8, q_shape, device)
            and _fits(s, torch.float32, s_shape, device, align=4)):
        _check(q, "q", torch.int8, q_shape, device)
        _check(s, "scales", torch.float32, s_shape, device, align=4)


def dequantize_blocks_kernel(q: torch.Tensor, s: torch.Tensor, *,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """q: (n_blocks, 256) int8, s: (n_blocks,) f32 → (n_blocks, 256) f32:
    a new tensor, or ``out``."""
    global DEQUANTIZE_LAUNCHES
    name = "dequantize_blocks_kernel"
    n = _blocks(q, "q")
    device = _cuda(q, name)
    out = _out(out, "out", torch.float32, (n, BLOCK), device)
    _check_in(q, s, (n, BLOCK), (n,), device)
    index = device.index
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
    g, k = _peers(q, name)
    device = _cuda(q, name)
    out = _out(out, "out", torch.float32, (k * BLOCK,), device)
    _check_in(q, s, (g, k * BLOCK), (g, k), device)
    index = device.index
    rc = _lib().dequantize_sum_blocks(q.data_ptr(), s.data_ptr(), out.data_ptr(), k, g,
                                      index, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    DEQUANTIZE_SUM_LAUNCHES += 1
    return out


def dequantize_sum_quantize_blocks_kernel(q: torch.Tensor, s: torch.Tensor, *,
                                          q_out: torch.Tensor | None = None,
                                          s_out: torch.Tensor | None = None
                                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The compressed reducer's phases 2 and 3 in one launch: q (g, k·256)
    int8 and s (g, k) f32, row p peer p's shard → (q2 (k·256,) int8,
    s2 (k,) f32), the quantize of ``dequantize_sum_blocks_kernel``'s peer
    sum, bit for bit, without the sum ever reaching device memory; new
    tensors, or ``q_out``/``s_out``.  Any g ≥ 1."""
    global SUM_QUANTIZE_LAUNCHES
    name = "dequantize_sum_quantize_blocks_kernel"
    g, k = _peers(q, name)
    device = _cuda(q, name)
    q_out = _out(q_out, "q_out", torch.int8, (k * BLOCK,), device)
    s_out = _out(s_out, "s_out", torch.float32, (k,), device, align=4)
    _check_in(q, s, (g, k * BLOCK), (g, k), device)
    index = device.index
    rc = _lib().dequantize_sum_quantize_blocks(
        q.data_ptr(), s.data_ptr(), q_out.data_ptr(), s_out.data_ptr(), k, g, index,
        torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    SUM_QUANTIZE_LAUNCHES += 1
    return q_out, s_out
