"""Build and binding of the Hopper flash-attention forward kernels.

``flash_attention_fwd`` is the CUDA counterpart of
``repro/kernels/flash_attention/kernel.py``'s Pallas kernel of the same
name.  It dispatches by dtype, explicitly:

- bf16 goes to the tensor-core kernel (``csrc/flash_attention_tc.cu``:
  TMA loads, ``wgmma`` for Q·Kᵀ and P·V, P carried as two bf16 parts);
- f32 goes to the CUDA-core kernel (``csrc/flash_attention.cu``), which
  keeps the TPU kernel's f32 arithmetic;
- any other dtype raises.  Neither kernel stands in for the other.

Each source says what it replaces, what bounds it and how it is laid
out.  Both take the GQA layout of ``ops.py`` directly — q
``(B, S, Hq, D)``, k/v ``(B, S, Hkv, D)``, read through their strides —
so neither the kv-head repeat nor the transposes of the JAX wrapper
happen here.  The tensor-core kernel reads through TMA tensor maps, so
its base pointers and strides must be 16-byte aligned.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use (``kernels/_build.py``)
and loaded with ``ctypes``.  Nothing here runs when the module is
imported, and every check of dtype, shape and stride runs before a
build.  The wrapper takes CUDA tensors only, raises on anything the
kernel does not take, launches on the current stream, never
synchronizes, allocates nothing but the output, and counts its launches
in ``FLASH_LAUNCHES``.  There is no fallback: a failed build or launch
raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

FLASH_LAUNCHES = 0

HEAD_DIMS = (16, 64, 128, 256)         # instantiated in both sources
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_YZ = 65535                    # grid y and z
BLOCK_Q = 64                           # q rows per block, both kernels
TMA_ALIGN = 16                         # bytes: TMA base and stride alignment

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = (_CSRC / "flash_attention.cu",)
_TC_SOURCES = (_CSRC / "flash_attention_tc.cu",)


def build() -> Path:
    """Compile the f32 (CUDA-core) kernel unless this source is built;
    return the library's path."""
    return _build.build("flash_attention", _SOURCES)


def build_tc() -> Path:
    """Compile the bf16 (tensor-core) kernel unless this source is built;
    return the library's path."""
    return _build.build("flash_attention_tc", _TC_SOURCES)


def _bind(lib_path: Path, name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    i64p = ctypes.POINTER(ctypes.c_int64)
    fn = getattr(lib, name)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p,                                     # o
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, S, Hq
        ctypes.c_int, ctypes.c_int,                          # Hkv, D
        i64p, i64p, i64p,                                    # (b, s, h) strides
        ctypes.c_int,                                        # causal
        ctypes.c_float,                                      # scale
        ctypes.c_int,                                        # device index
        ctypes.c_void_p,                                     # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _f32_fn():
    return _bind(build(), "flash_attention_fwd")


@functools.cache
def _bf16_fn():
    return _bind(build_tc(), "flash_attention_tc_fwd")


def _strides(t: torch.Tensor, what: str, tma: bool):
    """(b, s, h) element strides for the kernel.  A dim of size 1 is
    never stepped, so its stride is given as D.  For TMA (bf16, 2-byte
    elements) the base pointer and every stride must be 16-byte
    aligned."""
    shape, st = t.shape, t.stride()
    if st[3] != 1:
        raise ValueError(f"{what}: the head dim must be contiguous, strides {st}")
    D = shape[3]
    b = st[0] if shape[0] > 1 else D
    s = st[1] if shape[1] > 1 else D
    h = st[2] if shape[2] > 1 else D
    if tma and (t.data_ptr() % TMA_ALIGN or (b | s | h) % (TMA_ALIGN // 2)):
        raise ValueError(
            f"{what}: the tensor-core kernel loads through TMA, which needs "
            f"a {TMA_ALIGN}-byte-aligned base and strides; got address "
            f"{t.data_ptr():#x}, strides {st} of 2-byte elements")
    return (ctypes.c_int64 * 3)(b, s, h)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, S, Hkv, D) CUDA tensors of one dtype
    (bf16: tensor-core kernel; f32: CUDA-core kernel) → (B, S, Hq, D)
    contiguous, in q's dtype."""
    global FLASH_LAUNCHES
    dev, dt = q.device, q.dtype
    for t, what in ((k, "k"), (v, "v")):
        if t.device != dev:
            raise ValueError(f"{what} is on {t.device}, q on {dev}")
        if t.dtype != dt:
            raise ValueError(f"{what} has dtype {t.dtype}, q {dt}")
    if dt not in DTYPES:
        raise ValueError(f"flash_attention_fwd takes {sorted(map(str, DTYPES))}, got {dt}")
    shape, kshape = q.shape, k.shape
    if len(shape) != 4 or len(kshape) != 4 or kshape != v.shape:
        raise ValueError(f"shapes q {tuple(shape)}, k {tuple(kshape)}, "
                         f"v {tuple(v.shape)}: want (B, S, H, D) each")
    B, S, Hq, D = shape
    Hkv = kshape[2]
    if kshape[0] != B or kshape[1] != S or kshape[3] != D or Hq % Hkv:
        raise ValueError(f"k/v {tuple(kshape)} do not fit q {tuple(shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not built; the kernels take {HEAD_DIMS}")
    tc = dt == torch.bfloat16
    # grid: f32 (q tiles, Hq, B); bf16 (Hq, B, q tiles)
    yz = (B, -(-S // BLOCK_Q)) if tc else (Hq, B)
    if max(yz) > MAX_GRID_YZ:
        raise ValueError(f"grid y/z {yz} above {MAX_GRID_YZ}")
    qs, ks, vs = _strides(q, "q", tc), _strides(k, "k", tc), _strides(v, "v", tc)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_fwd takes CUDA tensors, got {dev}")
    o = torch.empty((B, S, Hq, D), dtype=dt, device=dev)
    if o.numel() == 0:
        return o
    fn = _bf16_fn() if tc else _f32_fn()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, Hq, Hkv, D, qs, ks, vs, int(causal), 1.0 / (D ** 0.5),
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd ({'bf16 tensor-core' if tc else 'f32'} "
                           f"kernel) launch failed: error {rc}")
    FLASH_LAUNCHES += 1
    return o
