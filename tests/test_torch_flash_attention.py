"""The port's flash attention against the JAX package's.

On CPU tensors ``ops.flash_attention`` runs the plain version
(``ref.py``); it is held against the Pallas kernel run in interpret mode,
as the JAX package's own tests run it, at the shapes of
``tests/test_kernels.py`` and its tolerances (2e-5 in f32, 2e-2 in
bf16).  The Pallas kernel asserts S % 128 == 0 or S ≤ 128, so the ragged
lengths the port's serving buckets reach are held against ``ref.py``'s
own ``attention_ref`` instead.  The CUDA kernel is held against the plain
version by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.utils.convert import tensor_from_numpy

SHAPES = [   # tests/test_kernels.py
    (2, 128, 4, 2, 64, "float32", True),
    (1, 256, 2, 2, 128, "float32", False),
    (2, 128, 4, 1, 64, "bfloat16", True),
    (1, 512, 8, 4, 64, "float32", True),
    (2, 128, 2, 2, 256, "bfloat16", False),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(B, S, Hq, Hkv, D, dtype, seed=0):
    """The same values on both sides: f32 normals rounded once by JAX to
    ``dtype``, carried over bit for bit."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal((B, S, h, D)), jnp.float32).astype(dtype)
          for h in (Hq, Hkv, Hkv)]
    return js, [tensor_from_numpy(np.asarray(j)) for j in js]


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,dtype,causal", SHAPES)
def test_flash_attention_matches_pallas_interpret(B, S, Hq, Hkv, D, dtype, causal):
    (jq, jk, jv), (q, k, v) = _qkv(B, S, Hq, Hkv, D, dtype)
    want = ref_flash(jq, jk, jv, causal=causal, interpret=True)
    before = kernel.FLASH_LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal)
    assert kernel.FLASH_LAUNCHES == before          # CPU: the plain version
    assert got.dtype == q.dtype and got.shape == (B, S, Hq, D)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("S,causal", [(200, True), (77, False), (1, True)])
def test_flash_attention_ragged_matches_attention_ref(S, causal):
    B, Hq, Hkv, D = 2, 4, 2, 16
    _, (q, k, v) = _qkv(B, S, Hq, Hkv, D, "float32", seed=1)
    got = ops.flash_attention(q, k, v, causal=causal)
    kr = k.repeat_interleave(2, dim=2).transpose(1, 2).reshape(B * Hq, S, D)
    vr = v.repeat_interleave(2, dim=2).transpose(1, 2).reshape(B * Hq, S, D)
    qr = q.transpose(1, 2).reshape(B * Hq, S, D)
    want = ref.attention_ref(qr, kr, vr, causal=causal)
    want = want.reshape(B, Hq, S, D).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_flash_attention_rejects_mixed_devices():
    t = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="devices"):
        ops.flash_attention(t, t.to("meta"), t)


def test_kernel_wrapper_takes_cuda_tensors_only():
    t = torch.zeros(1, 64, 2, 16)
    before = kernel.FLASH_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_fwd(t, t, t)
    assert kernel.FLASH_LAUNCHES == before



def _no_build(monkeypatch):
    """Make any kernel build fail loudly: what follows must not reach one."""
    from repro_torch.kernels import _build

    def refuse(*a, **kw):
        raise AssertionError("a kernel build was reached")

    monkeypatch.setattr(_build, "build", refuse)


def test_bf16_cpu_call_reaches_only_the_plain_version(monkeypatch):
    _no_build(monkeypatch)
    _, (q, k, v) = _qkv(2, 128, 4, 2, 64, "bfloat16", seed=3)
    before = kernel.FLASH_LAUNCHES
    got = ops.flash_attention(q, k, v, causal=True)
    assert kernel.FLASH_LAUNCHES == before
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal=True),
                               atol=0, rtol=0)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,match", [
    ("float16", "takes"),
    ("mixed dtypes", "dtype"),
    ("head dim 32", "head dim 32"),
    ("head dim 32 f32", "head dim 32"),
    ("heads do not group", "do not fit"),
    ("k shape", "do not fit"),
    ("three dims", "want"),
    ("head dim strided", "contiguous"),
    ("misaligned base", "16-byte"),
    ("misaligned stride", "16-byte"),
    ("grid", "grid"),
])
def test_kernel_wrapper_checks_raise_before_any_build(monkeypatch, case, match):
    """The wrapper's dtype, shape and TMA alignment checks run on any
    device, before the device check and before a build."""
    _no_build(monkeypatch)
    q, kv = _bf16(1, 64, 4, 64), _bf16(1, 64, 2, 64)
    args = {
        "float16": lambda: (q.half(), kv.half(), kv.half()),
        "mixed dtypes": lambda: (q, kv.float(), kv),
        "head dim 32": lambda: (_bf16(1, 64, 4, 32), _bf16(1, 64, 2, 32),
                                _bf16(1, 64, 2, 32)),
        "head dim 32 f32": lambda: (_bf16(1, 64, 4, 32).float(), _bf16(1, 64, 2, 32).float(),
                                    _bf16(1, 64, 2, 32).float()),
        "heads do not group": lambda: (q, _bf16(1, 64, 3, 64), _bf16(1, 64, 3, 64)),
        "k shape": lambda: (q, _bf16(1, 32, 2, 64), _bf16(1, 32, 2, 64)),
        "three dims": lambda: (q[0], kv[0], kv[0]),
        "head dim strided": lambda: (_bf16(1, 64, 4, 128)[..., ::2], kv, kv),
        # one element (2 bytes) past a 16-byte-aligned base
        "misaligned base": lambda: (_bf16(1, 64, 4, 65)[..., 1:], kv, kv),
        # rows of 68 elements: 136 bytes, not a multiple of 16
        "misaligned stride": lambda: (_bf16(1, 64, 4, 68)[..., :64],
                                      _bf16(1, 64, 2, 68)[..., :64],
                                      _bf16(1, 64, 2, 68)[..., :64]),
        # batch on grid y, above 65535
        "grid": lambda: (_bf16(65536, 1, 1, 16),) * 3,
    }[case]()
    before = kernel.FLASH_LAUNCHES
    with pytest.raises(ValueError, match=match):
        kernel.flash_attention_fwd(*args)
    assert kernel.FLASH_LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_wrapper_refuses_cpu_tensors_of_either_kernel(monkeypatch, dtype):
    """Valid inputs of both dtypes pass every check, then the wrapper
    refuses the CPU device: it never runs a plain version itself."""
    _no_build(monkeypatch)
    q, kv = torch.zeros(2, 200, 4, 128, dtype=dtype), torch.zeros(2, 200, 2, 128, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_fwd(q, kv, kv)
