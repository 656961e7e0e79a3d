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

