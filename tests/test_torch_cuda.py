"""The serving slice's CUDA kernel and engines on the card.

This module imports neither ``jax`` nor ``repro``, so it runs on a
machine with a GPU and no JAX; there ``tests/conftest.py`` (which imports
JAX) is left out:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Without a card every case skips.  ``chip_smoke.py`` checks the same
kernel at the full-width shapes on every run.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.qwen3_1_7b import make_smoke as qwen3_smoke
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import transformer as tf
from repro_torch.runtime import ContinuousScheduler, Server

TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # tests/test_kernels.py:34


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,D,dtype,causal", [
    (2, 128, 4, 2, 64, "float32", True),       # tests/test_kernels.py
    (1, 256, 2, 2, 128, "float32", False),
    (2, 128, 4, 1, 64, "bfloat16", True),
    (1, 512, 8, 4, 64, "float32", True),
    (2, 128, 2, 2, 256, "bfloat16", False),
    (4, 512, 16, 8, 128, "bfloat16", True),    # Qwen3-1.7B static prefill
    (1, 200, 16, 8, 128, "bfloat16", True),    # ragged
    (3, 77, 4, 2, 16, "float32", False),
])
def test_cuda_kernel_matches_plain(cuda, B, S, Hq, Hkv, D, dtype, causal):
    rng = np.random.default_rng(2)
    q, k, v = (torch.as_tensor(rng.standard_normal((B, S, h, D)), dtype=torch.float32)
               .to(getattr(torch, dtype)).to(cuda) for h in (Hq, Hkv, Hkv))
    before = kernel.FLASH_LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernel.FLASH_LAUNCHES == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
def test_cuda_engines_match_cpu(cuda):
    """The qwen3 smoke config with the flash kernel on the card gives the
    CPU run's greedy tokens through both engines."""
    cfg = dataclasses.replace(qwen3_smoke(), use_flash=True)
    params = tf.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, cfg.vocab, size=int(L)).astype(np.int32)
               for L in rng.integers(3, 20, size=4)]
    outs = {}
    for dev in ("cpu", "cuda"):
        srv = Server(cfg, make_smoke_mesh(1, 1), _to(params, dev), max_len=64)
        before = kernel.FLASH_LAUNCHES
        eng = ContinuousScheduler(srv, slots=4, block_size=16, chunk=4)
        outs[dev] = (eng.generate_batch(prompts, 6),
                     [srv.generate(p[None], 6)[0] for p in prompts])
        launched = kernel.FLASH_LAUNCHES - before
        assert launched == (0 if dev == "cpu" else 2 * cfg.n_layers * len(prompts))
    for a, b in zip(outs["cpu"][0] + outs["cpu"][1], outs["cuda"][0] + outs["cuda"][1]):
        np.testing.assert_array_equal(b, a)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
