"""The port's CUDA kernels and engines on the card: the serving slices'
kernels and engines, the staging kernels, the ring-hop combine and int8
block kernels (the quantize of an unpadded buffer, the dequantize's
peer-sum entry and the fused sum-requantize), the
peer-memory ring reduce-scatter/all-gather (2 and 4 rank processes on
``cuda:0``, spawned through ``tests/_torch_mdworker.py::peer_rank``), and
depcha's in-backward sync (2 rank processes,
``tests/_torch_mdworker.py::layer_sync_rank``).

This module imports neither ``jax`` nor ``repro``, so it runs on a
machine with a GPU and no JAX; there ``tests/conftest.py`` (which imports
JAX) is left out:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Without a card every case skips.  ``chip_smoke.py`` checks the same
kernels at the full-width shapes on every run.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.qwen3_1_7b import make_smoke as qwen3_smoke
from repro_torch.configs.rwkv6_7b import make_smoke as rwkv_smoke
from repro_torch.kernels.collectives import kernel as coll_kernel
from repro_torch.kernels.collectives import ref as coll_ref
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.kernels.quantize import kernel as quant_kernel
from repro_torch.kernels.quantize import ops as quant_ops
from repro_torch.kernels.quantize import ref as quant_ref
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import rwkv
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


def _bf16_qkv(cuda, B, S, Hq, Hkv, D, seed=4):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((B, S, h, D)), dtype=torch.float32)
            .to(torch.bfloat16).to(cuda) for h in (Hq, Hkv, Hkv)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", [
    (2, 128, 4, 1, 64, True),       # the bf16 shapes of test_torch_flash_attention.py
    (2, 128, 2, 2, 256, False),
    (1, 200, 16, 8, 128, True),     # S 200, ragged last tile
    (2, 200, 4, 2, 64, False),
    (4, 512, 16, 8, 128, True),     # S 512, Qwen3-1.7B static prefill
    (2, 77, 4, 2, 16, True),        # one per head dim the wrapper builds
    (1, 256, 4, 4, 64, True),
    (1, 192, 4, 2, 128, False),
    (1, 160, 2, 1, 256, True),
    (3, 1, 2, 1, 16, True),         # one row: a box taller than the tensor
])
def test_cuda_tensor_core_kernel_matches_plain(cuda, B, S, Hq, Hkv, D, causal):
    q, k, v = _bf16_qkv(cuda, B, S, Hq, Hkv, D)
    before = kernel.FLASH_LAUNCHES
    got = kernel.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernel.FLASH_LAUNCHES == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["fused qkv", "heads first"])
def test_cuda_tensor_core_kernel_reads_strided_views(cuda, layout):
    B, S, Hq, Hkv, D = 2, 200, 8, 2, 128
    rng = np.random.default_rng(5)
    if layout == "fused qkv":     # one (B, S, Hq + 2 Hkv, D) projection, sliced
        qkv = torch.as_tensor(rng.standard_normal((B, S, Hq + 2 * Hkv, D)),
                              dtype=torch.bfloat16).to(cuda)
        q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    else:                         # (B, H, S, D) tensors seen as (B, S, H, D)
        q, k, v = (torch.as_tensor(rng.standard_normal((B, h, S, D)), dtype=torch.bfloat16)
                   .to(cuda).transpose(1, 2) for h in (Hq, Hkv, Hkv))
    assert not q.is_contiguous()
    got = kernel.flash_attention_fwd(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


@pytest.mark.cuda
def test_cuda_tensor_core_kernel_refuses_a_misaligned_view(cuda):
    base = torch.zeros(1, 64, 4, 72, dtype=torch.bfloat16, device=cuda)
    q = base[..., 1:65]              # 2 bytes past an aligned base
    kv = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=cuda)
    before = kernel.FLASH_LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        kernel.flash_attention_fwd(q, kv, kv)
    assert kernel.FLASH_LAUNCHES == before


@pytest.mark.cuda
def test_cuda_bf16_call_reaches_neither_plain_nor_f32_kernel(cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a bf16 call fell back")

    q, k, v = _bf16_qkv(cuda, 1, 128, 4, 2, 128)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    monkeypatch.setattr(ref, "flash_attention_ref", refuse)
    monkeypatch.setattr(kernel, "_f32_fn", refuse)
    got = ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


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


WKV_TOL = {"float32": 5e-4, "bfloat16": 5e-2}    # tests/test_kernels.py:80


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,H,N,dtype", [
    (2, 32, 4, 64, "float32"),     # tests/test_kernels.py
    (1, 64, 2, 64, "float32"),
    (2, 16, 8, 64, "bfloat16"),
    (4, 32, 64, 64, "float32"),    # RWKV-6 7B prefill chunk
    (4, 1, 64, 64, "float32"),     # its decode step
    (1, 7, 64, 64, "float32"),     # a short prompt
    (2, 16, 4, 16, "float32"),     # the smoke config
])
def test_cuda_wkv_kernel_matches_plain(cuda, B, C, H, N, dtype):
    rng = np.random.default_rng(3)

    def normal(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32).to(cuda)

    r, k, v = (normal(B, C, H, N).to(getattr(torch, dtype)) for _ in range(3))
    logw = -torch.exp(normal(B, C, H, N) * 0.5 - 2.0)
    u, state = normal(H, N, scale=0.1), normal(B, H, N, N, scale=0.1)
    before = wkv_kernel.WKV_LAUNCHES
    y, s1 = wkv_ops.wkv_chunk(r, k, v, logw, u, state)
    torch.cuda.synchronize()
    assert wkv_kernel.WKV_LAUNCHES == before + 1

    def rows(t):
        return t.transpose(1, 2).reshape(B * H, C, N)

    y_want, s_want = wkv_ref.wkv_chunk_rows_ref(
        rows(r), rows(k), rows(v), rows(logw), u, state.reshape(B * H, N, N))
    tol = WKV_TOL[dtype]
    torch.testing.assert_close(rows(y), y_want, atol=tol, rtol=tol)
    torch.testing.assert_close(s1.reshape(B * H, N, N), s_want, atol=tol, rtol=tol)


WKV_SEQ_Y_TOL = {"float32": (5e-4, 5e-4), "bfloat16": (5e-4, 2 ** -7)}   # (atol, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,N,chunk,dtype,splits", [
    (4, 512, 64, 64, 32, "bfloat16", None),   # RWKV-6 7B prefill layer
    (4, 512, 64, 64, 32, "float32", None),
    (4, 481, 64, 64, 32, "bfloat16", None),   # a ragged last chunk
    (2, 70, 64, 64, 32, "float32", None),     # 128 rows: 1 column split
    (1, 7, 64, 64, 32, "float32", None),      # below the chunk; 64 rows: 2 splits
    (4, 1, 64, 64, 32, "bfloat16", None),     # a decode step
    (1, 1, 64, 64, 32, "float32", None),
    (1, 130, 2, 64, 64, "float32", None),     # chunks of 64 rows
    (2, 23, 4, 16, 16, "float32", None),      # the smoke config
    (1, 40, 3, 16, 16, "bfloat16", None),
    (2, 100, 8, 64, 32, "bfloat16", 1),       # every split, forced
    (2, 100, 8, 64, 32, "bfloat16", 2),
])
def test_cuda_wkv_sequence_matches_plain(cuda, monkeypatch, B, S, H, N, chunk, dtype,
                                         splits):
    """One launch a layer against the plain version: the state and f32 y
    at 5e-4, bf16 y within one bf16 rounding.  ``splits`` forces the
    column split where the wrapper would pick another."""
    rng = np.random.default_rng(4)

    def normal(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32).to(cuda)

    r, k, v = (normal(B, S, H, N).to(getattr(torch, dtype)) for _ in range(3))
    logw = -torch.exp(normal(B, S, H, N) * 0.5 - 2.0)
    u, state = normal(H, N, scale=0.1), normal(B, H, N, N, scale=0.1)
    if splits is not None:
        monkeypatch.setattr(wkv_kernel, "choose_splits", lambda rows, n, c, sms: splits)
    before = wkv_kernel.WKV_LAUNCHES
    y, s1 = wkv_ops.wkv_sequence(r, k, v, logw, u, state, chunk)
    torch.cuda.synchronize()
    assert wkv_kernel.WKV_LAUNCHES == before + 1
    assert y.dtype == r.dtype and s1.dtype == torch.float32
    y_want, s_want = wkv_ref.wkv_sequence_ref(r, k, v, logw, u, state, chunk)
    atol, rtol = WKV_SEQ_Y_TOL[dtype]
    torch.testing.assert_close(y.float(), y_want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(s1, s_want, atol=5e-4, rtol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,splits", [(4, None), (1, None), (2, 2)])
def test_cuda_wkv_sequence_updates_the_state_in_place(cuda, monkeypatch, B, splits):
    """``out=state``: the kernel writes the final state over its input
    state (each block reads its slice before it writes it), as the model's
    decode and prefill do, with the values of a new-tensor run."""
    rng = np.random.default_rng(5)
    H, N, S = 64, 64, 37

    def normal(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32).to(cuda)

    r, k, v = (normal(B, S, H, N).to(torch.bfloat16) for _ in range(3))
    logw = -torch.exp(normal(B, S, H, N) * 0.5 - 2.0)
    u, state = normal(H, N, scale=0.1), normal(B, H, N, N, scale=0.1)
    if splits is not None:
        monkeypatch.setattr(wkv_kernel, "choose_splits", lambda rows, n, c, sms: splits)
    y_new, s_new = wkv_ops.wkv_sequence(r, k, v, logw, u, state, 32)
    before = wkv_kernel.WKV_LAUNCHES
    y, s1 = wkv_ops.wkv_sequence(r, k, v, logw, u, state, 32, out=state)
    torch.cuda.synchronize()
    assert wkv_kernel.WKV_LAUNCHES == before + 1 and s1 is state
    assert torch.equal(y, y_new) and torch.equal(s1, s_new)


@pytest.mark.cuda
def test_cuda_rwkv_static_engine_matches_cpu(cuda):
    """The rwkv smoke config with the WKV kernel on the card gives the CPU
    run's greedy tokens through the static engine."""
    cfg = rwkv_smoke()
    params = rwkv.perturb_constant_leaves(rwkv.init_params(cfg, seed=0, device="cpu"))
    prompts = np.random.default_rng(11).integers(1, cfg.vocab, (3, 23)).astype(np.int32)
    outs = {}
    for dev in ("cpu", "cuda"):
        srv = Server(cfg, make_smoke_mesh(1, 1), _to(params, dev), max_len=64)
        before = wkv_kernel.WKV_LAUNCHES
        outs[dev] = srv.generate(prompts, 6)
        launched = wkv_kernel.WKV_LAUNCHES - before
        # one a layer for the prefill, then one a layer per decode step
        assert launched == (0 if dev == "cpu" else cfg.n_layers * (1 + 5))
    np.testing.assert_array_equal(outs["cuda"], outs["cpu"])


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n,offset", [(100, 0), (4096, 0), (131072, 0),
                                      (131071, 1), (294912, 0), (1, 0)])
def test_cuda_ring_accum_matches_plain(cuda, dtype, n, offset):
    """Bit for bit with torch.add, aligned or not, into a new tensor and
    into the received buffer."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    a, b = (torch.randn(n + offset, generator=gen, device=cuda)
            .to(getattr(torch, dtype))[offset:] for _ in range(2))
    want = coll_ref.ring_accum_ref(a, b)
    before = coll_kernel.ACCUM_LAUNCHES
    got = coll_kernel.ring_accum_kernel(a, b)
    inplace = a.clone()
    coll_kernel.ring_accum_kernel(inplace, b, out=inplace)
    torch.cuda.synchronize()
    assert coll_kernel.ACCUM_LAUNCHES == before + 2
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(inplace), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n_pairs", [1, 2, 8])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_ring_accum_pairs_matches_add(cuda, dtype, n_pairs, aligned):
    """One launch a call, in place, bit for bit with torch.add per pair:
    lengths from 1 to 300,000 elements, chunks taken as the rows of a
    bidirectional ring's halves (``x2d[:, h:]`` starts at row · c + h, so
    the misaligned case's chunks are not 16-byte aligned)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(n_pairs)
    lengths = [1, 294912, 4097, 37, 131071, 8, 100, 65536][:n_pairs]
    msgs, chunks = [], []
    for n in lengths:
        off = 0 if aligned else 1 + n % 7
        x = torch.randn(2 * n + off, generator=gen, device=cuda).to(dt)
        chunks.append(x[off:off + n])
        msgs.append(torch.randn(n, generator=gen, device=cuda).to(dt))
    want = [torch.add(m, c) for m, c in zip(msgs, chunks)]
    ptrs = [m.data_ptr() for m in msgs]
    before = coll_kernel.ACCUM_LAUNCHES
    got = coll_kernel.ring_accum_pairs_kernel(msgs, chunks)
    torch.cuda.synchronize()
    assert coll_kernel.ACCUM_LAUNCHES == before + 1
    assert [t.data_ptr() for t in got] == ptrs
    for t, w in zip(got, want):
        assert torch.equal(_bits(t), _bits(w))


STAGING_DTYPES = ("float32", "bfloat16", "float16", "float64")


@pytest.mark.cuda
@pytest.mark.parametrize("comm", STAGING_DTYPES)
@pytest.mark.parametrize("leaf", STAGING_DTYPES)
@pytest.mark.parametrize("scale", [1.0, 0.25, 1.0 / 64])
def test_cuda_unpack_matches_plain(cuda, comm, leaf, scale):
    """Bit for bit with ``ref.leafwise_unpack``: odd leaf sizes put most
    leaves at offsets that are not 16-byte aligned; every output element
    is written (outputs start as NaN); one launch for one leaf dtype."""
    sizes = [5, 1024, 1, 300, 77, 4096, 3, 65536, 2, 9]
    gen = torch.Generator(device=cuda).manual_seed(len(sizes))
    buf = (torch.randn(sum(sizes), generator=gen, device=cuda) * 3).to(getattr(torch, comm))
    dt = getattr(torch, leaf)
    outs = [torch.full((n,), float("nan"), dtype=dt, device=cuda) for n in sizes]
    before = coll_kernel.UNPACK_LAUNCHES
    coll_kernel.unpack_bucket_kernel(buf, outs, scale=scale)
    torch.cuda.synchronize()
    assert coll_kernel.UNPACK_LAUNCHES == before + 1
    for t, w in zip(outs, coll_ref.leafwise_unpack(buf, sizes, [dt] * len(sizes),
                                                   scale=scale)):
        assert torch.equal(_bits(t), _bits(w))


@pytest.mark.cuda
def test_cuda_unpack_reuses_its_layout_for_new_outputs(cuda):
    """Two leaf dtypes, 75 leaves each, so 64 + 11 a dtype: 4 launches.
    The bucket's layout is built once and serves the same outputs again
    and new outputs of the same dtypes and sizes (new pointers, as the
    training loop's ``.grad`` tensors are); every call is right, and
    refusals still raise."""
    built = coll_kernel.LAYOUTS_BUILT
    sizes = [int(n) for n in np.random.default_rng(4).integers(1, 5000, 150)]
    dts = [torch.float32, torch.bfloat16] * 75
    gen = torch.Generator(device=cuda).manual_seed(4)
    buf = torch.randn(sum(sizes), generator=gen, device=cuda)
    want = coll_ref.leafwise_unpack(buf, sizes, dts)
    for _ in range(2):
        outs = [torch.full((n,), float("nan"), dtype=d, device=cuda)
                for n, d in zip(sizes, dts)]
        for _ in range(2):
            before = coll_kernel.UNPACK_LAUNCHES
            coll_kernel.unpack_bucket_kernel(buf, outs)
            torch.cuda.synchronize()
            assert coll_kernel.UNPACK_LAUNCHES == before + 4
            for t, w in zip(outs, want):
                assert torch.equal(_bits(t), _bits(w))
            outs[0].fill_(float("nan"))
    assert coll_kernel.LAYOUTS_BUILT == built + 1
    with pytest.raises(ValueError, match="outputs hold"):
        coll_kernel.unpack_bucket_kernel(buf[1:], outs)
    with pytest.raises(ValueError, match="output 3"):
        coll_kernel.unpack_bucket_kernel(buf, outs[:3] + [outs[3].cpu()] + outs[4:])


@pytest.mark.cuda
@pytest.mark.parametrize("comm", STAGING_DTYPES)
@pytest.mark.parametrize("leaf", STAGING_DTYPES)
@pytest.mark.parametrize("scale", [1.0, 4.0, 64.0])
def test_cuda_pack_matches_plain(cuda, comm, leaf, scale):
    """Bit for bit with ``ref.leafwise_pack``: odd leaf sizes put most
    leaves at offsets that are not 16-byte aligned; every buffer element
    is written (the buffer starts as NaN, through ``out=``); one launch
    for one leaf dtype."""
    sizes = [5, 1024, 1, 300, 77, 4096, 3, 65536, 2, 9]
    gen = torch.Generator(device=cuda).manual_seed(len(sizes) + 1)
    dt = getattr(torch, leaf)
    leaves = [(torch.randn(n, generator=gen, device=cuda) * 3).to(dt) for n in sizes]
    buf = torch.full((sum(sizes),), float("nan"), dtype=getattr(torch, comm), device=cuda)
    before = coll_kernel.PACK_LAUNCHES
    got = coll_kernel.pack_bucket_kernel(leaves, buf.dtype, scale=scale, out=buf)
    torch.cuda.synchronize()
    assert got is buf and coll_kernel.PACK_LAUNCHES == before + 1
    want = coll_ref.leafwise_pack(leaves, buf.dtype, scale=scale)
    assert torch.equal(_bits(buf), _bits(want))


@pytest.mark.cuda
def test_cuda_pack_reuses_its_layout_for_new_leaves(cuda):
    """Two leaf dtypes, 75 leaves each, so 64 + 11 a dtype: 4 launches.
    The bucket's layout is built once and serves the same leaves again
    and new leaves of the same dtypes and sizes (new pointers, as the
    training loop's ``.grad`` tensors are), and the unpack of the same
    bucket; every call is right, and refusals still raise."""
    built = coll_kernel.LAYOUTS_BUILT
    sizes = [int(n) for n in np.random.default_rng(5).integers(1, 5000, 150)]
    dts = [torch.float32, torch.bfloat16] * 75
    gen = torch.Generator(device=cuda).manual_seed(5)
    for _ in range(2):
        leaves = [torch.randn(n, generator=gen, device=cuda).to(d) for n, d in zip(sizes, dts)]
        want = coll_ref.leafwise_pack(leaves, torch.float32)
        for _ in range(2):
            buf = torch.full((sum(sizes),), float("nan"), device=cuda)
            before = coll_kernel.PACK_LAUNCHES
            coll_kernel.pack_bucket_kernel(leaves, torch.float32, out=buf)
            torch.cuda.synchronize()
            assert coll_kernel.PACK_LAUNCHES == before + 4
            assert torch.equal(_bits(buf), _bits(want))
    assert coll_kernel.LAYOUTS_BUILT == built + 1
    coll_kernel.unpack_bucket_kernel(buf, [torch.empty_like(t) for t in leaves])
    assert coll_kernel.LAYOUTS_BUILT == built + 1      # the same layout, the other way
    with pytest.raises(ValueError, match="leaf 3"):
        coll_kernel.pack_bucket_kernel(leaves[:3] + [leaves[3].cpu()] + leaves[4:],
                                       torch.float32)
    with pytest.raises(ValueError, match="out must be"):
        coll_kernel.pack_bucket_kernel(leaves, torch.float32, out=buf[1:])


def _tie_peers(g: int, k: int, scale: float, seed: int) -> np.ndarray:
    """(g, k·256) f32, one row a peer at ``scale`` times a factor of its
    own, each with a zero block and the blocks of exact .5 ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((g, k, 256)) * scale
         * rng.uniform(0.5, 2.0, (g, 1, 1))).astype(np.float32)
    x[:, 0] = 0.0
    x[:, 1] = np.clip(np.arange(-127, 129), None, 126) + 0.5
    x[:, 1, 0] = 127.0
    x[:, 2] = 2 * (np.arange(256) % 254 - 127) + 1
    x[:, 2, 0] = -254.0
    return x.reshape(g, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_cuda_dequantize_sum_matches_plain(cuda, g, scale):
    """The peer-sum entry bit for bit with the plain version (dequantize,
    then the adds in peer order), into an output started as NaN; one
    launch a call."""
    x = torch.from_numpy(_tie_peers(g, 37, scale, seed=g)).to(cuda)
    q, s = quant_kernel.quantize_blocks_kernel(x.reshape(-1))
    q, s = q.view(g, -1), s.view(g, -1)
    out = torch.full((q.shape[1],), float("nan"), device=cuda)
    before = quant_kernel.DEQUANTIZE_SUM_LAUNCHES
    got = quant_kernel.dequantize_sum_blocks_kernel(q, s, out=out)
    via_ops = quant_ops.dequantize_sum_blocks(q.reshape(-1), s.reshape(-1), g)
    torch.cuda.synchronize()
    assert got is out and quant_kernel.DEQUANTIZE_SUM_LAUNCHES == before + 2
    want = quant_ref.dequantize_sum_ref(q, s)
    assert torch.equal(_bits(out), _bits(want))
    assert torch.equal(_bits(via_ops), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [1, 7, 64, 1024, 9216])
def test_cuda_dequantize_matches_plain(cuda, n_blocks):
    """The dequantize alone, bit for bit, into an output started as NaN
    (a flat grid of 16-byte vectors: n_blocks not a multiple of a tile)."""
    rng = np.random.default_rng(n_blocks + 1)
    q = torch.from_numpy(rng.integers(-127, 128, (n_blocks, 256)).astype(np.int8)).to(cuda)
    s = torch.from_numpy(np.exp(rng.normal(0, 3, n_blocks)).astype(np.float32)).to(cuda)
    out = torch.full((n_blocks, 256), float("nan"), device=cuda)
    before = quant_kernel.DEQUANTIZE_LAUNCHES
    quant_kernel.dequantize_blocks_kernel(q, s, out=out)
    torch.cuda.synchronize()
    assert quant_kernel.DEQUANTIZE_LAUNCHES == before + 1
    assert torch.equal(_bits(out), _bits(quant_ref.dequantize_ref(q, s)))


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [1, 7, 64, 1024, 9216])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_cuda_quantize_matches_plain(cuda, n_blocks, scale):
    """q, scales and dequantized values bit for bit, with a zero block and
    blocks of exact .5 ties (scale 1 and 2)."""
    rng = np.random.default_rng(n_blocks)
    x = (rng.standard_normal((n_blocks + 3, 256)) * scale).astype(np.float32)
    x[0] = 0.0
    x[1] = np.clip(np.arange(-127, 129), None, 126) + 0.5
    x[1, 0] = 127.0
    x[2] = 2 * (np.arange(256) % 254 - 127) + 1
    x[2, 0] = -254.0
    xt = torch.from_numpy(x).to(cuda)
    before = (quant_kernel.QUANTIZE_LAUNCHES, quant_kernel.DEQUANTIZE_LAUNCHES)
    q, s = quant_ops.quantize_blocks(xt.reshape(-1))
    d = quant_ops.dequantize_blocks(q, s)
    torch.cuda.synchronize()
    assert (quant_kernel.QUANTIZE_LAUNCHES, quant_kernel.DEQUANTIZE_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    q_p, s_p = quant_ref.quantize_ref(xt)
    assert torch.equal(q.reshape(-1, 256), q_p)
    assert torch.equal(_bits(s), _bits(s_p))
    assert torch.equal(_bits(d), _bits(quant_ref.dequantize_ref(q_p, s_p).reshape(-1)))
    assert s[1].item() == 1.0 and s[2].item() == 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1001, 1024), (1003, 1024), (4196, 5120), (100, 1024),
                                 (1856, 2048), (148992, 149504), (1024, 1024)])
def test_cuda_quantize_of_an_unpadded_buffer_matches_plain(cuda, n, m):
    """Phase 1's quantize reads the buffer as it is (n ragged, n % 4 != 0):
    bit for bit the plain version of the zero-padded buffer, into outputs
    started as poison, with NaN past n in memory; one launch a call."""
    rng = np.random.default_rng(n)
    x = torch.full((n + 64,), float("nan"), device=cuda)
    x[:n] = torch.from_numpy((rng.standard_normal(n) * 10.0 ** (n % 7 - 3))
                             .astype(np.float32)).to(cuda)
    buf = x[:n]
    q = torch.full((m,), 0x7f, dtype=torch.int8, device=cuda)
    s = torch.full((m // 256,), float("nan"), device=cuda)
    before = quant_kernel.QUANTIZE_LAUNCHES
    got = quant_kernel.quantize_blocks_kernel(buf, n_blocks=m // 256, q_out=q, s_out=s)
    via_ops = quant_ops.quantize_blocks(buf, pad_to=m)
    torch.cuda.synchronize()
    assert got[0] is q and got[1] is s and quant_kernel.QUANTIZE_LAUNCHES == before + 2
    q_p, s_p = quant_ref.quantize_ref(quant_ref.zero_padded(buf, m).view(-1, 256))
    for qq, ss in (got, via_ops):
        assert torch.equal(qq, q_p.reshape(-1))
        assert torch.equal(_bits(ss), _bits(s_p))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 4, 8, 9])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_cuda_sum_quantize_matches_plain(cuda, g, scale):
    """The fused sum-requantize bit for bit with the plain version (the
    peer sum, then the quantize) and with the two kernels it replaces,
    into outputs started as poison; exactly one launch a call."""
    x = torch.from_numpy(_tie_peers(g, 37, scale, seed=10 + g)).to(cuda)
    q, s = quant_kernel.quantize_blocks_kernel(x.reshape(-1))
    q, s = q.view(g, -1), s.view(g, -1)
    q2 = torch.full((q.shape[1],), 0x7f, dtype=torch.int8, device=cuda)
    s2 = torch.full((37,), float("nan"), device=cuda)
    before = quant_kernel.SUM_QUANTIZE_LAUNCHES
    got = quant_kernel.dequantize_sum_quantize_blocks_kernel(q, s, q_out=q2, s_out=s2)
    torch.cuda.synchronize()
    assert got[0] is q2 and got[1] is s2
    assert quant_kernel.SUM_QUANTIZE_LAUNCHES == before + 1
    via_ops = quant_ops.dequantize_sum_quantize_blocks(q.reshape(-1), s.reshape(-1), g)
    two_kernels = quant_kernel.quantize_blocks_kernel(
        quant_kernel.dequantize_sum_blocks_kernel(q, s))
    torch.cuda.synchronize()
    assert quant_kernel.SUM_QUANTIZE_LAUNCHES == before + 2
    q_p, s_p = quant_ref.dequantize_sum_quantize_ref(q, s)
    for qq, ss in (got, via_ops, two_kernels):
        assert torch.equal(qq, q_p)
        assert torch.equal(_bits(ss), _bits(s_p))


@pytest.mark.cuda
def test_cuda_int8_entries_refuse_misaligned_or_misshapen_outputs(cuda):
    """A misaligned or wrongly shaped ``q_out``/``s_out``, and a strided,
    misaligned or 2-D buffer to quantize, are refused before any launch."""
    x = torch.randn(1001, device=cuda)
    q, s = quant_kernel.quantize_blocks_kernel(torch.randn(2048, device=cuda))
    q, s = q.view(4, -1), s.view(4, -1)
    qbuf = torch.zeros(1024 + 16, dtype=torch.int8, device=cuda)
    sbuf = torch.zeros(4 + 1, device=cuda)
    before = (quant_kernel.QUANTIZE_LAUNCHES, quant_kernel.SUM_QUANTIZE_LAUNCHES)
    for bad in (dict(q_out=qbuf[1:1025]), dict(q_out=qbuf[:1000]),
                dict(s_out=sbuf[:3]), dict(q_out=qbuf[:1024].view(4, 256))):
        with pytest.raises(ValueError, match="q_out|s_out"):
            quant_kernel.quantize_blocks_kernel(x, n_blocks=4, **bad)
    for bad in (dict(q_out=qbuf[1:513]), dict(q_out=qbuf[:256]), dict(s_out=sbuf[:3])):
        with pytest.raises(ValueError, match="q_out|s_out"):
            quant_kernel.dequantize_sum_quantize_blocks_kernel(q, s, **bad)
    with pytest.raises(ValueError, match="fit"):
        quant_kernel.quantize_blocks_kernel(x, n_blocks=3)
    with pytest.raises(ValueError, match="fit"):
        quant_kernel.quantize_blocks_kernel(torch.randn(4, 256, device=cuda))
    wide = torch.randn(2 * 1024 + 4, device=cuda)
    for buf in (wide[:2048:2], wide[1:1025]):
        with pytest.raises(ValueError, match="contiguous"):
            quant_kernel.quantize_blocks_kernel(buf, n_blocks=4)
        with pytest.raises(ValueError, match="contiguous"):
            quant_ops.quantize_blocks(buf, pad_to=1024)
    assert (quant_kernel.QUANTIZE_LAUNCHES, quant_kernel.SUM_QUANTIZE_LAUNCHES) == before


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _spawn_peers(world: int, case: str, tmp_path) -> list[str]:
    import torch.multiprocessing as mp

    from _torch_mdworker import peer_rank

    mp.spawn(peer_rank, args=(world, str(tmp_path), case), nprocs=world, join=True)
    return [(tmp_path / f"peer_{r}.txt").read_text() for r in range(world)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["check", "wrap"])
@pytest.mark.parametrize("world", [2, 4])
def test_cuda_peer_rings_match_plain(cuda, world, case, tmp_path):
    """Both peer-ring kernels against the plain rings, bit for bit, on a
    ring of 2 and of 4 processes sharing the card; ``wrap``: enough calls
    back to back that every message slot is rewritten three times, with
    the stream waits counted."""
    assert _spawn_peers(world, case, tmp_path) == ["ok"] * world


@pytest.mark.cuda
def test_cuda_peer_ring_wait_that_runs_out_raises(cuda, tmp_path):
    """Rank 0 calls alone: its wait runs out after 2 s and its check raises
    naming the rank, the hop and the chain; its next call raises at once;
    the neighbour's check raises too.  No result is returned."""
    said = _spawn_peers(2, "timeout", tmp_path)
    first, again = said[0].split("\n")
    assert "timed out" in first and "rank 0" in first and "hop 1" in first
    assert "chain 3" in first
    assert "has failed" in again
    assert "rank 0 of the ring" in said[1] and "timed out" in said[1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stage", "order"])
def test_cuda_layer_sync_stages_and_orders_its_collectives(cuda, case, tmp_path):
    """Depcha's in-backward sync on 2 ranks sharing the card: the reduced
    gradients equal the plain backward's summed over the ranks bit for
    bit, one pack and one unpack launch and one collective a layer;
    ``order`` with a sleep before every slot copy and collective and NaN
    slots, so a collective that reads its slot early, or an unpack that
    reads the slot before the collective's result, shows."""
    import torch.multiprocessing as mp

    from _torch_mdworker import layer_sync_rank

    mp.spawn(layer_sync_rank, args=(2, str(tmp_path), case), nprocs=2, join=True)
    assert [(tmp_path / f"sync_{r}.txt").read_text() for r in range(2)] == ["ok"] * 2


# ------------------------------------------------- Inception-BN (ImageNet)

@pytest.mark.cuda
@pytest.mark.parametrize("comm", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_cuda_staging_at_inception_layouts(cuda, comm, scale):
    """Rows 1-2 at the full-width Inception-BN plan's layouts (4 MiB
    buckets: 57 leaves and the head), bit for bit with their plain
    versions; the pack into a buffer started as NaN, the unpack into
    outputs started as NaN (at 1 / scale); one launch each way a bucket."""
    from repro_torch.configs.inception_bn_imagenet import make_config
    from repro_torch.core import make_bucket_plan
    from repro_torch.kernels.collectives import ops as coll_ops
    from repro_torch.models import resnet
    from repro_torch.utils.trees import flatten_with_names

    params = resnet.init_inception(make_config(), device="meta")
    plan = make_bucket_plan(params, resnet.param_specs(params), make_smoke_mesh(1),
                            num_channels=4)
    assert [len(b.leaves) for b in plan.buckets] == [57, 1]
    gen = torch.Generator(device=cuda).manual_seed(23)
    flat = [torch.randn(p.shape, generator=gen, device=cuda)
            for _, p in flatten_with_names(params)[0]]
    dt = getattr(torch, comm)
    for b in plan.buckets:
        leaves = [flat[l.index] for l in b.leaves]
        buf = torch.full((b.size,), float("nan"), dtype=dt, device=cuda)
        before = (coll_kernel.PACK_LAUNCHES, coll_kernel.UNPACK_LAUNCHES)
        coll_kernel.pack_bucket_kernel(leaves, dt, scale=scale, out=buf)
        want = coll_ref.leafwise_pack(leaves, dt, scale=scale)
        outs = list(flat)
        for l in b.leaves:
            outs[l.index] = torch.full(l.shape, float("nan"), device=cuda)
        coll_ops.fused_unpack(b, want, outs, scale=1.0 / scale)
        torch.cuda.synchronize()
        assert (coll_kernel.PACK_LAUNCHES - before[0],
                coll_kernel.UNPACK_LAUNCHES - before[1]) == (1, 1)
        assert torch.equal(_bits(buf), _bits(want))
        pieces = coll_ref.leafwise_unpack(want, [l.size for l in b.leaves],
                                          [torch.float32] * len(b.leaves), scale=1.0 / scale)
        for l, w in zip(b.leaves, pieces):
            assert torch.equal(_bits(outs[l.index].reshape(-1)), _bits(w))


@pytest.mark.cuda
def test_cuda_inception_step_matches_cpu(cuda):
    """One Inception-BN smoke step of depcha on the card (kernels) against
    the CPU (plain versions), from the same weights and batch, TF32 off:
    the loss within rtol 1e-5, the updated params within rtol 1e-4 /
    atol 1e-5 (cuDNN's convolutions sum in another order)."""
    from repro_torch.configs.inception_bn_imagenet import make_smoke
    from repro_torch.core import GradSyncConfig
    from repro_torch.data import ImagePipeline
    from repro_torch.launch.mesh import init_dist, make_dp_mesh
    from repro_torch.models import resnet
    from repro_torch.optim import sgd
    from repro_torch.runtime import make_train_step
    from repro_torch.utils.trees import flatten_with_names

    init_dist("cpu")
    was = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, mesh = make_smoke(), make_dp_mesh()
        out = {}
        for device in ("cpu", "cuda"):
            # drawn anew for each device: the step updates its weights in place
            model = resnet.Inception(cfg, resnet.init_inception(cfg, seed=0, device=device))
            opt = sgd(0.1, momentum=0.9)
            ts = make_train_step(cfg, mesh, GradSyncConfig(strategy="depcha"), opt,
                                 model=model, clip_norm=1.0, device=device)
            params = dict(flatten_with_names(model.params_tree())[0])
            batch = ImagePipeline(cfg.img_size, cfg.num_classes, 8, mesh=mesh,
                                  device=device).batch_at(0)
            before = coll_kernel.PACK_LAUNCHES
            _, _, m = ts.fn(model, opt.init(params), batch, 0)
            out[device] = (m["loss"].item(), {n: p.detach().cpu() for n, p in params.items()},
                           coll_kernel.PACK_LAUNCHES - before)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was
    (l_cpu, p_cpu, k_cpu), (l_gpu, p_gpu, k_gpu) = out["cpu"], out["cuda"]
    assert (k_cpu, k_gpu) == (0, 1)
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    for n, p in p_cpu.items():
        np.testing.assert_allclose(p_gpu[n].numpy(), p.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=n)
