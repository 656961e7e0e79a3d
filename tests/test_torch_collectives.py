"""The port's staging against the JAX package's Pallas staging kernels.

``leafwise_pack``/``leafwise_unpack`` (the plain versions the CUDA kernels
are held against on the card, and what ``fused_pack``/``fused_unpack``
run on CPU tensors) must agree BIT-exactly with ``pack_bucket_kernel`` /
``unpack_bucket_kernel`` run in interpret mode, as the JAX package's own
tests run them: a copy, a cast and one f32 multiply round the same way in
both.  The CUDA kernels themselves are held against the plain versions
by ``chip_smoke.py`` and by the ``cuda``-marked test below.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.collectives.kernel import pack_bucket_kernel, unpack_bucket_kernel
from repro.kernels.collectives.ops import staging_supported as ref_staging_supported
from repro_torch.core.buckets import Bucket, LeafInfo
from repro_torch.kernels import _build
from repro_torch.kernels.collectives import kernel, ops, ref

SIZES = (5, 128, 1, 300, 77, 1024)
COMM = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16),
        "float16": (jnp.float16, torch.float16)}
MIXED = ("float32", "bfloat16", "float16", "float32", "bfloat16", "float16")


def _leaves(dtypes, seed=0):
    """The same values on both sides: f32 draws rounded once (by JAX) to
    each leaf dtype, so both packages start from identical bits."""
    rng = np.random.default_rng(seed)
    jx, tx = [], []
    for n, dt in zip(SIZES, dtypes):
        x = (rng.standard_normal(n) * 3).astype(np.float32)
        j = jnp.asarray(x).astype(COMM[dt][0])
        jx.append(j)
        tx.append(torch.from_numpy(np.array(j.astype(jnp.float32))).to(COMM[dt][1]))
    return jx, tx


def _bits(a) -> np.ndarray:
    """f32 bit patterns (every staged dtype widens to f32 exactly)."""
    if isinstance(a, torch.Tensor):
        a = a.to(torch.float32).numpy()
    else:
        a = np.asarray(a.astype(jnp.float32))
    return a.view(np.uint32)


@pytest.mark.parametrize("scale", [1.0, 64.0])
@pytest.mark.parametrize("comm", sorted(COMM))
@pytest.mark.parametrize("leaf_dtypes", ["uniform", "mixed"])
def test_leafwise_staging_bitexact_vs_pallas(leaf_dtypes, comm, scale):
    dts = ("float32",) * len(SIZES) if leaf_dtypes == "uniform" else MIXED
    jl, tl = _leaves(dts)
    jbuf = pack_bucket_kernel(jl, COMM[comm][0], scale=scale, interpret=True)
    tbuf = ref.leafwise_pack(tl, COMM[comm][1], scale=scale)
    assert tbuf.dtype == COMM[comm][1] and tbuf.shape == (sum(SIZES),)
    np.testing.assert_array_equal(_bits(tbuf), _bits(jbuf))

    # unpack the same reduced buffer with the inverse scale
    jouts = unpack_bucket_kernel(jbuf, SIZES, [COMM[d][0] for d in dts],
                                 scale=1.0 / scale, interpret=True)
    touts = ref.leafwise_unpack(tbuf, SIZES, [COMM[d][1] for d in dts],
                                scale=1.0 / scale)
    for j, t, d in zip(jouts, touts, dts):
        assert t.dtype == COMM[d][1]
        np.testing.assert_array_equal(_bits(t), _bits(j))


def _bucket(tensors):
    infos = tuple(LeafInfo(f"l{i}", i, tuple(t.shape), t.dtype, t.numel())
                  for i, t in enumerate(tensors))
    return Bucket(infos, ("data", "model"), 0, 0)


@pytest.mark.parametrize("scale", [1.0, 64.0])
def test_fused_ops_on_cpu_are_the_plain_versions(scale):
    """On CPU tensors fused_pack/fused_unpack run ref.py: same bits, and
    unpack writes the leaves in place."""
    _, tl = _leaves(MIXED)
    flat = [t.reshape(1, -1) if i % 2 else t for i, t in enumerate(tl)]
    bucket = _bucket(flat)
    buf = ops.fused_pack(bucket, flat, torch.bfloat16, scale=scale)
    assert torch.equal(buf, ref.leafwise_pack(flat, torch.bfloat16, scale=scale))
    targets = [torch.empty_like(t) for t in flat]
    ids = [t.data_ptr() for t in targets]
    ops.fused_unpack(bucket, buf, targets, scale=1.0 / scale)
    want = ref.leafwise_unpack(buf, SIZES, [t.dtype for t in flat],
                               scale=1.0 / scale)
    for t, w, p in zip(targets, want, ids):
        assert t.data_ptr() == p
        assert torch.equal(t.reshape(-1), w)


def test_fused_unpack_rejects_mismatched_targets():
    _, tl = _leaves(("float32",) * len(SIZES))
    bucket = _bucket(tl)
    buf = ops.fused_pack(bucket, tl, torch.float32)
    bad = list(tl)
    bad[2] = torch.empty(SIZES[2], dtype=torch.float64)
    with pytest.raises(ValueError, match="l2"):
        ops.fused_unpack(bucket, buf, bad)


@pytest.mark.parametrize("leaf", ["float32", "bfloat16", "float16", "float64",
                                  "int32", "int8", "complex64"])
@pytest.mark.parametrize("comm", ["float32", "bfloat16", "float16", "int32"])
def test_staging_supported_matches_reference(leaf, comm):
    want = ref_staging_supported([jnp.dtype(leaf)], jnp.dtype(comm))
    assert ops.staging_supported([getattr(torch, leaf)], getattr(torch, comm)) == want


def test_kernel_wrappers_take_cuda_tensors_only():
    t = torch.ones(4)
    before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.pack_bucket_kernel([t], torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.unpack_bucket_kernel(t, [torch.empty(4)])
    assert (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES) == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: without a CUDA compiler the build fails loudly."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.build()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 64.0])
@pytest.mark.parametrize("comm", sorted(COMM))
def test_cuda_kernels_bitexact_vs_plain(cuda, comm, scale):
    _, tl = _leaves(MIXED)
    flat = [t.to(cuda) for t in tl]
    bucket = _bucket(flat)
    before = kernel.PACK_LAUNCHES
    buf = ops.fused_pack(bucket, flat, COMM[comm][1], scale=scale)
    assert kernel.PACK_LAUNCHES - before == 3     # one launch per leaf dtype
    want = ref.leafwise_pack(flat, COMM[comm][1], scale=scale)
    np.testing.assert_array_equal(_bits(buf.cpu()), _bits(want.cpu()))
    targets = [torch.empty_like(t) for t in flat]
    ops.fused_unpack(bucket, buf, targets, scale=1.0 / scale)
    for t, w in zip(targets, ref.leafwise_unpack(
            buf, SIZES, [t.dtype for t in flat], scale=1.0 / scale)):
        np.testing.assert_array_equal(_bits(t.cpu()), _bits(w.cpu()))
