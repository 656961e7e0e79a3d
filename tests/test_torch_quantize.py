"""The port's int8 block quantize/dequantize against the JAX package.

``quantize_ref``/``dequantize_ref`` (the plain versions the CUDA kernels
are held against on the card, and what ``ops.quantize_blocks``/
``dequantize_blocks`` run on CPU tensors) must agree BIT-exactly with the
Pallas kernels run in interpret mode, as the JAX package's own tests run
them, and with ``repro/core/compression.py::quantize_blockwise`` compiled
as the reference's reducer runs it (under ``jax.jit``, where XLA turns
``amax / 127.0`` into a product with the f32 reciprocal, as the port
does): an amax, that product, one IEEE division, round-half-even and one
product round the same way in both.  The CUDA kernels are held against
the plain versions by ``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.

The peer sum (``dequantize_sum_ref``, the compressed reducer's phase 2)
must equal the Pallas dequantize applied to each peer's shard and the
shards added in peer order by eager ``jnp`` adds, each rounded once; the
sum-requantize (``dequantize_sum_quantize_blocks``, phases 2 and 3) that
sum quantized by the Pallas quantize.  Phase 1's quantize of an unpadded
buffer (``quantize_blocks(buf, pad_to=m)``) must equal the reference's
quantize of the buffer zero-padded in jnp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import dequantize_blockwise as ref_dequantize_blockwise
from repro.core.compression import quantize_blockwise as ref_quantize_blockwise
from repro.kernels.quantize.kernel import dequantize_blocks_kernel, quantize_blocks_kernel
from repro_torch.kernels.quantize import kernel, ops, ref

BLOCK = 256


def _blocks(n_blocks: int, scale: float, seed: int = 1) -> np.ndarray:
    """Seeded normal blocks, with an all-zero block and blocks whose
    x/scale lands on exact .5 ties (scale 1 and scale 2)."""
    x = np.random.default_rng(seed).standard_normal((n_blocks, BLOCK))
    x = (x * scale).astype(np.float32)
    x[0] = 0.0
    x[1, :] = np.linspace(-126.5, 126.5, BLOCK, dtype=np.float32).round() + 0.5
    x[1, 0] = 127.0                                   # amax 127: scale 1
    x[2, :] = 2 * (np.arange(BLOCK, dtype=np.float32) % 254 - 127) + 1
    x[2, 0] = -254.0                                  # amax 254: scale 2
    return x


@pytest.mark.parametrize("n_blocks", [64, 128, 1024])     # tests/test_kernels.py:42
@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e3])
def test_plain_versions_match_pallas_kernels_bit_exactly(n_blocks, scale):
    x = _blocks(n_blocks, scale)
    q_j, s_j = quantize_blocks_kernel(jnp.asarray(x), interpret=True)
    q_t, s_t = ref.quantize_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy().view(np.uint32),
                                  np.asarray(s_j).view(np.uint32))
    d_j = dequantize_blocks_kernel(q_j, s_j, interpret=True)
    d_t = ref.dequantize_ref(q_t, s_t)
    np.testing.assert_array_equal(d_t.numpy().view(np.uint32),
                                  np.asarray(d_j).view(np.uint32))


@pytest.mark.parametrize("n_blocks", [3, 64, 1024])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_ops_match_compression_quantize_blockwise(n_blocks, scale):
    """The 1-D API the compressed reducer calls, against the jnp math the
    reference's reducer calls, compiled as it runs there."""
    x = _blocks(n_blocks, scale, seed=2).reshape(-1)
    q_j, s_j = jax.jit(ref_quantize_blockwise)(jnp.asarray(x))
    q_t, s_t = ops.quantize_blocks(torch.from_numpy(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy().view(np.uint32),
                                  np.asarray(s_j).view(np.uint32))
    d_t = ops.dequantize_blocks(q_t, s_t)
    d_j = jax.jit(ref_dequantize_blockwise)(q_j, s_j)
    np.testing.assert_array_equal(d_t.numpy().view(np.uint32),
                                  np.asarray(d_j).view(np.uint32))


def test_zero_block_and_ties():
    """Scale 1 for an all-zero block; x/scale on .5 rounds half to even."""
    x = _blocks(4, 1.0)
    q, s = ref.quantize_ref(torch.from_numpy(x))
    assert s[0].item() == 1.0 and not q[0].any()
    assert s[1].item() == 1.0 and s[2].item() == 2.0
    for row in (1, 2):
        y = x[row] / s[row].item()
        ties = y != np.trunc(y)
        assert ties.sum() > 100
        np.testing.assert_array_equal(q[row].numpy()[ties], np.round(y[ties]))
        assert np.all(q[row].numpy()[ties] % 2 == 0)


def test_scale_is_the_compiled_reciprocal_product():
    """amax · fl(1/127), as XLA compiles the reference's amax / 127.0 —
    which is not always the IEEE quotient."""
    amax = np.abs(np.random.default_rng(4).standard_normal(4096)).astype(np.float32)
    x = np.zeros((amax.size, BLOCK), np.float32)
    x[:, 7] = amax
    _, s = ref.quantize_ref(torch.from_numpy(x))
    want = amax * (np.float32(1) / np.float32(127))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(
        s.numpy().view(np.uint32),
        np.asarray(jax.jit(lambda a: a / 127.0)(amax)).view(np.uint32))
    assert np.any(want != amax / np.float32(127))


def test_quantization_error_is_within_half_a_step():
    x = _blocks(64, 1.0, seed=3)
    q, s = ref.quantize_ref(torch.from_numpy(x))
    err = np.abs(x - ref.dequantize_ref(q, s).numpy())
    assert np.all(err <= s.numpy()[:, None] * 0.5 + 1e-7)


@pytest.mark.parametrize("n,m", [(4196, 5120), (1001, 1024), (100, 256), (1024, 1024),
                                 (4096, 5120)])
@pytest.mark.parametrize("scale", [1e-3, 1e3])
def test_ops_quantize_of_an_unpadded_buffer_is_the_padded_reference(n, m, scale):
    """Phase 1 as the compressed reducer calls it, ``pad_to=m``: the
    reference's compiled quantize of the buffer zero-padded in jnp, bit
    for bit (n ragged, or already a multiple of 256)."""
    x = (np.random.default_rng(n).standard_normal(n) * scale).astype(np.float32)
    x[:min(n, BLOCK)] = 0.0                        # a zero block
    q_j, s_j = jax.jit(ref_quantize_blockwise)(jnp.pad(jnp.asarray(x), (0, m - n)))
    q_t, s_t = ops.quantize_blocks(torch.from_numpy(x), pad_to=m)
    assert q_t.shape == (m,) and s_t.shape == (m // BLOCK,)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy().view(np.uint32),
                                  np.asarray(s_j).view(np.uint32))


@pytest.mark.parametrize("pad_to", [None, 2048])
def test_ops_quantize_of_a_strided_cpu_buffer_is_its_contiguous_copy(pad_to):
    """On the CPU a strided buffer is quantized as its contiguous copy
    (the CUDA kernel refuses one: tests/test_torch_cuda.py)."""
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(4096).astype(np.float32))
    strided = x[::2]
    assert not strided.is_contiguous()
    q_t, s_t = ops.quantize_blocks(strided, pad_to=pad_to)
    q_c, s_c = ops.quantize_blocks(strided.contiguous(), pad_to=pad_to)
    torch.testing.assert_close(q_t, q_c, rtol=0, atol=0)
    torch.testing.assert_close(s_t, s_c, rtol=0, atol=0)


@pytest.mark.parametrize("buf,pad_to", [(torch.zeros(300), None), (torch.zeros(300), 200),
                                        (torch.zeros(300), 500), (torch.zeros(2, 256), None)])
def test_ops_refuse_a_ragged_buffer(buf, pad_to):
    with pytest.raises(ValueError, match="multiple of 256"):
        ops.quantize_blocks(buf, pad_to=pad_to)


def test_kernel_wrappers_refuse_cpu_tensors():
    before = (kernel.QUANTIZE_LAUNCHES, kernel.DEQUANTIZE_LAUNCHES,
              kernel.SUM_QUANTIZE_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.quantize_blocks_kernel(torch.zeros(2, BLOCK))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.quantize_blocks_kernel(torch.zeros(1001), n_blocks=4)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.dequantize_blocks_kernel(torch.zeros(2, BLOCK, dtype=torch.int8),
                                        torch.ones(2))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.dequantize_sum_quantize_blocks_kernel(
            torch.zeros(4, 2 * BLOCK, dtype=torch.int8), torch.ones(4, 2))
    assert (kernel.QUANTIZE_LAUNCHES, kernel.DEQUANTIZE_LAUNCHES,
            kernel.SUM_QUANTIZE_LAUNCHES) == before


def _peers(g: int, k: int, scale: float, seed: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """g peers' shards of k blocks as the compressed reducer receives them
    (q (g, k·256) int8, s (g, k) f32): each peer's values quantized by the
    plain version, at ``scale`` times a factor of its own, with the zero
    and tie blocks of ``_blocks`` on every peer."""
    rng = np.random.default_rng(seed)
    qs, ss = [], []
    for p in range(g):
        x = _blocks(k, scale * float(rng.uniform(0.5, 2.0)), seed=seed + p)
        q, s = ref.quantize_ref(torch.from_numpy(x))
        qs.append(q.numpy().reshape(-1))
        ss.append(s.numpy())
    return np.stack(qs), np.stack(ss)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_plain_peer_sum_matches_pallas_dequantize_and_eager_adds(g, scale):
    q, s = _peers(g, 6, scale)
    want = None
    for p in range(g):
        d = dequantize_blocks_kernel(jnp.asarray(q[p].reshape(-1, BLOCK)),
                                     jnp.asarray(s[p]), interpret=True).reshape(-1)
        want = d if want is None else want + d          # eager: one rounding an add
    got = ref.dequantize_sum_ref(torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (6 * BLOCK,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("g", [1, 4])
def test_ops_peer_sum_on_cpu_is_the_plain_version(g):
    """The 1-D API phase 2 calls: the peers' shards back to back."""
    q, s = _peers(g, 3, 1.0, seed=9)
    got = ops.dequantize_sum_blocks(torch.from_numpy(q.reshape(-1)),
                                    torch.from_numpy(s.reshape(-1)), g)
    want = ref.dequantize_sum_ref(torch.from_numpy(q), torch.from_numpy(s))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("entry,op", [
    (kernel.dequantize_sum_blocks_kernel, ops.dequantize_sum_blocks),
    (kernel.dequantize_sum_quantize_blocks_kernel, ops.dequantize_sum_quantize_blocks)])
def test_peer_sum_refuses_cpu_tensors_and_ragged_shapes(entry, op):
    q, s = torch.zeros(4, 2 * BLOCK, dtype=torch.int8), torch.ones(4, 2)
    before = (kernel.DEQUANTIZE_SUM_LAUNCHES, kernel.SUM_QUANTIZE_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        entry(q, s)
    for bad in (torch.zeros(4, 300, dtype=torch.int8), torch.zeros(2 * BLOCK, dtype=torch.int8),
                torch.zeros(0, BLOCK, dtype=torch.int8)):
        with pytest.raises(ValueError, match="peers >= 1"):
            entry(bad, s)
    with pytest.raises(ValueError, match="multiple of 256 x 4"):
        op(torch.zeros(3 * BLOCK, dtype=torch.int8), torch.ones(3), 4)
    assert (kernel.DEQUANTIZE_SUM_LAUNCHES, kernel.SUM_QUANTIZE_LAUNCHES) == before


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 9])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_sum_quantize_matches_pallas_dequantize_adds_and_quantize(g, scale):
    """Phases 2 and 3 through the 1-D API: the Pallas dequantize of each
    peer's shard, added in peer order by eager adds, then the Pallas
    quantize of the sum, bit for bit."""
    q, s = _peers(g, 6, scale, seed=11)
    red = None
    for p in range(g):
        d = dequantize_blocks_kernel(jnp.asarray(q[p].reshape(-1, BLOCK)),
                                     jnp.asarray(s[p]), interpret=True)
        red = d if red is None else red + d            # eager: one rounding an add
    q2_j, s2_j = quantize_blocks_kernel(red, interpret=True)
    q2, s2 = ops.dequantize_sum_quantize_blocks(torch.from_numpy(q.reshape(-1)),
                                                torch.from_numpy(s.reshape(-1)), g)
    assert q2.shape == (6 * BLOCK,) and q2.dtype == torch.int8 and s2.shape == (6,)
    np.testing.assert_array_equal(q2.numpy(), np.asarray(q2_j).reshape(-1))
    np.testing.assert_array_equal(s2.numpy().view(np.uint32), np.asarray(s2_j).view(np.uint32))
