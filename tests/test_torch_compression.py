"""The port's compressed allreduce (``core/compression.py``) against the
JAX package.

On 4 gloo ranks (spawned processes, ``tests/_torch_mdworker.py``) and the
reference on 4 fake CPU devices in a subprocess, on the same seeded
buffers: ``compressed_allreduce`` with the gather phase on
``all_gather_into_tensor`` and on the ring.

The two are not bit-exact, for one reason that the tests below pin down:
compiled for the CPU, XLA fuses the reference's phase 2 (dequantize the
g peer shards, ``jnp.sum`` over peers) into one loop that accumulates
each product ``q · scale`` with a fused multiply-add, one rounding per
peer; the port dequantizes (the CUDA kernel, or its plain version) and
then adds the shards in peer order, two roundings per peer.  A numpy
model of each scheme reproduces each side bit for bit; the outputs
differ in 3,972 of 16,784 elements (4 ranks × 4,196) on these buffers,
each by less than one quantization step of its block.
``error_feedback_step`` differs likewise: XLA contracts ``g − q · s``
into one fused multiply-add.  Phase 1 quantizes the unpadded bucket (read
as zero-padded); phases 2 and 3 are one call a bucket
(``dequantize_sum_quantize_blocks``), whose plain version is the
dequantize, the adds in peer order and the quantize of the sum.  The
worker counts, on every rank, that call and the ones the reducer no
longer makes (``dequantize_sum_blocks``, ``F.pad``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_mdworker import CALLS, COMPRESSED_CASES, WORLD, run_all
from repro.core import compression as ref_compression
from repro_torch.core import compression
from repro_torch.core import dependency as dep
from repro_torch.kernels.quantize import ops as quant_ops
from repro_torch.parallel.sharding import Mesh

N = 4 * 1024 + 100        # pads to M = 5,120 = 5 · 256 · 4
M = 5 * 256 * WORLD
DIFFERING = 3972          # elements port ≠ reference, all ranks, each case
INV_127 = np.float32(1) / np.float32(127)


def _quantize(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(…, blocks, 256) f32 → int8 q, f32 scales (the compiled reference)."""
    amax = np.abs(x).max(-1)
    s = np.where(amax > 0, amax * INV_127, np.float32(1)).astype(np.float32)
    return np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8), s


def _model(x: np.ndarray, fma: bool) -> np.ndarray:
    """Every rank's output of the compressed allreduce of rows ``x``, its
    peer sum with one rounding per peer (``fma``) or two."""
    q, s = _quantize(np.pad(x, ((0, 0), (0, M - N))).reshape(WORLD, -1, 256))
    acc = np.zeros(q.shape[1:], np.float32)
    for j in range(WORLD):
        if fma:     # the int8 · f32 product is exact in f64
            acc = (acc.astype(np.float64)
                   + q[j].astype(np.float64) * s[j, :, None]).astype(np.float32)
        else:
            deq = q[j].astype(np.float32) * s[j, :, None]
            acc = deq if j == 0 else acc + deq
    q2, s2 = _quantize(acc)
    return (q2.astype(np.float32) * s2[:, None]).reshape(-1)[:N]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_compressed")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((WORLD, N)).astype(np.float32)
    x *= np.array([1.0, 0.5, 2.0, 1e-3], np.float32)[:, None]   # unlike magnitudes
    x[:, 256:512] = 0.0                                          # an all-zero block
    np.savez(d / "inputs.npz", compressed=x)
    run_all(d, "compressed", reference_too=True)
    port = [dict(np.load(d / f"compressed_rank{r}.npz")) for r in range(WORLD)]
    return x, port, dict(np.load(d / "compressed_jax.npz"))


@pytest.mark.parametrize("case", sorted(COMPRESSED_CASES))
def test_compressed_allreduce_is_the_two_rounding_model(results, case):
    x, port, _ = results
    want = _model(x, fma=False)
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r][case].view(np.uint32),
                                      want.view(np.uint32), err_msg=f"rank {r}")


@pytest.mark.parametrize("case", sorted(COMPRESSED_CASES))
def test_reference_is_the_fused_multiply_add_model(results, case):
    x, _, ref = results
    want = _model(x, fma=True)
    for r in range(WORLD):
        np.testing.assert_array_equal(ref[case][r].view(np.uint32),
                                      want.view(np.uint32), err_msg=f"rank {r}")


@pytest.mark.parametrize("case", sorted(COMPRESSED_CASES))
def test_compressed_allreduce_is_within_a_step_of_the_reference(results, case):
    _, port, ref = results
    got = np.stack([port[r][case] for r in range(WORLD)])
    want = ref[case]
    step = np.abs(np.pad(want, ((0, 0), (0, M - N)))).reshape(WORLD, -1, 256).max(2) / 127
    step = np.repeat(step, 256, axis=1)[:, :N]
    assert np.all(np.abs(got - want) <= step)
    assert np.sum(got != want) == DIFFERING


@pytest.mark.parametrize("case", sorted(COMPRESSED_CASES))
def test_phases_two_and_three_are_one_call_a_bucket_on_every_rank(results, case):
    """Each rank's one sharded bucket: one ``dequantize_sum_quantize_blocks``
    call, no ``dequantize_sum_blocks`` and no ``F.pad`` (phase 1 reads the
    unpadded buffer; N is not a multiple of 256 · 4)."""
    _, port, _ = results
    for r in range(WORLD):
        assert dict(zip(CALLS, port[r][f"calls_{case}"].tolist())) == {
            "dequantize_sum_quantize_blocks": 1, "dequantize_sum_blocks": 0, "pad": 0}


def test_compressed_ring_equals_compressed(results):
    _, port, _ = results
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r]["compressed"],
                                      port[r]["compressed_ring"])


def test_compressed_allreduce_is_within_the_quantization_bound(results):
    """|out − Σ x| ≤ Σ_r scale_r/2 + scale₂/2 per block (scale₂ from the
    output: the requantized shard's amax is 127 steps)."""
    x, port, _ = results
    out = port[0]["compressed"]
    xp = np.pad(x, ((0, 0), (0, (-N) % (256 * WORLD)))).reshape(WORLD, -1, 256)
    s_sum = (np.abs(xp).max(2) / 127).sum(0)
    s2 = np.abs(np.pad(out, (0, xp.shape[1] * 256 - N))).reshape(-1, 256).max(1) / 127
    bound = np.repeat((s_sum + s2) / 2 * (1 + 1e-5), 256)[:N] + 1e-7
    assert np.all(np.abs(out - x.astype(np.float64).sum(0)) <= bound)
    assert np.abs(out - x.sum(0)).max() > 0          # really quantized


def test_error_feedback_step_matches_the_reference():
    """The synced value bit for bit; the residual ``(g + r) − q·s``
    within one ulp of ``g + r`` (the reference's is one fused
    multiply-add, the port's rounds the product first)."""
    rng = np.random.default_rng(7)
    g, r = (rng.standard_normal(1000).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda a, b: ref_compression.error_feedback_step(
        a, b, lambda v: v * 2.0))(jnp.asarray(g), jnp.asarray(r))
    got = compression.error_feedback_step(torch.from_numpy(g), torch.from_numpy(r),
                                          lambda v: v * 2.0)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]).view(np.uint32))
    diff = np.abs(got[1].numpy() - np.asarray(want[1]))
    assert np.all(diff <= np.spacing(np.abs(g + r)))
    assert diff.max() > 0


def test_quantize_blockwise_round_trip():
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(512).astype(np.float32))
    q, s = compression.quantize_blockwise(x)
    assert q.dtype == torch.int8 and s.shape == (2,)
    err = (compression.dequantize_blockwise(q, s) - x).abs().reshape(2, 256)
    assert torch.all(err <= s[:, None] / 2 + 1e-7)


@pytest.mark.parametrize("n", [4 * 1024 + 100, 256 * WORLD, 70000])
def test_phase_two_is_one_peer_sum_a_bucket(monkeypatch, n):
    """One process standing in for every rank (its collectives faked:
    each peer sends this rank's own shards): ``compressed_allreduce``
    calls the peer-sum-and-requantize op once, at g = 4, and computes what
    the quantize of the zero-padded buffer, the dequantize followed by the
    adds in peer order and the requantize of the sum compute."""
    def collective(fn, group, out, *ins):
        if fn is dist.all_to_all_single:
            out.copy_(ins[0])
        elif fn is dist.all_gather_into_tensor:
            out.copy_(ins[0].repeat(out.numel() // ins[0].numel()))
        else:
            raise AssertionError(f"unexpected collective {fn}")
        return types.SimpleNamespace(wait=lambda: None)

    calls = []

    def peer_sum(q, s, g):
        calls.append(g)
        return quant_ops.dequantize_sum_quantize_blocks(q, s, g)

    monkeypatch.setattr(compression.dep, "collective", collective)
    monkeypatch.setattr(compression, "dequantize_sum_quantize_blocks", peer_sum)
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(np.float32))
    comms = dep.ChainComms({("data",): "world"}, Mesh(("data",), {"data": WORLD}))
    got = compression.compressed_allreduce(x.clone(), ("data",), {"data": WORLD}, comms)
    assert calls == [WORLD]
    m = -(-n // (256 * WORLD)) * 256 * WORLD
    q, s = compression.quantize_blockwise(torch.nn.functional.pad(x, (0, m - n)))
    deq = compression.dequantize_blockwise(q, s).reshape(WORLD, -1)
    red = deq[0]
    for j in range(1, WORLD):
        red = red + deq[j]
    want = compression.dequantize_blockwise(*compression.quantize_blockwise(red))
    assert torch.equal(got.view(torch.int32), want.repeat(WORLD)[:n].view(torch.int32))


def test_non_f32_comm_buffers_are_refused():
    with pytest.raises(NotImplementedError, match="item 7"):
        compression.compressed_allreduce(torch.zeros(2048, dtype=torch.bfloat16),
                                         ("data",), {"data": 4}, None)
