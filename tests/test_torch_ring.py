"""The port's ring collectives and ring-hop combine against the JAX package.

The combine's plain version (``ref.ring_accum_ref``: ``torch.add``, which
the CUDA ``ring_accum_kernel`` is held against on the card) must agree
BIT-exactly with the Pallas ``ring_accum_kernel`` in interpret mode, as
the JAX package's tests run it.  The rings run on 4 gloo ranks (spawned
processes, ``tests/_torch_mdworker.py``) and the reference's on 4 fake
CPU devices in a subprocess, on the same seeded buffers: a ring of 4 and
two rings of 2, uni- and bidirectional, the one-way path of a half-chunk
of 0, and allreduce with padding.  Each chunk's adds happen in the same
order on both sides, so the results are held bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mdworker import RING_CASES, WORLD, run_all
from repro.kernels.collectives.kernel import RING_CHUNK, ring_accum_kernel
from repro_torch.kernels.collectives import kernel, ops, ref


@pytest.mark.parametrize("n", [100, 4 * RING_CHUNK])     # tests/test_collectives.py:141
def test_accum_plain_version_matches_pallas_kernel(n):
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    want = np.asarray(ring_accum_kernel(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True))
    got = ref.ring_accum_ref(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_accum_on_cpu_is_the_plain_version():
    accum = ops._accum(torch.device("cpu"))
    a, b = torch.randn(7), torch.randn(7)
    assert torch.equal(accum(a, b), ref.ring_accum_ref(a, b))


def test_accum_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ring_accum_kernel(torch.zeros(4), torch.zeros(4))


def test_ring_of_one_is_the_identity():
    buf = torch.linspace(0.0, 1.0, 37)
    out = ops.ring_allreduce(buf, ("data", "model"), {"data": 1, "model": 1}, None)
    assert out is buf


def test_ring_over_two_axes_is_refused():
    with pytest.raises(NotImplementedError, match="item 9"):
        ops.ring_reduce_scatter(torch.zeros(8), ("pod", "data"),
                                {"pod": 2, "data": 2}, None)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Seeded buffers in (row r for rank r); port and reference rings out."""
    d = tmp_path_factory.mktemp("torch_ring")
    rng = np.random.default_rng(5)
    inputs = {k: rng.standard_normal((WORLD, n)).astype(np.float32)
              for k, n in (("rs", 4 * 37), ("rs_c1", 4), ("ag", 37), ("ar", 150),
                           ("rs2", 2 * 37), ("ag2", 37), ("ar2", 75))}
    np.savez(d / "inputs.npz", **inputs)
    run_all(d, "rings", reference_too=True)
    port = [dict(np.load(d / f"rings_rank{r}.npz")) for r in range(WORLD)]
    return inputs, port, dict(np.load(d / "rings_jax.npz"))


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_rings_match_the_reference_bit_for_bit(results, case):
    _, port, want = results
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r][case].view(np.uint32),
                                      want[case][r].view(np.uint32),
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("case", ["rs_bidi", "rs_uni", "rs_c1", "rs2_bidi"])
def test_rank_r_owns_chunk_r(results, case):
    """The reduce-scatter lays chunks out as ``reduce_scatter_tensor``:
    rank r of a ring of g holds the sum of chunk r mod g."""
    inputs, port, _ = results
    key, g, _ = RING_CASES[case]
    x = inputs[key].astype(np.float64)
    c = x.shape[1] // g
    for r in range(WORLD):
        first = r // g * g                      # the ring's first rank
        own = r - first
        total = x[first:first + g].sum(0)[own * c:(own + 1) * c]
        np.testing.assert_allclose(port[r][case], total, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["hierarchical", "hierarchical_ring"])
def test_hierarchical_reducers_are_registered_and_refused(name):
    """Ported (tests/test_torch_hierarchical.py); what they still refuse is
    a pod reduction that also spans another axis of size > 1 (item 9)."""
    from repro_torch.core import Bucket, LeafInfo, make_reducer, reducer_names

    assert name in reducer_names()
    shape = {"pod": 2, "data": 2, "model": 2}
    bucket = Bucket(leaves=(LeafInfo(name="x", index=0, shape=(8,),
                                     dtype=torch.float32, size=8),),
                    reduce_axes=("pod", "data", "model"), channel=0, bucket_id=0)
    with pytest.raises(NotImplementedError, match="item 9"):
        make_reducer(name, shape)(torch.zeros(8), bucket, None)
