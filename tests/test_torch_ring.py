"""The port's ring collectives and ring-hop combine against the JAX package.

The combine's plain versions (``ref.ring_accum_ref``: ``torch.add``, and
``ref.ring_accum_pairs_ref``, ``torch.add`` a pair, which the CUDA
``ring_accum_kernel``/``ring_accum_pairs_kernel`` are held against on the
card) must agree BIT-exactly with the Pallas ``ring_accum_kernel`` in
interpret mode, as the JAX package's tests run it.  The ring calls its
combine once a hop with every direction's pair.  The rings run on 4 gloo ranks (spawned
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


@pytest.mark.parametrize("sizes", [(100,), (4 * RING_CHUNK, 4 * RING_CHUNK + 1),
                                   (1, 7, 100, 4096, 37, 5, 2, 131)])
def test_accum_pairs_plain_version_matches_add_and_pallas(sizes):
    """A pair each: torch.add, and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(len(sizes))
    a = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    b = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    got = ref.ring_accum_pairs_ref([torch.from_numpy(x) for x in a],
                                   [torch.from_numpy(x) for x in b])
    assert len(got) == len(sizes)
    for x, y, t in zip(a, b, got):
        want = np.asarray(ring_accum_kernel(jnp.asarray(x), jnp.asarray(y), interpret=True))
        np.testing.assert_array_equal(t.numpy().view(np.uint32), want.view(np.uint32))
        assert torch.equal(t, torch.add(torch.from_numpy(x), torch.from_numpy(y)))


def test_accum_on_cpu_is_the_plain_version():
    accum = ops._accum(torch.device("cpu"))
    a, b = [torch.randn(7), torch.randn(3)], [torch.randn(7), torch.randn(3)]
    assert accum is ref.ring_accum_pairs_ref
    for got, want in zip(accum(a, b), ref.ring_accum_pairs_ref(a, b)):
        assert torch.equal(got, want)


def test_accum_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ring_accum_kernel(torch.zeros(4), torch.zeros(4))


@pytest.mark.parametrize("msgs,chunks,match", [
    ([torch.zeros(4)], [torch.zeros(4)], "CUDA"),
    ([], [], "1 to 8 pairs"),
    ([torch.zeros(4)] * 9, [torch.zeros(4)] * 9, "1 to 8 pairs"),
    ([torch.zeros(4)] * 2, [torch.zeros(4)], "1 to 8 pairs"),
])
def test_accum_pairs_kernel_refuses_what_it_cannot_take(msgs, chunks, match):
    before = kernel.ACCUM_LAUNCHES
    with pytest.raises(ValueError, match=match):
        kernel.ring_accum_pairs_kernel(msgs, chunks)
    assert kernel.ACCUM_LAUNCHES == before


@pytest.mark.parametrize("g,c,bidirectional,pairs", [
    (4, 37, True, 2), (4, 37, False, 1), (4, 1, True, 1), (2, 6, True, 2), (3, 2, True, 2)])
def test_ring_reduce_scatter_combines_once_a_hop(monkeypatch, g, c, bidirectional, pairs):
    """g - 1 calls of ``accum``, each with one pair per ring direction (one
    when unidirectional or when a half-chunk is empty); the pairs are the
    received message and this rank's own row of its half."""
    monkeypatch.setattr(ref.dist, "get_world_size", lambda group: g)
    monkeypatch.setattr(ref.dist, "get_rank", lambda group: 1)
    monkeypatch.setattr(ref, "_hop", lambda msgs, signs, group, r, g: [m + 0 for m in msgs])
    calls = []

    def accum(received, own):
        calls.append(([m.numel() for m in received], [m.numel() for m in own]))
        assert all(o.is_contiguous() for o in own)
        return ref.ring_accum_pairs_ref(received, own)

    x = torch.arange(g * c, dtype=torch.float32)
    ref.ring_reduce_scatter_ref(x, None, bidirectional=bidirectional, accum=accum)
    halves = [c // 2, c - c // 2] if pairs == 2 else [c]
    assert calls == [(halves, halves)] * (g - 1)


def test_ring_of_one_is_the_identity():
    buf = torch.linspace(0.0, 1.0, 37)
    out = ops.ring_allreduce(buf, ("data", "model"), {"data": 1, "model": 1}, None)
    assert out is buf


def test_ring_over_two_axes_is_refused(monkeypatch):
    """A ring over two axes of size > 1 runs a ring an axis, each on its
    axis's communicator of the chain's communicators (``get(axes)``): a
    communicator whose size is not its axis's is refused; the
    reduce-scatter runs the data ring, then the model ring on the data
    ring's shard, and the all-gather the two in reverse (the reference's
    decomposition).  The rings themselves run on 4 gloo ranks in
    tests/test_torch_tp.py."""
    sizes = {"data": 2, "model": 4}
    calls = []

    class Comms:
        def get(self, axes):
            return axes[0]

    class OneGroup:
        def get(self, axes):
            return "world"

    monkeypatch.setattr(ops.dist, "get_world_size", lambda group: 8)
    with pytest.raises(ValueError, match="makes a ring of 2"):
        ops.ring_reduce_scatter(torch.zeros(8), ("data", "model"), sizes, OneGroup())

    def rs(buf, group, **kw):
        calls.append(("rs", group, buf.numel()))
        return buf[:buf.numel() // sizes[group]]

    def ag(shard, group, **kw):
        calls.append(("ag", group, shard.numel()))
        return torch.cat([shard] * sizes[group])

    monkeypatch.setattr(ops.dist, "get_world_size", lambda group: sizes[group])
    monkeypatch.setattr(ops.ref, "ring_reduce_scatter_ref", rs)
    monkeypatch.setattr(ops.ref, "ring_all_gather_ref", ag)
    out = ops.ring_allreduce(torch.arange(14.0), ("data", "model"), sizes, Comms())
    assert calls == [("rs", "data", 16), ("rs", "model", 8), ("ag", "model", 2),
                     ("ag", "data", 8)]
    assert out.shape == (14,)


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
def test_hierarchical_reducers_are_registered_and_refused(name, monkeypatch):
    """Ported (tests/test_torch_hierarchical.py).  A pod reduction that
    also spans "model" runs the pod stages at the rank's model coordinate,
    then a psum over "model" on the chain's model communicator; given a
    chain's communicators without a PodComm it is refused.  On 4 gloo
    ranks: tests/test_torch_tp.py (pod 2 x data 1 x model 2)."""
    from repro_torch.core import Bucket, LeafInfo, make_reducer, reducer_names, strategies
    from repro_torch.core import dependency as dep
    from repro_torch.launch.mesh import make_pod_mesh

    assert name in reducer_names()
    shape = {"pod": 2, "data": 2, "model": 2}
    bucket = Bucket(leaves=(LeafInfo(name="x", index=0, shape=(8,),
                                     dtype=torch.float32, size=8),),
                    reduce_axes=("pod", "data", "model"), channel=0, bucket_id=0)
    calls = []
    monkeypatch.setattr(strategies, "hierarchical_allreduce",
                        lambda buf, pod, use_ring=False: calls.append(
                            ("stages", pod, use_ring)) or buf + 1)
    monkeypatch.setattr(strategies.dep, "collective",
                        lambda fn, group, out, *ins: calls.append(("psum", group)) or dep.DONE)
    mesh = make_pod_mesh(2, 2, 2)
    comms = dep.ChainComms({("model",): "model-group"}, mesh)
    with pytest.raises(ValueError, match="PodComm"):
        make_reducer(name, shape)(torch.zeros(8), bucket, comms)
    assert calls == []
    pod = dep.PodComm("intra", "inter")
    comms.pod = pod
    out = make_reducer(name, shape)(torch.zeros(8), bucket, comms).wait()
    assert calls == [("stages", pod, name == "hierarchical_ring"), ("psum", "model-group")]
    assert torch.equal(out, torch.ones(8))
