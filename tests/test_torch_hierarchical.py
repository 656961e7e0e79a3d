"""The port's hierarchical reducers on a ("pod", "data", "model") mesh
against the JAX package.

4 gloo ranks (``tests/_torch_mdworker.py``, mode ``hier``) and the
reference on 4 fake CPU devices run the flat, hierarchical and
hierarchical_ring reducers on rank-varying data (rank r reduces
(1 + r) x base, mean over the 4 data-parallel ranks), as
``tests/_mdworker.py`` section 6 does, on pod 2 x data 2 and pod 1 x
data 4 (the reference's inputs are made outside its program: XLA's CPU
build fuses an in-program (1 + r) x base into the ring's first add as an
FMA, which ``tests/_mdworker.py``'s 1e-5 checks allow and a bit-exact
check does not):

  - every reducer is the analytic mean 2.5 x base, and hierarchical and
    hierarchical_ring equal flat, within 1e-5 (the reference's checks);
  - hierarchical_ring equals the reference's BIT FOR BIT: its rings add
    each chunk in the reference's order (``tests/test_torch_ring.py``),
    the inter-pod stage is one commutative add at 2 pods and nothing at
    1, and the mean scale is 1/4;
  - hierarchical equals the reference's within 1e-5 only: its stage 1 is
    gloo's ``reduce_scatter_tensor`` against XLA's ``psum_scatter``,
    which may add the 2 or 4 values in another order.

GradSync's reduced smoke gradients under funnel/concom/depcha x
hierarchical/hierarchical_ring on pod 2 x data 2 (and funnel on pod 1 x
data 4) are the sum of JAX's per-shard gradients at rtol 1e-5 / atol
1e-6, as ``tests/test_torch_multirank.py`` holds the flat reducer.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.resnet50_cifar import make_smoke as ref_make_smoke
from repro.data import ImagePipeline as RefImagePipeline
from repro.models import resnet as ref_resnet
from repro.utils.trees import flatten_with_names as ref_flatten

from _torch_mdworker import (
    GLOBAL_BATCH,
    HIER_GRADS,
    HIER_MESHES,
    HIER_REDUCERS,
    WORLD,
    run_all,
)

N = 1024


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_hier")
    base = np.random.default_rng(7).standard_normal(N).astype(np.float32)
    np.savez(d / "inputs.npz", base=base)
    cfg = ref_make_smoke()
    params = ref_resnet.init_params(jax.random.PRNGKey(0), cfg)
    np.savez(d / "params.npz",
             **{n: np.asarray(p) for n, p in ref_flatten(params)[0]})
    run_all(d, "hier", reference_too=True)
    port = [dict(np.load(d / f"hier_rank{r}.npz")) for r in range(WORLD)]
    return d, base, params, port, dict(np.load(d / "hier_jax.npz"))


@pytest.fixture(scope="module")
def expected(results):
    """The sum over the 4 batch shards of JAX's per-shard gradients."""
    _, _, params, _, _ = results
    cfg = ref_make_smoke()
    batch = RefImagePipeline(cfg.img_size, cfg.num_classes,
                             GLOBAL_BATCH).batch_at(0)
    grad_fn = jax.jit(jax.grad(lambda p, b: ref_resnet.train_forward(p, b, cfg)))
    local = GLOBAL_BATCH // WORLD
    total = None
    for r in range(WORLD):
        shard = {"images": batch["images"][r * local:(r + 1) * local],
                 "labels": batch["labels"][r * local:(r + 1) * local],
                 "global_tokens": batch["global_tokens"]}
        g = {n: np.asarray(v) for n, v in ref_flatten(grad_fn(params, shard))[0]}
        total = g if total is None else {n: total[n] + g[n] for n in g}
    return total


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("reducer", HIER_REDUCERS)
@pytest.mark.parametrize("mesh", sorted(HIER_MESHES))
def test_reducers_are_the_analytic_mean(results, mesh, reducer, rank):
    """hier-matches-analytic: the mean of (1 + r) x base over 4 ranks."""
    _, base, _, port, _ = results
    got = port[rank][f"{reducer}_{mesh}"]
    assert np.max(np.abs(got - base * 2.5)) < 1e-5


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("reducer", ["hierarchical", "hierarchical_ring"])
@pytest.mark.parametrize("mesh", sorted(HIER_MESHES))
def test_hierarchical_equals_flat(results, mesh, reducer, rank):
    """hier-equals-flat-podmesh / hier-ring-reducer-equals-flat-podmesh."""
    _, _, _, port, _ = results
    flat = port[rank][f"flat_{mesh}"]
    assert np.max(np.abs(port[rank][f"{reducer}_{mesh}"] - flat)) < 1e-5


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("mesh", sorted(HIER_MESHES))
def test_hierarchical_ring_matches_the_reference_bit_for_bit(results, mesh, rank):
    _, _, _, port, ref = results
    key = f"hierarchical_ring_{mesh}"
    np.testing.assert_array_equal(port[rank][key].view(np.uint32),
                                  ref[key][rank].view(np.uint32))


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("reducer", ["flat", "hierarchical"])
@pytest.mark.parametrize("mesh", sorted(HIER_MESHES))
def test_reducers_match_the_reference(results, mesh, reducer, rank):
    _, _, _, port, ref = results
    key = f"{reducer}_{mesh}"
    np.testing.assert_allclose(port[rank][key], ref[key][rank], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("name", sorted(HIER_GRADS.values()))
def test_gradsync_reduces_pod_grads_to_the_sum_of_shard_grads(results, expected,
                                                               name, rank):
    d = results[0]
    got = dict(np.load(d / f"{name}_rank{rank}.npz"))
    assert sorted(got) == sorted(expected)
    for n, want in expected.items():
        np.testing.assert_allclose(got[n], want, rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("reducer", ["hierarchical", "hierarchical_ring"])
def test_rsag_refuses_the_hierarchical_reducers(reducer):
    """As the reference's GradSync: a two-phase strategy would ignore them."""
    from repro_torch.configs.resnet50_cifar import make_smoke
    from repro_torch.core import GradSync, GradSyncConfig
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import resnet

    tree = resnet.init_params(make_smoke(), device="meta")
    with pytest.raises(ValueError, match="reduce-scatter"):
        GradSync(GradSyncConfig(strategy="rsag", reducer=reducer),
                 make_pod_mesh(2, 2), resnet.param_specs(tree), tree, device="cpu")


def test_pod_mesh_layout():
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.parallel.sharding import dp_axes_of, local_batch

    mesh = make_pod_mesh(2, 4)
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.shape == {"pod": 2, "data": 4, "model": 1}
    assert dp_axes_of(mesh) == ("pod", "data")
    assert local_batch(256, mesh) == 32


@pytest.mark.parametrize("world", [1, 3, 5])
def test_multi_pod_needs_a_world_of_two_pods(monkeypatch, world):
    import torch.distributed as dist

    from repro_torch.launch import mesh

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    with pytest.raises(ValueError, match="two"):
        mesh.make_dp_mesh(multi_pod=True)
    assert mesh.make_dp_mesh().shape == {"data": world, "model": 1}


def test_multi_pod_launcher_refuses_one_rank():
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="two equal pods"):
        train.main(["--arch", "resnet50-cifar", "--smoke", "--steps", "1",
                    "--device", "cpu", "--multi-pod"])
    assert not torch.distributed.is_initialized()


def test_hierarchical_ring_on_cuda_tensors_needs_a_peer_ring():
    """No fallback: without the pod's PeerRing a CUDA buffer raises rather
    than take the plain ring (checked on the device type alone)."""
    from repro_torch.kernels.collectives import ops

    with pytest.raises(ValueError, match="PeerRing"):
        ops._need(None)


@pytest.mark.parametrize("g, bidirectional, per_call", [
    # hop 0: a credit wait a neighbour written; middle hops: a ready wait a
    # neighbour read and a credit wait a neighbour written; last hop: a
    # ready wait a neighbour read.  At g = 2 both directions share the peer.
    (2, True, 1 + 1), (2, False, 1 + 1),
    (3, True, 2 + (2 + 2) + 2), (3, False, 1 + (1 + 1) + 1),
    (4, True, 2 + 2 * (2 + 2) + 2), (4, False, 1 + 2 * (1 + 1) + 1)])
def test_peer_ring_stream_waits_per_call(g, bidirectional, per_call):
    from repro_torch.kernels.collectives import kernel

    assert kernel.peer_memops(g, bidirectional) == per_call


def test_peer_ring_kernels_refuse_cpu_tensors():
    from repro_torch.kernels.collectives import kernel

    ring = type("Ring", (), {"g": 2, "device": torch.device("cuda", 0)})()
    with pytest.raises(ValueError, match="cuda"):
        kernel._peer_call(ring, None, "ring_reduce_scatter_kernel",
                          torch.zeros(4), torch.zeros(2), 2, True)
