"""The port's GradSync across 4 gloo ranks (spawned processes) against the
JAX package.

BatchNorm statistics are local to each rank, so a single-process full
batch is not the oracle: the expected reduced gradient is the sum over
the 4 batch shards of JAX's per-shard ``value_and_grad(train_forward)``
(each normalised by the global batch).  Tolerance rtol 1e-5 / atol 1e-6:
the per-shard gradients come from two convolution libraries, and the
4-way sum is taken in another order.  The flat and ring reducers are
held to it; the compressed reducers to the int8 quantization bound, and
compressed_ring to compressed bit for bit.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.resnet50_cifar import make_smoke as ref_make_smoke
from repro.data import ImagePipeline as RefImagePipeline
from repro.models import resnet as ref_resnet
from repro.utils.trees import flatten_with_names as ref_flatten

from _torch_mdworker import CONFIGS, run_all
from repro_torch.kernels.quantize import ref as quantize_ref

WORLD = 4
GLOBAL_BATCH = 8
STRATEGIES = ("funnel", "concom", "depcha", "rsag")
RING = [name for (_, red), name in CONFIGS.items() if red == "ring"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Carried weights in, the 4 workers run, their outputs left here."""
    d = tmp_path_factory.mktemp("torch_md")
    cfg = ref_make_smoke()
    params = ref_resnet.init_params(jax.random.PRNGKey(0), cfg)
    np.savez(d / "params.npz",
             **{n: np.asarray(p) for n, p in ref_flatten(params)[0]})
    run_all(d, "grads")
    return d, params


@pytest.fixture(scope="module")
def expected(workdir):
    _, params = workdir
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
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_reduced_grads_are_the_sum_of_shard_grads(workdir, expected, strategy,
                                                  rank):
    d, _ = workdir
    got = dict(np.load(d / f"{strategy}_rank{rank}.npz"))
    assert sorted(got) == sorted(expected)
    for n, want in expected.items():
        np.testing.assert_allclose(got[n], want, rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_strategies_reduce_to_the_same_bits(workdir):
    """Same sums, different schedules: bit-identical on every rank."""
    d, _ = workdir
    base = dict(np.load(d / "funnel_rank0.npz"))
    for strategy in STRATEGIES:
        for rank in range(WORLD):
            got = dict(np.load(d / f"{strategy}_rank{rank}.npz"))
            for n in base:
                np.testing.assert_array_equal(got[n], base[n], err_msg=n)


@pytest.mark.parametrize("rank", range(WORLD))
def test_kvstore_depcha_roundtrip(workdir, rank):
    """paper_api_demo on 4 ranks: the shares pushed sum back to the values;
    ``init`` hands every rank rank 0's value."""
    d, _ = workdir
    got = dict(np.load(d / f"kvstore_rank{rank}.npz"))
    for key in range(4):
        np.testing.assert_array_equal(got[str(key)],
                                      np.ones((8, 8), np.float32) * (key + 1))
    np.testing.assert_array_equal(got["init"], np.ones((3, 5), np.float32))


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("name", RING)
def test_ring_reduced_grads_are_the_sum_of_shard_grads(workdir, expected, name,
                                                       rank):
    """funnel/concom/depcha with the ring reducer, and rsag with its
    reduce-scatter and all-gather on the rings."""
    d, _ = workdir
    got = dict(np.load(d / f"{name}_rank{rank}.npz"))
    assert sorted(got) == sorted(expected)
    for n, want in expected.items():
        np.testing.assert_allclose(got[n], want, rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def _block_scales(buf: np.ndarray) -> np.ndarray:
    """Per-block int8 scales of ``buf`` padded as the compressed reducer
    pads it (to 256 · world)."""
    pad = (-buf.size) % (256 * WORLD)
    x = np.pad(buf, (0, pad)).reshape(-1, 256)
    return quantize_ref.quantize_ref(torch.from_numpy(x))[1].numpy()


@pytest.mark.parametrize("rank", range(WORLD))
def test_compressed_grads_are_within_the_quantization_bound(workdir, expected,
                                                            rank):
    """Per 256-element block of each bucket's buffer: |compressed − sum| is
    at most Σ_r scale_r/2 (each rank's quantization of its own buffer)
    plus scale₂/2 (the requantized reduced shard), scale₂ = max|out|/127
    of the block; plus rtol 1e-5 / atol 1e-6 against JAX's sum, as the
    flat reducer.  Buckets under 256 · world elements go flat."""
    d, _ = workdir
    name = "funnel-compressed"
    got = dict(np.load(d / f"{name}_rank{rank}.npz"))
    local = [dict(np.load(d / f"{name}_local_rank{r}.npz")) for r in range(WORLD)]
    with open(d / f"{name}_buckets.json") as f:
        buckets = json.load(f)
    assert sorted(n for b in buckets for n in b) == sorted(expected)
    n_compressed = 0
    for leaves in buckets:
        cat = lambda t: np.concatenate([t[n].ravel() for n in leaves])  # noqa: E731
        out, want = cat(got), cat(expected)
        fp = 1e-5 * np.abs(want) + 1e-6
        if out.size < 256 * WORLD:
            assert np.all(np.abs(out - want) <= fp), leaves
            continue
        n_compressed += 1
        s_sum = sum(_block_scales(cat(loc)) for loc in local)
        pad = (-out.size) % (256 * WORLD)
        s2 = np.abs(np.pad(out, (0, pad))).reshape(-1, 256).max(1) / 127
        bound = np.repeat((s_sum + s2 * (1 + 1e-6)) / 2, 256)[:out.size]
        assert np.all(np.abs(out - want) <= bound + fp), leaves
    assert n_compressed > 0


def test_compressed_ring_equals_compressed_bit_for_bit(workdir):
    """The ring gather moves the same int8 values and scales
    (tests/_mdworker.py's compressed-ring-equals-compressed)."""
    d, _ = workdir
    for rank in range(WORLD):
        a = dict(np.load(d / f"funnel-compressed_rank{rank}.npz"))
        b = dict(np.load(d / f"funnel-compressed_ring_rank{rank}.npz"))
        for n in a:
            np.testing.assert_array_equal(a[n].view(np.uint32),
                                          b[n].view(np.uint32), err_msg=n)
