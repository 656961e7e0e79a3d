"""The port's GradSync across 4 gloo ranks (spawned processes) against the
JAX package.

BatchNorm statistics are local to each rank, so a single-process full
batch is not the oracle: the expected reduced gradient is the sum over
the 4 batch shards of JAX's per-shard ``value_and_grad(train_forward)``
(each normalised by the global batch).  Tolerance rtol 1e-5 / atol 1e-6:
the per-shard gradients come from two convolution libraries, and the
4-way sum is taken in another order.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs.resnet50_cifar import make_smoke as ref_make_smoke
from repro.data import ImagePipeline as RefImagePipeline
from repro.models import resnet as ref_resnet
from repro.utils.trees import flatten_with_names as ref_flatten

WORLD = 4
GLOBAL_BATCH = 8
STRATEGIES = ("funnel", "concom", "depcha", "rsag")
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_mdworker.py")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Carried weights in, the 4 workers run, their outputs left here."""
    d = tmp_path_factory.mktemp("torch_md")
    cfg = ref_make_smoke()
    params = ref_resnet.init_params(jax.random.PRNGKey(0), cfg)
    np.savez(d / "params.npz",
             **{n: np.asarray(p) for n, p in ref_flatten(params)[0]})
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(d), str(r), str(WORLD)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
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
