"""The port's data-parallel train step against the JAX package's, on the
ResNet smoke config with carried weights and identical batches, on a
one-rank gloo group: 3 steps of funnel, concom and depcha at
``clip_norm=1.0``.  Losses agree to rtol 1e-4 and params to atol 1e-4
(f32 convolutions summed in another order, compounded over 3 steps); the
port's three strategies are bit-identical to each other (same math, only
the schedule differs).  Also the entry points: the launcher runs on the
CPU, CUDA requested without a card raises, and the paper's KVStore API
records the reference's IR.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.resnet50_cifar import make_smoke as ref_make_smoke
from repro.core import GradSyncConfig as RefGradSyncConfig
from repro.core import KVStore as RefKVStore
from repro.data import ImagePipeline as RefImagePipeline
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.models import resnet as ref_resnet
from repro.optim import linear_scaling_rule as ref_lsr
from repro.optim import sgd as ref_sgd
from repro.runtime import make_train_step as ref_make_train_step
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.configs.resnet50_cifar import make_smoke
from repro_torch.core import GradSyncConfig, KVStore
from repro_torch.data import ImagePipeline
from repro_torch.launch.mesh import init_dist, make_dp_mesh
from repro_torch.models.resnet import ResNet, init_params
from repro_torch.optim import linear_scaling_rule, sgd
from repro_torch.runtime import make_train_step
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names

STRATEGIES = ("funnel", "concom", "depcha")
STEPS, BATCH = 3, 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group (meets on a free localhost port)."""
    init_dist("cpu")
    return make_dp_mesh()


@pytest.fixture(scope="module")
def ref_weights():
    cfg = ref_make_smoke()
    params = ref_resnet.init_params(jax.random.PRNGKey(0), cfg)
    return params, {n: np.asarray(p) for n, p in ref_flatten(params)[0]}


def _run_reference(strategy, ref_weights):
    cfg = ref_make_smoke()
    mesh = ref_smoke_mesh(1, 1)
    params, _ = ref_weights
    pipe = RefImagePipeline(cfg.img_size, cfg.num_classes, BATCH, mesh=mesh)
    opt = ref_sgd(ref_lsr(0.1, 256, 256), momentum=0.9)
    ts = ref_make_train_step(
        cfg, mesh, RefGradSyncConfig(strategy=strategy, num_channels=4), opt,
        batch_like=pipe.batch_at(0), params_like=params, clip_norm=1.0)
    opt_state = opt.init(params)
    losses = []
    for step in range(STEPS):
        params, opt_state, m = ts.fn(params, opt_state, pipe.batch_at(step),
                                     jnp.int32(step))
        losses.append(float(m["loss"]))
    return losses, {n: np.asarray(p) for n, p in ref_flatten(params)[0]}


def _run_port(strategy, named, mesh):
    cfg = make_smoke()
    model = ResNet(cfg, params_from_numpy(named, "cpu"))
    opt = sgd(linear_scaling_rule(0.1, 256, 256), momentum=0.9)
    ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strategy,
                                                   num_channels=4),
                         opt, model=model, clip_norm=1.0, device="cpu")
    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, BATCH, mesh=mesh,
                         device="cpu")
    params = dict(flatten_with_names(model.params_tree())[0])
    opt_state = opt.init(params)
    losses = []
    for step in range(STEPS):
        model, opt_state, m = ts.fn(model, opt_state, pipe.batch_at(step), step)
        losses.append(m["loss"].item())
    return losses, {n: p.detach().clone() for n, p in params.items()}


@pytest.fixture(scope="module")
def port_runs(group, ref_weights):
    return {s: _run_port(s, ref_weights[1], group) for s in STRATEGIES}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_three_steps_match_reference(strategy, ref_weights, port_runs):
    want_losses, want_params = _run_reference(strategy, ref_weights)
    losses, params = port_runs[strategy]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert list(params) == list(want_params)
    for n, p in params.items():
        np.testing.assert_allclose(p.numpy(), want_params[n], atol=1e-4,
                                   rtol=0, err_msg=n)


def test_strategies_are_bit_identical(port_runs):
    base_losses, base = port_runs[STRATEGIES[0]]
    for s in STRATEGIES[1:]:
        losses, params = port_runs[s]
        assert losses == base_losses, s
        for n, p in params.items():
            assert torch.equal(p, base[n]), (s, n)


def test_kvstore_depcha_roundtrip_and_ir_match_reference(group):
    """examples/paper_repro.py::paper_api_demo: push all keys, then pull —
    the values come back, and the recorded IR equals the reference's."""
    grads = {k: np.ones((8, 8), np.float32) * (k + 1) for k in range(4)}
    ref_kv = []

    def train_iter(g):
        kv = RefKVStore.create("depcha", reduce_axes=("data",), num_channels=2)
        ref_kv.append(kv)
        for key in range(4):
            kv.push(key, g[key])
        return {key: kv.pull(key) for key in range(4)}

    specs = {k: P() for k in grads}
    ref_out = jax.jit(lambda g: jax.shard_map(
        train_iter, mesh=ref_smoke_mesh(1, 1), in_specs=(specs,),
        out_specs=specs, check_vma=False)(g))({k: jnp.asarray(v) for k, v in grads.items()})

    kv = KVStore.create("depcha", reduce_axes=("data",), num_channels=2,
                        device="cpu")
    for key in range(4):
        kv.push(key, torch.from_numpy(grads[key]))
    for key in range(4):
        out = kv.pull(key)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out[key]))
        np.testing.assert_array_equal(out.numpy(), grads[key])

    def fields(s):
        return [(op.op_id, op.bucket.bucket_id, op.chain, op.depends_on,
                 op.kind) for op in s.ops]

    assert fields(kv.schedule()) == fields(ref_kv[0].schedule(verify=False))


@pytest.mark.parametrize("kind", ["funnel", "concom", "rsag"])
def test_kvstore_init_barrier_ir_matches_reference(group, kind):
    """init (broadcast from rank 0), pushes around a barrier(), pulls: the
    values come back and the recorded IR — barrier joins included —
    equals the reference's."""
    vals = {k: np.arange(6, dtype=np.float32).reshape(2, 3) * (k + 1)
            for k in range(3)}
    ref_kv = []

    def body(g):
        kv = RefKVStore.create(kind, reduce_axes=("data",), num_channels=2,
                               mesh_shape={"data": 1, "model": 1})
        ref_kv.append(kv)
        out = {0: kv.init(0, g[0])}
        kv.push(1, g[1])
        kv.barrier()
        kv.push(2, g[2])
        out[1], out[2] = kv.pull(1), kv.pull(2)
        return out

    specs = {k: P() for k in vals}
    jax.jit(lambda g: jax.shard_map(
        body, mesh=ref_smoke_mesh(1, 1), in_specs=(specs,), out_specs=specs,
        check_vma=False)(g))({k: jnp.asarray(v) for k, v in vals.items()})

    kv = KVStore.create(kind, reduce_axes=("data",), num_channels=2,
                        mesh_shape={"data": 1, "model": 1}, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in vals.items()}
    out = {0: kv.init(0, t[0])}
    kv.push(1, t[1])
    kv.barrier()
    kv.push(2, t[2])
    out[1], out[2] = kv.pull(1), kv.pull(2)
    for k in vals:
        np.testing.assert_array_equal(out[k].numpy(), vals[k])

    def fields(s):
        return [(op.op_id, op.bucket.bucket_id, op.chain, op.depends_on,
                 op.kind) for op in s.ops]

    assert fields(kv.schedule()) == fields(ref_kv[0].schedule(verify=False))


@pytest.mark.parametrize("strategy", ["depcha", "rsag"])
@pytest.mark.parametrize("fused,loss_scale", [(True, 1.0), (False, 1.0),
                                              (True, 64.0), (False, 64.0)])
def test_gradsync_staging_paths_agree(group, strategy, fused, loss_scale):
    """Every staging branch of the emitter — fused, plain, loss-scaled, and
    the leafwise path an int bucket takes — reduces to the same values
    (one rank: the sum is the identity)."""
    from repro_torch.core import GradSync

    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)),
            "b": [torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
                  torch.arange(6, dtype=torch.int32).reshape(2, 3)]}
    want = {n: t.clone() for n, t in flatten_with_names(tree)[0]}
    specs = {"w": (), "b": [(), ()]}
    gs = GradSync(GradSyncConfig(strategy=strategy, bucket_bytes=32,
                                 use_fused_staging=fused,
                                 loss_scale=loss_scale),
                  group, specs, tree, device="cpu")
    got = dict(flatten_with_names(gs(tree))[0])
    assert list(got) == list(want)
    for n, t in want.items():
        assert got[n].dtype == t.dtype and torch.equal(got[n], t), n


def test_cuda_requested_without_a_card_raises(group):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; nothing to refuse")
    cfg = make_smoke()
    model = ResNet(cfg, init_params(cfg))
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(cfg, group, GradSyncConfig(), sgd(0.1), model=model)


def test_launcher_trains_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "resnet50-cifar", "--smoke", "--steps", "2", "--device", "cpu",
         "--strategy", "concom"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "[train] resnet50-cifar concom: loss" in res.stdout
