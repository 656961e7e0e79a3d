"""RWKV-6 training in the port against the JAX package's, on the CPU.

The reference trains through XLA's autodiff of its jnp ``wkv_chunked``.
The port's ``kernels/rwkv6/ops.py::wkv_sequence`` is differentiable
(``_WKVSequence``: the forward writes the state each chunk starts from,
the backward recomputes every chunk at once from those and carries the
state's cotangent back through the chunks).  Held to the reference:

  - the Function's gradients (r, k, v, logw, u and the initial state)
    against ``jax.grad`` of the reference's ``wkv_chunked``, with S a
    multiple of the chunk and not, from a zero and a nonzero initial
    state, under a cotangent on y and on the final state: within 1e-5 of
    each input's largest gradient;
  - the plain version's chunk-state output against the reference's
    final state after each whole chunk;
  - ``train_forward``'s loss and every leaf's gradient against JAX's
    ``value_and_grad(train_forward)`` inside ``shard_map`` on the
    one-device smoke mesh, the constant leaves perturbed on both sides as
    ``tests/test_torch_rwkv.py`` perturbs them: within 1e-5 of each
    leaf's largest (the loss to rtol 1e-5), under every remat policy;
  - the sharding rules against the reference's; the in-backward sync's
    slots at full width (a bf16 and an f32 one a layer: ``w0`` and ``u``
    are f32); one step through ``make_train_step`` under depcha on one
    CPU rank (the f32 smoke config: one slot a layer), whose gradients
    are the plain backward's; the weight conversion of the f32 leaves,
    whole and sharded; and the launcher on the CPU.

The multi-rank cases (data 1 × model 4 and data 2 × model 2 under funnel,
concom and depcha, against the reference's tp = 1) run on the
tensor-parallel spawns of ``tests/test_torch_tp.py``, which holds them.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.rwkv6_7b import make_smoke as ref_rwkv_smoke
from repro.data import TokenPipeline as RefTokenPipeline
from repro.models import rwkv as ref_rwkv
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.configs.rwkv6_7b import make_config, make_smoke
from repro_torch.data import TokenPipeline
from repro_torch.kernels.rwkv6 import ops, ref
from repro_torch.models import rwkv
from repro_torch.models.registry import family_of
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names

GRAD_TOL = 1e-5
SEQ, BATCH = 40, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wkv_inputs(B, S, H, N, seed, nonzero_state):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(f32) for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, N)) * 0.5 - 1.0).astype(f32)
    u = (rng.standard_normal((H, N)) * 0.5).astype(f32)
    state = ((rng.standard_normal((B, H, N, N)) * 0.3).astype(f32) if nonzero_state
             else np.zeros((B, H, N, N), f32))
    gy = rng.standard_normal((B, S, H, N)).astype(f32)
    gs = rng.standard_normal((B, H, N, N)).astype(f32)
    return (r, k, v, logw, u, state), gy, gs


@pytest.mark.parametrize("S,chunk", [(32, 8), (37, 8), (5, 16)])
@pytest.mark.parametrize("nonzero_state", [False, True])
def test_wkv_gradients_match_reference(S, chunk, nonzero_state):
    ins, gy, gs = _wkv_inputs(2, S, 3, 16, seed=S, nonzero_state=nonzero_state)

    def objective(*a):
        y, st = ref_rwkv.wkv_chunked(*a, chunk)
        return jnp.sum(y * gy) + jnp.sum(st * gs)

    want = jax.grad(objective, argnums=tuple(range(6)))(*map(jnp.asarray, ins))
    t = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, st = ops.wkv_sequence(*t, chunk)
    ((y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gs)).sum()).backward()
    for name, a, w in zip(("r", "k", "v", "logw", "u", "state"), t, want):
        w = np.asarray(w)
        assert np.max(np.abs(a.grad.numpy() - w)) <= GRAD_TOL * np.max(np.abs(w)), name


def test_wkv_without_autograd_launches_as_serving():
    """No input that needs a gradient (or autograd off): the plain call,
    whose ``out=`` still takes the state in place; with one, ``out=`` is
    refused."""
    ins, _, _ = _wkv_inputs(1, 9, 2, 16, seed=0, nonzero_state=True)
    t = [torch.from_numpy(a) for a in ins]
    out = torch.empty_like(t[5])
    y, st = ops.wkv_sequence(*t, 4, out=out)
    assert st is out and not y.requires_grad
    t[0].requires_grad_(True)
    with pytest.raises(ValueError, match="out= takes no inputs"):
        ops.wkv_sequence(*t, 4, out=out)
    with torch.no_grad():
        assert ops.wkv_sequence(*t, 4, out=out)[1] is out


@pytest.mark.parametrize("S,chunk", [(32, 8), (37, 8)])
def test_plain_chunk_states_match_reference(S, chunk):
    """``wkv_sequence_ref``'s ``states``: chunk 0 starts from the initial
    state and chunk i from the reference's final state after i whole
    chunks."""
    ins, _, _ = _wkv_inputs(2, S, 3, 16, seed=1, nonzero_state=True)
    T = -(-S // chunk)
    states = torch.full((T, 2, 3, 16, 16), float("nan"))
    y, final = ref.wkv_sequence_ref(*map(torch.from_numpy, ins), chunk, states=states)
    np.testing.assert_array_equal(states[0].numpy(), ins[5])
    for i in range(1, T):
        cut = [a[:, :i * chunk] for a in ins[:4]]
        _, want = ref_rwkv.wkv_chunked(*map(jnp.asarray, cut), jnp.asarray(ins[4]),
                                       jnp.asarray(ins[5]), chunk)
        np.testing.assert_allclose(states[i].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=f"chunk {i}")


def _perturbed(ref_cfg):
    params = ref_rwkv.init_params(jax.random.PRNGKey(0), ref_cfg)
    named, treedef = ref_flatten(params)
    tree = params_from_numpy({n: np.asarray(p) for n, p in named})
    rwkv.perturb_constant_leaves(tree, seed=1)
    port = dict(flatten_with_names(tree)[0])
    arrays = {n: port[n].numpy() for n, _ in named}
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(arrays[n]) for n, _ in named]), \
        arrays


@pytest.fixture(scope="module")
def reference_step():
    import repro.launch.mesh as ref_mesh

    ref_cfg = ref_rwkv_smoke()
    params, arrays = _perturbed(ref_cfg)
    batch = RefTokenPipeline(ref_cfg.vocab, SEQ, BATCH).batch_at(1)

    def vg(p, b):
        return jax.value_and_grad(lambda q: ref_rwkv.train_forward(q, b, ref_cfg))(p)

    specs = jax.tree.map(lambda _: P(), params)
    run = jax.jit(jax.shard_map(vg, mesh=ref_mesh.make_smoke_mesh(1, 1),
                                in_specs=(specs, {k: P() for k in batch}),
                                out_specs=(P(), specs), check_vma=False))
    loss, grads = run(params, batch)
    return arrays, float(loss), {n: np.asarray(g) for n, g in ref_flatten(grads)[0]}


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_loss_and_grads_match_reference(reference_step, remat):
    arrays, want_loss, want_grads = reference_step
    cfg = dataclasses.replace(make_smoke(), remat=remat)
    model = rwkv.RWKV(cfg, params_from_numpy(arrays, "cpu"))
    loss = model(TokenPipeline(cfg.vocab, SEQ, BATCH, device="cpu").batch_at(1))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    got = dict(flatten_with_names(model.params_tree())[0])
    assert list(got) == list(want_grads)
    for n, want in want_grads.items():
        scale = np.max(np.abs(want))
        assert scale > 0, f"{n} has no gradient"
        assert np.max(np.abs(got[n].grad.numpy() - want)) <= GRAD_TOL * scale, n


def test_rules_registry_and_layer_sync(tmp_path):
    """The sharding rules against the reference's at tp = 4; the registry's
    training hooks; and one step through ``make_train_step`` under
    depcha on one CPU rank: its in-backward sync covers exactly the
    stacked leaves (a slot a dtype a layer: bf16 beside the f32 w0 and u
    at full width) and its gradients are the plain backward's."""
    import torch.distributed as dist

    from repro_torch.core import GradSyncConfig
    from repro_torch.launch.mesh import init_dist, make_smoke_mesh
    from repro_torch.optim import sgd
    from repro_torch.runtime import make_train_step

    full = make_config(tp=4)
    meta = rwkv.init_params(full, device="meta")
    ref_rules = ref_rwkv.param_rules(ref_rwkv_smoke())
    for n, _ in flatten_with_names(meta)[0]:
        assert rwkv.param_rules(full).spec(n) == tuple(ref_rules.spec(n)), n
    api = family_of(full)
    assert api.module is rwkv.RWKV and api.train_forward is rwkv.train_forward
    assert api.layer_sync is rwkv.layer_sync and api.param_specs is rwkv.param_specs
    init_dist("cpu", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        mesh = make_smoke_mesh(1)
        ls = rwkv.layer_sync(dataclasses.replace(make_config(), depcha_in_scan=True),
                             meta, mesh, "cpu")
        assert {dt for _, _, dt in ls.buckets} == {torch.bfloat16, torch.float32}
        assert len(ls.buckets) == 2
        cfg = dataclasses.replace(make_smoke(), depcha_in_scan=True)
        model = rwkv.RWKV(cfg, rwkv.perturb_constant_leaves(rwkv.init_params(cfg,
                                                                             device="cpu")))
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy="depcha"), sgd(0.0),
                             model=model, clip_norm=0.0, device="cpu")
        assert set(ts.layer_sync.names) == api.in_scan_names(model.params_tree())
        batch = TokenPipeline(cfg.vocab, SEQ, BATCH, device="cpu").batch_at(0)
        ts.fn(model, ts.init_opt(), batch, 0)
        assert ts.layer_sync.collectives == cfg.n_layers
        got = {n: p.grad.clone() for n, p in flatten_with_names(model.params_tree())[0]}
        model.zero_grad(set_to_none=True)
        model(batch).backward()
        for n, p in flatten_with_names(model.params_tree())[0]:
            torch.testing.assert_close(got[n], p.grad, rtol=0, atol=0, msg=n)
    finally:
        dist.destroy_process_group()


def test_launcher_trains_rwkv_on_cpu():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "rwkv6-7b", "--smoke",
         "--device", "cpu", "--strategy", "depcha", "--steps", "2", "--seq", "24",
         "--batch", "2"], capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[train] rwkv6-7b depcha: loss" in out.stdout


def test_params_from_numpy_carries_rwkv_f32_leaves():
    """The reference's RWKV weights (bf16, with ``w0`` and ``u`` in f32)
    into the port: each leaf's dtype and bits at tp = 1; at data 1 × model
    2 each rank's blocks (``param_rules``) put back together along the
    sharded dim are the whole leaf, ``w0`` and ``u`` split with the heads
    and still f32."""
    from repro_torch.launch.mesh import make_smoke_mesh

    ref_cfg = dataclasses.replace(ref_rwkv_smoke(), dtype=jnp.bfloat16, vocab=96)
    params = ref_rwkv.init_params(jax.random.PRNGKey(3), ref_cfg)
    arrays = {n: np.asarray(p) for n, p in ref_flatten(params)[0]}
    whole = dict(flatten_with_names(params_from_numpy(arrays))[0])
    for n, a in arrays.items():
        want = torch.float32 if n.split("/")[-1] in ("w0", "u") else torch.bfloat16
        assert whole[n].dtype == want, n
        np.testing.assert_array_equal(whole[n].float().numpy(), a.astype(np.float32),
                                      err_msg=n)
    cfg = dataclasses.replace(make_smoke(), tp=2, vocab=96)
    rules, mesh = rwkv.param_rules(cfg), make_smoke_mesh(1, 2)
    ranks = [dict(flatten_with_names(params_from_numpy(arrays, mesh=mesh, rank=r,
                                                       rules=rules))[0]) for r in range(2)]
    for n, w in whole.items():
        spec = rules.spec(n)
        got = (torch.cat([rk[n] for rk in ranks], dim=spec.index("model"))
               if "model" in spec else ranks[1][n])
        assert got.dtype == w.dtype and torch.equal(got, w), n
    assert ranks[0]["blocks/w0"].shape == (2, 32) and ranks[0]["blocks/u"].dtype == torch.float32
