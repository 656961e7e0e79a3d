"""The port's ZeRO-1 train step and gradient accumulation against the JAX
package's, on one rank (a one-rank gloo group) on the CPU.

The model is the reference's own parity model for these paths
(``tests/test_pipelined.py``: a 2-layer transformer, d 32, f32, vocab 64,
``TokenPipeline(64, 16, 4, seed=7)``), AdamW 1e-3, the reference's
weights carried over.  Against the reference's ``make_train_step``:

  - scheduled, monolithic and deferred, 3 steps, with AdamW at clip 0
    and SGD (momentum 0.9, lr 0.1) at clip 0 and 0.05: params within
    1e-6 after every step (the update-parity tolerance of
    ``tests/test_pipelined.py``), losses to rtol 1e-6, the grad norm to
    1e-6.  Deferred is held, after ``finalize``, to the reference's
    SCHEDULED step: the reference's own deferred + clip misses its
    scheduled one by 2.5e-6 at seed (``test_deferred_clip_matches_
    scheduled_clip`` fails), so it is not an expected value.  AdamW with
    a binding clip (0.05) is held to the same tolerance on the
    reference's own gradients, 3 steps (the test's docstring says why).
  - ``microbatch=4``, plain and scheduled zero1, against the reference
    with its ``accum_overlap`` on and off (the port has one order), AdamW
    at clip 0 and SGD at clip 0.05, 2 steps: the same tolerances.

And in the port, bit for bit: scheduled ≡ monolithic (clip 0), deferred
after ``finalize`` ≡ scheduled over 2 and 3 steps (with its grad norm),
the accumulators filled in the backward ≡ the plain adds after each
backward.  The LM's M = 4 run matches M = 1 within 1e-5.  The refusals (zero1 with depcha's in-backward sum at dp > 1, a
zero1 step without a zero1 optimizer) and the launcher's flags on the CPU.
"""
import copy
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import GradSyncConfig as RefGradSyncConfig
from repro.data import TokenPipeline as RefTokenPipeline
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro.optim import sgd as ref_sgd
from repro.optim import zero1 as ref_zero1
from repro.runtime import make_train_step as ref_make_train_step
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.analysis.cli import static_mesh
from repro_torch.core import GradSyncConfig
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import init_dist, make_dp_mesh
from repro_torch.models.transformer import Transformer, TransformerConfig
from repro_torch.optim import adamw, sgd, shard_size, zero1
from repro_torch.runtime import make_train_step
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names, tree_leaves

TOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(name="pipelined", n_layers=2, d_model=32, n_heads=4, kv_heads=2,
           d_ff=64, vocab=64, tp=1, attn_chunk=16)
SYNC = dict(strategy="concom", bucket_bytes=1 << 14)
OPTS = {"adamw": (lambda: ref_adamw(1e-3), lambda: adamw(1e-3)),
        "sgd": (lambda: ref_sgd(0.1, momentum=0.9), lambda: sgd(0.1, momentum=0.9))}


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group (meets on a free localhost port)."""
    init_dist("cpu")
    return make_dp_mesh()


@functools.lru_cache(maxsize=None)
def _ref_weights():
    cfg = ref_tf.TransformerConfig(**CFG, dtype=jnp.float32)
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, {n: np.asarray(p) for n, p in ref_flatten(params)[0]}


@functools.lru_cache(maxsize=None)
def _reference(mode, clip, microbatch=1, accum_overlap=True, steps=3, loss_scale=1.0,
               opt="adamw"):
    """The reference's run: per step (loss, grad norm, params by name)."""
    cfg, params, _ = _ref_weights()
    mesh = ref_smoke_mesh(1, 1)
    pipe = RefTokenPipeline(64, 16, 4, seed=7, mesh=mesh)
    kw = dict(batch_like=pipe.batch_at(0), params_like=params, clip_norm=clip,
              microbatch=microbatch, accum_overlap=accum_overlap)
    if mode is None:
        ts = ref_make_train_step(cfg, mesh, RefGradSyncConfig(**SYNC, loss_scale=loss_scale),
                                 OPTS[opt][0](), **kw)
    else:
        ts = ref_make_train_step(
            cfg, mesh, RefGradSyncConfig(**SYNC, exclude_axes=("data",),
                                         loss_scale=loss_scale),
            ref_zero1(OPTS[opt][0](), ("data",), 1), zero1_mode=True,
            zero1_plan=mode, **kw)
    p, s = params, ts.init_opt()
    out = []
    for k in range(steps):
        p, s, m = ts.fn(p, s, pipe.batch_at(k), jnp.int32(k))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {n: np.asarray(v) for n, v in ref_flatten(p)[0]}))
    return out


def _step(mode, clip, *, microbatch=1, loss_scale=1.0,
          strategy="concom", in_scan=False, mesh=None, opt="adamw"):
    """The port's step on the reference's weights: (ts, model, pipe)."""
    _, _, named = _ref_weights()
    cfg = TransformerConfig(**CFG, dtype=torch.float32, depcha_in_scan=in_scan)
    mesh = mesh or make_dp_mesh()
    model = Transformer(cfg, params_from_numpy(named, "cpu"))
    sync = GradSyncConfig(**dict(SYNC, strategy=strategy), loss_scale=loss_scale)
    inner = OPTS[opt][1]()
    opt = inner if mode is None else zero1(inner, ("data",), 1)
    ts = make_train_step(cfg, mesh, sync, opt, model=model, clip_norm=clip,
                         zero1_mode=mode is not None, zero1_plan=mode or "scheduled",
                         microbatch=microbatch, device="cpu")
    return ts, model, TokenPipeline(64, 16, 4, seed=7, mesh=mesh, device="cpu")


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in flatten_with_names(model.params_tree())[0]}


def _finalized(ts, model, state) -> dict:
    """The params a deferred run holds once its carry is flushed, leaving
    the run itself as it was."""
    model, state = copy.deepcopy(model), copy.deepcopy(state)
    ts.finalize(model, state)
    return _params(model)


def _run(mode, clip, steps=3, **kw):
    """The port's run: per step (loss, grad norm, params, opt_state)."""
    ts, model, pipe = _step(mode, clip, **kw)
    state = ts.init_opt()
    out = []
    for k in range(steps):
        model, state, m = ts.fn(model, state, pipe.batch_at(k), k)
        params = _finalized(ts, model, state) if mode == "deferred" else _params(model)
        out.append((float(m["loss"]), float(m["grad_norm"]), params,
                    copy.deepcopy(state)))
    return out


def _max_diff(got: dict, want: dict) -> float:
    assert list(got) == list(want)
    return max(float(np.max(np.abs(got[n].numpy() - want[n]))) for n in want)


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[n], b[n]) for n in a)


# (optimizer, clip): AdamW's clipped steps are held on the reference's own
# gradients (``test_clipped_adamw_update_on_the_reference_gradients``)
STEP_CASES = (("adamw", 0.0), ("sgd", 0.0), ("sgd", 0.05))


@pytest.mark.parametrize("opt,clip", STEP_CASES)
@pytest.mark.parametrize("mode", ["scheduled", "monolithic", "deferred"])
def test_zero1_step_matches_reference(group, mode, opt, clip):
    want = _reference("scheduled" if mode == "deferred" else mode, clip, opt=opt)
    got = _run(mode, clip, opt=opt)
    for k, ((loss, gnorm, params, _), (r_loss, r_gnorm, r_params)) in enumerate(
            zip(got, want)):
        assert loss == pytest.approx(r_loss, rel=TOL), k
        assert abs(gnorm - r_gnorm) < TOL, k
        assert _max_diff(params, r_params) < TOL, (mode, opt, clip, k)
    if clip and mode != "monolithic":
        assert got[0][1] > clip               # the clip bound
    if mode == "monolithic":
        assert all(g == 0.0 for _, g, _, _ in got)   # it does not clip


@functools.lru_cache(maxsize=None)
def _ref_grads(steps):
    """The reference's gradients at its initial weights, batch k each."""
    cfg, params, _ = _ref_weights()
    mesh = ref_smoke_mesh(1, 1)
    pipe = RefTokenPipeline(64, 16, 4, seed=7, mesh=mesh)
    specs = jax.tree.map(lambda _: P(), params)
    run = jax.jit(jax.shard_map(
        lambda p, b: jax.grad(lambda q: ref_tf.train_forward(q, b, cfg))(p),
        mesh=mesh, in_specs=(specs, {k: P() for k in pipe.batch_at(0)}),
        out_specs=specs, check_vma=False))
    return [run(params, pipe.batch_at(k)) for k in range(steps)]


def test_clipped_adamw_update_on_the_reference_gradients(group):
    """The StepProgram's RS → NORM → UPDATE (AdamW) → AG with a binding
    clip, 3 steps, fed the reference's own gradients on both sides: the
    params within 1e-6, the grad norm to rtol 1e-6.  (End to end the
    two models' f32 gradients differ in their last bits, and AdamW at eps
    1e-8 turns an absolute difference δ of a gradient below eps into
    about δ·lr/eps of update: after a clip to 0.05 the plain path too
    differs from the reference by 1.6e-5 at step 1.)"""
    from repro.core import GradSync as RefGradSync
    from repro.optim import apply_updates as ref_apply_updates
    from repro.optim.zero import scheduled_update as ref_scheduled_update
    from repro.optim.zero import zero1_state_structs
    from repro_torch.core import GradSync
    from repro_torch.models.transformer import param_specs
    from repro_torch.optim import apply_updates, scheduled_update, zero1_state
    from repro_torch.utils.trees import tree_unflatten

    clip, steps = 0.05, 3
    cfg, params, named = _ref_weights()
    mesh = ref_smoke_mesh(1, 1)
    ref_specs = ref_tf.param_rules(cfg).tree_specs(params)
    zcfg = dict(SYNC, exclude_axes=("data",), zero1_dp_axes=("data",), zero1_clip=True)
    gs = RefGradSync(RefGradSyncConfig(**zcfg), mesh, ref_specs, jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params))
    inner = ref_adamw(1e-3)
    state = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                         zero1_state_structs(inner, gs.dp_plan, 1))

    def one(p, st, g, step):
        update_fn, new_state = ref_scheduled_update(inner, gs.dp_plan, p, st, step,
                                                    dp_size=1)
        aux: dict = {}
        upd = gs(g, update_fn=update_fn, clip_norm=clip, aux=aux)
        return ref_apply_updates(p, upd), new_state, aux["grad_norm"]

    def rep(tree):
        return jax.tree.map(lambda _: P(), tree)

    run = jax.jit(jax.shard_map(
        one, mesh=mesh, in_specs=(rep(params), rep(state), rep(params), P()),
        out_specs=(rep(params), rep(state), P()), check_vma=False))

    tcfg = TransformerConfig(**CFG, dtype=torch.float32)
    tree = params_from_numpy(named, "cpu")
    t_named, treedef = flatten_with_names(tree)
    port_gs = GradSync(GradSyncConfig(**zcfg), make_dp_mesh(), param_specs(tree, tcfg),
                       tree, device="cpu")
    t_inner = adamw(1e-3)
    t_state = zero1_state(t_inner, port_gs.dp_plan, 1, torch.device("cpu"))
    p = params
    for k, g in enumerate(_ref_grads(steps)):
        p, state, r_norm = run(p, state, g, jnp.int32(k))
        grads = [torch.from_numpy(np.array(x)) for _, x in ref_flatten(g)[0]]
        update_fn, new_state = scheduled_update(t_inner, port_gs.dp_plan, tree, t_state,
                                                k, dp_size=1, rank=0)
        aux: dict = {}
        upd = port_gs(tree_unflatten(treedef, grads), update_fn=update_fn,
                      clip_norm=clip, aux=aux)
        apply_updates(dict(t_named), dict(flatten_with_names(upd)[0]))
        t_state = new_state
        assert float(r_norm) > clip
        assert float(aux["grad_norm"]) == pytest.approx(float(r_norm), rel=TOL), k
        want = {n: np.asarray(v) for n, v in ref_flatten(p)[0]}
        assert _max_diff(dict(t_named), want) < TOL, k


def test_scheduled_clip_unaffected_by_loss_scale(group):
    """The NORM op sees loss-scaled shards and undoes the scale: the
    clipped step matches the reference's at loss scale 1024 (SGD)."""
    want = _reference("scheduled", 0.05, loss_scale=1024.0, opt="sgd")
    got = _run("scheduled", 0.05, loss_scale=1024.0, opt="sgd")
    assert got[0][1] > 0.05
    for (_, gnorm, params, _), (_, r_gnorm, r_params) in zip(got, want):
        assert gnorm == pytest.approx(r_gnorm, rel=1e-5)
        assert _max_diff(params, r_params) < TOL


def test_scheduled_is_monolithic_bit_for_bit(group):
    sched, mono = _run("scheduled", 0.0), _run("monolithic", 0.0)
    for (l_s, _, p_s, st_s), (l_m, _, p_m, st_m) in zip(sched, mono):
        assert l_s == l_m
        assert _same(p_s, p_m)
    # the same moments, as one shard or a bucket's shard each
    flat = torch.cat([t.reshape(-1) for t in tree_leaves(st_s["inner"])])
    assert sum(t.numel() for t in tree_leaves(st_m["inner"])) == flat.numel()


@pytest.mark.parametrize("steps", [2, 3])
@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_deferred_after_finalize_is_scheduled_bit_for_bit(group, clip, steps):
    sched = _run("scheduled", clip, steps=steps)
    ts, model, pipe = _step("deferred", clip)
    state = ts.init_opt()
    for k in range(steps):
        model, state, m = ts.fn(model, state, pipe.batch_at(k), k)
        assert float(m["grad_norm"]) == sched[k][1]
        assert float(m["loss"]) == sched[k][0]
    for (a, b) in zip(tree_leaves(state["inner"]), tree_leaves(sched[-1][3]["inner"])):
        assert torch.equal(a, b)
    ts.finalize(model, state)
    assert _same(_params(model), sched[-1][2])
    # the carry is spent: a second flush changes nothing
    before = _params(model)
    ts.finalize(model, state)
    assert _same(_params(model), before)


def test_deferred_carries_the_update_shards(group):
    ts, model, pipe = _step("deferred", 0.0)
    state = ts.init_opt()
    assert set(state["pending"]) == set(state["inner"])
    assert all(float(v.abs().max()) == 0.0 for v in state["pending"].values())
    before = _params(model)
    model, state, _ = ts.fn(model, state, pipe.batch_at(0), 0)
    # the gathers wait for the next step: the params have not moved yet
    assert _same(_params(model), before)
    assert any(float(v.abs().max()) > 0.0 for v in state["pending"].values())
    sizes = {k: v.numel() for k, v in state["pending"].items()}
    assert sizes == {str(i): b.size for i, b in enumerate(ts.gradsync.dp_plan.buckets)}
    assert not _same(_finalized(ts, model, state), before)


@pytest.mark.parametrize("opt,clip", (("adamw", 0.0), ("sgd", 0.05)))
@pytest.mark.parametrize("ref_overlap", [True, False])
@pytest.mark.parametrize("mode", [None, "scheduled"])
def test_accumulation_matches_reference(group, mode, ref_overlap, opt, clip):
    """The port's one accumulation order against both of the reference's
    (its ``accum_overlap`` peels the last microbatch out of the scan)."""
    want = _reference(mode, clip, microbatch=4, accum_overlap=ref_overlap, steps=2,
                      opt=opt)
    got = _run(mode, clip, steps=2, microbatch=4, opt=opt)
    for k, ((loss, gnorm, params, _), (r_loss, r_gnorm, r_params)) in enumerate(
            zip(got, want)):
        assert loss == pytest.approx(r_loss, rel=TOL), k
        assert gnorm == pytest.approx(r_gnorm, rel=1e-5), k
        assert _max_diff(params, r_params) < TOL, k


def _plain_accumulation(model, batch, microbatch) -> dict:
    """Each microbatch's forward and backward, then ``acc + g`` in f32
    from zero, divided by M: the reference's order, written out."""
    from repro_torch.models.registry import family_of
    from repro_torch.runtime.train_loop import split_microbatches

    api = family_of(model.cfg)
    named = flatten_with_names(model.params_tree())[0]
    acc = {n: torch.zeros(p.shape, dtype=torch.float32) for n, p in named}
    for mb in split_microbatches(batch, microbatch):
        model.zero_grad(set_to_none=True)
        api.train_forward(model.params_tree(), mb, model.cfg).backward()
        acc = {n: acc[n] + p.grad.float() for n, p in named}
    model.zero_grad(set_to_none=True)
    return {n: a / microbatch for n, a in acc.items()}


@pytest.mark.parametrize("mode", [None, "scheduled", "deferred", "monolithic"])
def test_accumulation_in_the_backward_is_the_plain_order(group, mode, monkeypatch):
    """The step's adds run in the backward, from post-accumulate-grad
    hooks: the gradients it hands GradSync, 2 steps, equal the plain
    adds after each backward bit for bit."""
    ts, model, pipe = _step(mode, 0.05, microbatch=4)
    handed = []
    call = type(ts.gradsync).__call__

    def spy(self, grads, *args, **kw):
        handed.append({n: g.detach().clone() for n, g in flatten_with_names(grads)[0]})
        return call(self, grads, *args, **kw)

    monkeypatch.setattr(type(ts.gradsync), "__call__", spy)
    state = ts.init_opt()
    for k in range(2):
        at = copy.deepcopy(model)
        if mode == "deferred":
            ts.finalize(at, copy.deepcopy(state))   # the step's top applies the carry
        want = _plain_accumulation(at, pipe.batch_at(k), 4)
        model, state, _ = ts.fn(model, state, pipe.batch_at(k), k)
        assert len(handed) == k + 1
        assert list(handed[k]) == list(want)
        assert _same(handed[k], want), k


@pytest.mark.parametrize("mode", [None, "scheduled"])
def test_lm_microbatch_4_matches_1(group, mode):
    """The mean over microbatches, not the sum: the same global batch
    split 4 ways trains the same trajectory (AdamW, as the reference's
    ``test_microbatch_count_does_not_scale_training``)."""
    m1 = _run(mode, 0.0, steps=3)
    m4 = _run(mode, 0.0, steps=3, microbatch=4)
    for (l1, g1, p1, _), (l4, g4, p4, _) in zip(m1, m4):
        assert l4 == pytest.approx(l1, rel=1e-5)
        assert g4 == pytest.approx(g1, rel=1e-5)
        assert max(float((p1[n] - p4[n]).abs().max()) for n in p1) < 1e-5


def test_microbatch_under_depcha_in_scan(group):
    """The in-backward sync runs once a microbatch: its rows are
    accumulated like every other leaf."""
    plain = _run(None, 0.05, steps=2, microbatch=2)
    ts, model, pipe = _step(None, 0.05, microbatch=2, strategy="depcha", in_scan=True)
    assert ts.layer_sync is not None
    state = ts.init_opt()
    for k, (loss, _, params, _) in enumerate(plain):
        model, state, m = ts.fn(model, state, pipe.batch_at(k), k)
        assert float(m["loss"]) == loss
        assert _same(_params(model), params)


def test_zero1_state_is_sharded_and_sized_from_the_plan(group):
    ts, model, _ = _step("scheduled", 0.05)
    state = ts.init_opt()
    dp_plan = ts.gradsync.dp_plan
    assert set(state["inner"]) == {str(i) for i in range(len(dp_plan.buckets))}
    for i, b in enumerate(dp_plan.buckets):
        inner = state["inner"][str(i)]
        assert {k: tuple(v["shard"].shape) for k, v in inner.items()} == {
            "m": (shard_size(b.size, 1),), "v": (shard_size(b.size, 1),)}
    n = sum(p.numel() for p in model.parameters())
    assert sum(b.size for b in dp_plan.buckets) == n
    kinds = ts.gradsync.schedule.stats()["kinds"]
    assert kinds["update"] == kinds["reduce_scatter"] == kinds["all_gather"] == len(dp_plan.buckets)
    assert kinds["norm"] == 1


def test_zero1_with_in_scan_sum_refused_at_dp_above_1(group):
    """The reference sums depcha's in-scan leaves twice under zero1 at dp
    > 1 (``test_torch_multirank.py`` shows it); the port refuses."""
    with pytest.raises(ValueError, match="twice"):
        _step("scheduled", 0.0, strategy="depcha", in_scan=True,
              mesh=static_mesh({"data": 2, "model": 1}))
    # dp = 1 sums once (the in-backward group is one rank)
    ts, _, _ = _step("scheduled", 0.0, strategy="depcha", in_scan=True)
    assert ts.layer_sync is not None


def test_zero1_mode_needs_a_zero1_optimizer(group):
    _, _, named = _ref_weights()
    cfg = TransformerConfig(**CFG, dtype=torch.float32)
    model = Transformer(cfg, params_from_numpy(named, "cpu"))
    with pytest.raises(ValueError, match="go together"):
        make_train_step(cfg, make_dp_mesh(), GradSyncConfig(**SYNC), adamw(1e-3),
                        model=model, zero1_mode=True, device="cpu")
    with pytest.raises(ValueError, match="zero1_plan"):
        make_train_step(cfg, make_dp_mesh(), GradSyncConfig(**SYNC),
                        zero1(adamw(1e-3), ("data",), 1), model=model,
                        zero1_mode=True, zero1_plan="bogus", device="cpu")


def test_ring_reduce_scatter_handle_is_recorded_after_the_ring(group, monkeypatch):
    """A reduce-scatter on the ring transport records its handle's event
    after the ring's work: the NORM, on a stream of its own, reads the
    shard once that event has fired (recorded before the ring, it read
    partial sums over NCCL)."""
    import torch.distributed as dist

    from repro_torch.core import dependency as dep
    from repro_torch.core import schedule as sched
    from repro_torch.core.buckets import Bucket, BucketPlan, LeafInfo
    from repro_torch.parallel.sharding import Mesh

    log = []

    class Event:
        def __init__(self, device):
            log.append(self)

        def wait(self):
            return True

    def ring_rs(buf, axes, mesh_shape, comm):
        log.append("ring")
        return buf.view(4, -1)[0].clone()

    monkeypatch.setattr(dep, "Recorded", Event)
    monkeypatch.setattr(sched.coll_ops, "ring_reduce_scatter", ring_rs)
    leaf = LeafInfo("w", 0, (8,), torch.float32, 8)
    bucket = Bucket((leaf,), ("data",), 0, 0, comm_dtype=torch.float32)
    plan = BucketPlan((bucket,), flatten_with_names([torch.zeros(8)])[1], 1, torch.float32)
    rs = sched.CollectiveOp(op_id=0, bucket=bucket, chain=0, kind=sched.REDUCE_SCATTER)
    em = sched._OpEmitter(sched.CommSchedule((rs,)), plan, reducer=None,
                          groups={0: dep.ChainComms({("data",): dist.group.WORLD},
                                                    Mesh(("data",), {"data": 4}))},
                          mesh_shape={"data": 4},
                          two_phase_impl="ring")
    em.emit(rs, [torch.arange(8.0)])
    assert log.index(em.handles[0]._work) > log.index("ring")
    assert torch.equal(em.handles[0].out, torch.arange(2.0))


@pytest.mark.parametrize("plan", ["scheduled", "deferred", "monolithic"])
def test_launcher_zero1_and_microbatch_on_the_cpu(plan):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b",
         "--smoke", "--device", "cpu", "--strategy", "concom", "--zero1",
         "--zero1-plan", plan, "--microbatch", "4", "--steps", "2", "--seq", "32",
         "--batch", "8"], capture_output=True, text=True, timeout=300, env=env,
        cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[train] qwen3-1.7b concom: loss" in res.stdout
