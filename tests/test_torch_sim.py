"""The port's simulator (``repro_torch.sim``) against the JAX package's
(``repro.sim``), on the same schedules and the same model values.

Schedules: the reference analyzer's valid cases (the five strategies, the
zero1 StepPrograms with and without deferred gathers, a ``plan_reshard``
transition, gpipe and 1f1b programs and a pp × zero1 joint program),
carried into the port's IR by ``test_torch_plan._from_reference``, on
the meshes {data 8}, {data 2, model 4}, {pod 2, data 2} and the case's
own.  The model values are the port's defaults, handed to the reference
as explicit objects (the two packages' defaults differ: the port's are an
H100's, the reference's a TPU's).

Tolerance: none.  Both simulators are float64 over the same arithmetic
in the same order, so every event time, every ranking and every
``Prediction`` must be bit-equal; so must the Chrome trace and the
decode plans.  Also the port's DECODE op runs through ``execute`` as a
scheduling point (``aux["decode_nodes"]``).
"""
import dataclasses

import jax
import pytest
import torch

import repro.sim as R
from repro.analysis import cli as ref_cli
from repro.analysis import mutations as ref_mutations
from repro.configs import qwen3_1_7b as ref_qwen3
from repro.core.buckets import make_bucket_plan as ref_make_bucket_plan
from repro.core.pipeline_program import plan_pipeline as ref_plan_pipeline
from repro.core.stepprogram import zero1_bucket_plan as ref_zero1_bucket_plan
from repro.sim import compute as ref_compute
from repro.sim import netmodel as ref_netmodel
from repro_torch import sim as T
from repro_torch.analysis import cli as port_cli
from repro_torch.configs import qwen3_1_7b as qwen3
from repro_torch.core import dependency as dep
from repro_torch.core.buckets import BucketPlan, make_bucket_plan
from repro_torch.core.pipeline_program import plan_pipeline
from repro_torch.core.schedule import execute
from repro_torch.core.stepprogram import zero1_bucket_plan
from repro_torch.utils.trees import flatten_with_names

from test_torch_plan import _from_reference

MESHES = ({"data": 8}, {"data": 2, "model": 4}, {"pod": 2, "data": 2})
COMPUTE = T.ComputeModel(t_fwd=1.5e-4, t_bwd=3e-4, n_stages=4)
SIMS = (T.SimConfig(),
        T.SimConfig(window=2, itemsize=2, reducer="hierarchical", fused_staging=False),
        T.SimConfig(drop_chain_deps=True, per_stage_release=True, reducer="compressed"))


def ref_net(net: T.NetworkModel) -> R.NetworkModel:
    """The reference's NetworkModel with the port's model's values."""
    def link(lk):
        return ref_netmodel.LinkModel(lk.name, bandwidth=lk.bandwidth, latency=lk.latency)
    st = net.staging
    return ref_netmodel.NetworkModel(
        links=tuple((a, link(lk)) for a, lk in net.links),
        default_link=link(net.default_link), quantize_bw=net.quantize_bw,
        staging=ref_compute.StagingModel(
            hbm_bw=st.hbm_bw, leaf_overhead=st.leaf_overhead,
            fused_passes=st.fused_passes, leafwise_passes=st.leafwise_passes))


def ref_cm(cm: T.ComputeModel | None):
    if cm is None:
        return None
    u = cm.update
    return ref_compute.ComputeModel(
        t_fwd=cm.t_fwd, t_bwd=cm.t_bwd, n_stages=cm.n_stages,
        update=ref_compute.UpdateModel(hbm_bw=u.hbm_bw, passes=u.passes,
                                       overhead=u.overhead))


def ref_sim(sim: T.SimConfig) -> R.SimConfig:
    return R.SimConfig(**dataclasses.asdict(sim))


def events(tl) -> list:
    return [(e.op_id, e.bucket_id, e.chain, e.kind, e.nbytes, e.release, e.start, e.end)
            for e in tl.events]


def same_timeline(got, want) -> None:
    assert events(got) == events(want)
    assert (got.t_fwd, got.t_bwd) == (want.t_fwd, want.t_bwd)
    assert got.stats() == want.stats()


def _cases():
    return [(n, s, c) for n, s, c in ref_mutations.valid_cases()]


@pytest.mark.parametrize("name,schedule,ctx", _cases(), ids=[c[0] for c in _cases()])
def test_simulate_matches_reference_bit_for_bit(name, schedule, ctx):
    net = T.default_network()
    own = ctx.get("mesh_shape") or ctx["old_mesh_shape"]
    port = _from_reference(schedule)
    for mesh_shape in MESHES + (own,):
        for sim in SIMS:
            same_timeline(
                T.simulate(port, mesh_shape, compute=COMPUTE, net=net, sim=sim),
                R.simulate(schedule, mesh_shape, compute=ref_cm(COMPUTE),
                           net=ref_net(net), sim=ref_sim(sim)))


def test_simulate_pipelined_matches_reference():
    net = T.default_network()
    for name, schedule, ctx in _cases():
        if not ctx.get("expect_defer"):
            continue
        post, pre = schedule.split_phases()
        ppost, ppre = _from_reference(schedule).split_phases()
        for mesh_shape in MESHES:
            for window in (None, 1e-5):
                got = T.simulate_pipelined(ppost, ppre, mesh_shape, compute=COMPUTE,
                                           net=net, pre_window=window)
                want = R.simulate_pipelined(post, pre, mesh_shape, compute=ref_cm(COMPUTE),
                                            net=ref_net(net), pre_window=window)
                same_timeline(got, want)
                assert got.pure_compute == want.pure_compute
                assert got.exposed_comm == want.exposed_comm


@pytest.mark.parametrize("kind,S,M,v", [("gpipe", 2, 4, 1), ("gpipe", 4, 6, 1),
                                        ("1f1b", 2, 4, 1), ("1f1b", 4, 8, 1),
                                        ("interleaved", 2, 4, 2)])
def test_pipeline_timeline_and_choice_match_reference(kind, S, M, v):
    got_plan = plan_pipeline(S, M, kind=kind, virtual=v, activation_bytes=4096)
    want_plan = ref_plan_pipeline(S, M, kind=kind, virtual=v, activation_bytes=4096)
    for wire in (0.0, 3e-6, 1e-3):
        got = T.pipeline_timeline(got_plan, COMPUTE, wire_time=wire)
        want = R.pipeline_timeline(want_plan, ref_cm(COMPUTE), wire_time=wire)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.bubble_fraction == want.bubble_fraction
    net = T.default_network()
    for act in (0, 1 << 20, 1 << 30):
        assert T.choose_pp_schedule(S, M, virtual=v, activation_bytes=act, compute=COMPUTE,
                                    net=net) == R.choose_pp_schedule(
            S, M, virtual=v, activation_bytes=act, compute=ref_cm(COMPUTE), net=ref_net(net))


def _plans(mesh_name, zero1=False, **kw):
    """(port, reference) bucket plans of the analyzer's stand-in model."""
    mesh_shape, model_axis = port_cli.MESHES[mesh_name]
    grads, specs = port_cli._model(model_axis)
    ref_grads, ref_specs = ref_cli._model(model_axis)
    mesh, ref_mesh = port_cli.static_mesh(mesh_shape), ref_cli.StaticMesh(mesh_shape)
    if zero1:
        return (zero1_bucket_plan(grads, specs, mesh, dp_axes=("data",), **kw),
                ref_zero1_bucket_plan(ref_grads, ref_specs, ref_mesh, dp_axes=("data",), **kw))
    return (make_bucket_plan(grads, specs, mesh, **kw),
            ref_make_bucket_plan(ref_grads, ref_specs, ref_mesh, **kw))


@pytest.mark.parametrize("mesh_name", sorted(port_cli.MESHES))
def test_rank_strategies_and_step_plans_match_reference(mesh_name):
    net = T.default_network()
    mesh_shape = port_cli.MESHES[mesh_name][0]
    plan, ref_plan = _plans(mesh_name, bucket_bytes=256 * 1024, num_channels=4)
    for sim in SIMS[:2]:
        for in_scan in (True, False):
            got = T.rank_strategies(plan, mesh_shape, compute=COMPUTE, net=net, sim=sim,
                                    in_scan_active=in_scan)
            want = R.rank_strategies(ref_plan, mesh_shape, compute=ref_cm(COMPUTE),
                                     net=ref_net(net), sim=ref_sim(sim),
                                     in_scan_active=in_scan)
            assert [n for n, _ in got] == [n for n, _ in want]
            for (_, g), (_, w) in zip(got, want):
                same_timeline(g, w)
    dp_plan, ref_dp_plan = _plans(mesh_name, zero1=True, bucket_bytes=256 * 1024,
                                  num_channels=4)
    pp = {"stages": 2, "microbatches": 4, "activation_bytes": 1 << 16}
    for kw in (dict(clip=True), dict(accum=4, accum_overlap=True),
               dict(accum=4, accum_overlap=False), dict(pp=pp)):
        ms = {**mesh_shape, "stage": 2} if "pp" in kw else mesh_shape
        got = T.rank_step_plans(dp_plan, ms, dp_axes=("data",), compute=COMPUTE, net=net,
                                **kw)
        want = R.rank_step_plans(ref_dp_plan, ms, dp_axes=("data",),
                                 compute=ref_cm(COMPUTE), net=ref_net(net), **kw)
        assert [n for n, _ in got] == [n for n, _ in want]
        assert {n.split(":")[0] for n, _ in got} >= {"zero1", "flat", "deferred"}
        for (_, g), (_, w) in zip(got, want):
            same_timeline(g, w)
        if "pp" in kw:
            assert any(n.startswith("pp:1f1b:") for n, _ in got)


def test_grid_search_matches_reference():
    net = T.default_network()
    mesh_shape, model_axis = port_cli.MESHES["smoke-dp2tp4"]
    grads, specs = port_cli._model(model_axis)
    ref_grads, ref_specs = ref_cli._model(model_axis)
    kw = dict(channels=(1, 4), bucket_bytes=(64 * 1024, 1 << 20))
    got = T.grid_search(grads, specs, port_cli.static_mesh(mesh_shape),
                        mesh_shape=mesh_shape, compute=COMPUTE, net=net, **kw)
    want = R.grid_search(ref_grads, ref_specs, ref_cli.StaticMesh(mesh_shape),
                         mesh_shape=mesh_shape, compute=ref_cm(COMPUTE), net=ref_net(net),
                         **kw)
    assert [p.as_row() for p in got] == [p.as_row() for p in want]
    assert got[0].step_time <= got[-1].step_time


@pytest.mark.parametrize("mesh_shape", [{"data": 2, "model": 4}, {"data": 8, "model": 1}])
def test_decode_plans_match_reference(mesh_shape):
    with jax.default_device(jax.devices("cpu")[0]):
        want_model = R.DecodeModel.for_config(
            ref_qwen3.make_smoke(), mesh_shape, batch=8)
    model = T.DecodeModel.for_config(qwen3.make_smoke(), mesh_shape, batch=8)
    assert dataclasses.asdict(model) == dataclasses.asdict(want_model)
    model = dataclasses.replace(model, tp=mesh_shape["model"])
    want_model = dataclasses.replace(want_model, tp=mesh_shape["model"])
    net = T.default_network()
    upd = T.UpdateModel()
    ref_upd = ref_compute.UpdateModel(hbm_bw=upd.hbm_bw, passes=upd.passes,
                                      overhead=upd.overhead)
    got = T.rank_decode_plans(model, mesh_shape, net=net, update=upd)
    want = R.rank_decode_plans(want_model, mesh_shape, net=ref_net(net), update=ref_upd)
    assert [r["sampler"] for r in got] == [r["sampler"] for r in want]
    for g, w in zip(got, want):
        assert (g["token_time"], g["tokens_per_s"], g["comm_time"]) == (
            w["token_time"], w["tokens_per_s"], w["comm_time"])
        assert [(op.op_id, op.kind, op.bucket.size, op.bucket.reduce_axes, op.depends_on)
                for op in g["schedule"].ops] == [
            (op.op_id, op.kind, op.bucket.size, op.bucket.reduce_axes, op.depends_on)
            for op in w["schedule"].ops]
        same_timeline(g["timeline"], w["timeline"])
        assert g["findings"] == []


def test_chrome_trace_and_ascii_match_reference():
    net = T.default_network()
    got, want = {}, {}
    for name, schedule, _ in _cases()[:6]:
        got[name] = T.simulate(_from_reference(schedule), MESHES[1], compute=COMPUTE, net=net)
        want[name] = R.simulate(schedule, MESHES[1], compute=ref_cm(COMPUTE),
                                net=ref_net(net))
    assert T.chrome_trace(got) == R.chrome_trace(want)
    for name in got:
        assert T.ascii_timeline(got[name]) == R.ascii_timeline(want[name])


def test_decode_ops_execute_as_scheduling_points():
    """DECODE runs through the port's emitter: each node waits on its deps
    and records its bucket in ``aux["decode_nodes"]``, as the reference."""
    model = T.DecodeModel(n_layers=2, layer_params_local=64, head_params_local=32,
                          d_model=8, vocab=16, tp=1)
    schedule = T.plan_decode(model, sampler="argmax")
    kinds = [op.kind for op in schedule.ops]
    assert set(kinds) == {"decode"}
    plan = BucketPlan(buckets=(), treedef=flatten_with_names({})[1], num_leaves=0,
                      comm_dtype=torch.float32)
    aux: dict = {}
    execute(schedule, {}, plan, reducer=None, groups={0: None},
            streams=dep.ChainStreams([0], torch.device("cpu")), aux=aux)
    assert aux["decode_nodes"] == [op.bucket.bucket_id for op in schedule.ops]
