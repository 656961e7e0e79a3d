"""The port's pipeline planner (``core/pipeline_program.py``) and the
emitter's SEND/RECV (``core/schedule.py::execute``) against the JAX
package's: the plan tests of ``tests/test_pipeline_program.py`` without
the simulator's.

Every plan is held op for op to the reference's, carried into the port's
IR by ``test_torch_plan.py::_from_reference``: gpipe and 1f1b at (S, M)
in {(2, 2), (2, 4), (4, 8)}, interleaved, their commit orders and slot
maps; bad arguments are refused alike; 1F1B keeps at most S
microbatches in flight (also as a hypothesis property); ``compose_step``
gives the reference's joint schedule and release edges.  Then one spawn
of 4 gloo ranks (worker mode ``sendrecv``): a SEND/RECV pair through
``execute`` over 2 and 4 stages, shift +1 and −1, fused staging and not,
at loss scale 1 and 4, delivers the payload of the rank ``shift``
behind, bit for bit (the reference's SENDRECV check is the 2-stage,
shift +1 case).
"""
import numpy as np
import pytest
import torch

from repro.core import pipeline_program as ref_pp
from repro.core import schedule as ref_schedule
from repro.core.buckets import Bucket as RefBucket
from repro.core.buckets import LeafInfo as RefLeafInfo
from repro_torch.core.buckets import Bucket, LeafInfo
from repro_torch.core.pipeline_program import (
    SCHEDULES,
    STAGE_AXIS,
    PipelinePlan,
    bucket_stage_map,
    compose_step,
    max_in_flight,
    plan_pipeline,
)
from repro_torch.core.schedule import ALLREDUCE, RECV, SEND, CollectiveOp, CommSchedule

from _torch_mdworker import WORLD, run_all
from test_torch_plan import _from_reference

SHAPES = [(2, 2), (2, 4), (4, 8)]


def _same_plan(got: PipelinePlan, want) -> None:
    assert got.schedule == _from_reference(want.schedule)
    assert [(d, (s.phase, s.stage, s.mb)) for d, s in got.commits] == \
        [(d, (s.phase, s.stage, s.mb)) for d, s in want.commits]
    assert {k: (role, (s.phase, s.stage, s.mb)) for k, (role, s) in got.op_slot.items()} == \
        {k: (role, (s.phase, s.stage, s.mb)) for k, (role, s) in want.op_slot.items()}
    for f in ("kind", "n_stages", "n_microbatches", "virtual", "stage_axis",
              "activation_bytes", "total_stages"):
        assert getattr(got, f) == getattr(want, f), f
    for g in range(got.total_stages):
        assert got.final_backward_op(g) == want.final_backward_op(g)


@pytest.mark.parametrize("kind", ["gpipe", "1f1b"])
@pytest.mark.parametrize("S,M", SHAPES)
def test_plan_matches_reference(kind, S, M):
    got = plan_pipeline(S, M, kind=kind, activation_bytes=1 << 10)
    _same_plan(got, ref_pp.plan_pipeline(S, M, kind=kind, activation_bytes=1 << 10))
    ops = got.schedule.ops
    assert len(ops) == 2 * 2 * (S - 1) * M
    sends = {o.bucket.bucket_id: o for o in ops if o.kind == SEND}
    for r in (o for o in ops if o.kind == RECV):
        s = sends[r.bucket.bucket_id]
        assert s.op_id in r.depends_on and r.shift == s.shift
    shifts = {got.op_slot[o.op_id][1].phase: o.shift for o in ops}
    assert shifts == {"F": 1, "B": -1}


@pytest.mark.parametrize("kw", [
    dict(n_stages=2, n_microbatches=8, kind="interleaved", virtual=2),
    dict(n_stages=3, n_microbatches=5, kind="interleaved", virtual=2, id_offset=7,
         chain_offset=3, channel=1, itemsize=2, stage_axis="pipe"),
    dict(n_stages=1, n_microbatches=3, kind="gpipe"),
])
def test_interleaved_and_offset_plans_match_reference(kw):
    got = plan_pipeline(activation_bytes=640, **kw)
    _same_plan(got, ref_pp.plan_pipeline(activation_bytes=640, **kw))
    if kw["kind"] == "interleaved":
        devs = {s.stage: d for d, s in got.commits}
        assert all(devs[g] == g % kw["n_stages"] for g in devs)


@pytest.mark.parametrize("args,kw", [
    ((0, 4), {}), ((2, 0), {}), ((2, 4), dict(kind="gpipe", virtual=2)),
    ((2, 4), dict(kind="wavefront")), ((2, 4), dict(kind="1f1b", virtual=2)),
])
def test_plan_rejects_bad_args(args, kw):
    with pytest.raises(ValueError) as got:
        plan_pipeline(*args, activation_bytes=0, **kw)
    with pytest.raises(ValueError) as want:
        ref_pp.plan_pipeline(*args, activation_bytes=0, **kw)
    assert str(got.value) == str(want.value)


def test_1f1b_in_flight_bound():
    assert SCHEDULES == ref_pp.SCHEDULES and STAGE_AXIS == ref_pp.STAGE_AXIS
    for S, M in [(2, 4), (4, 8), (3, 9)]:
        plan = plan_pipeline(S, M, kind="1f1b", activation_bytes=1 << 10)
        assert max_in_flight(plan) <= S
        assert max_in_flight(plan) == ref_pp.max_in_flight(
            ref_pp.plan_pipeline(S, M, kind="1f1b", activation_bytes=1 << 10))
        gp = plan_pipeline(S, M, kind="gpipe", activation_bytes=1 << 10)
        assert max_in_flight(gp) == M


def _sync(bucket_cls, leaf_cls, dtype, n=5):
    """A chain of ``n`` allreduces over "data", one bucket each."""
    def mk(bid, deps):
        return (bucket_cls(leaves=(leaf_cls(name=f"b{bid}", index=0, shape=(8,), dtype=dtype,
                                            size=8),),
                           reduce_axes=("data",), channel=0, bucket_id=bid), deps)
    return [(bid, *mk(bid, (bid - 1,) if bid else ())) for bid in range(n)]


@pytest.mark.parametrize("kind,S,M", [("1f1b", 2, 4), ("gpipe", 2, 4), ("1f1b", 4, 8)])
def test_compose_step_matches_reference(kind, S, M):
    pp = plan_pipeline(S, M, kind=kind, activation_bytes=1 << 10)
    rpp = ref_pp.plan_pipeline(S, M, kind=kind, activation_bytes=1 << 10)
    sync = CommSchedule(tuple(CollectiveOp(op_id=i, bucket=b, chain=0, depends_on=d,
                                           kind=ALLREDUCE)
                              for i, b, d in _sync(Bucket, LeafInfo, torch.float32)))
    rsync = ref_schedule.CommSchedule(tuple(
        ref_schedule.CollectiveOp(op_id=i, bucket=b, chain=0, depends_on=d, kind="allreduce")
        for i, b, d in _sync(RefBucket, RefLeafInfo, np.float32)))
    joint, id_map = compose_step(pp, sync)
    rjoint, rid_map = ref_pp.compose_step(rpp, rsync)
    assert joint == _from_reference(rjoint) and id_map == rid_map
    smap = bucket_stage_map(pp, sync)
    assert smap == ref_pp.bucket_stage_map(rpp, rsync)
    assert smap[0] == S - 1 and smap[max(smap)] == 0   # output-side buckets: last stage
    off = len(pp.schedule.ops)
    for op in joint.ops[off:]:
        assert pp.final_backward_op(smap[op.bucket.bucket_id]) in op.depends_on


@pytest.fixture(scope="module")
def sendrecv(tmp_path_factory):
    d = tmp_path_factory.mktemp("sendrecv")
    run_all(d, "sendrecv", timeout=300)
    return [dict(np.load(d / f"sendrecv_rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("shift", [1, -1])
def test_send_recv_moves_the_payload(sendrecv, stages, shift):
    """Rank (d, s) of data × stage receives rank (d, s − shift)'s buffer,
    bit for bit, through the fused staging and the plain one, with the
    loss scale folded into the pack and undone by the unpack; the RECV
    makes one counted hop of the f32 payload."""
    N = 8
    for r, out in enumerate(sendrecv):
        d, s = divmod(r, stages)
        src = d * stages + (s - shift) % stages
        want = np.arange(src * N, (src + 1) * N, dtype=np.float32) / np.float32(3)
        want = torch.from_numpy(want).numpy()
        for fused in (1, 0):
            for scale in (1.0, 4.0):
                got = out[f"{stages}/{shift}/{fused}/{scale}"]
                np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
                assert out[f"{stages}/{shift}/{fused}/{scale}/hops"].tolist() == [1, 4 * N]


try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # pragma: no cover
    given = None

if given is not None:
    @settings(max_examples=25, deadline=None)
    @given(S=st.integers(2, 4), M=st.integers(1, 12))
    def test_prop_1f1b_in_flight_le_stages(S, M):
        plan = plan_pipeline(S, M, kind="1f1b", activation_bytes=1 << 10)
        assert max_in_flight(plan) <= S
        assert plan.commits == tuple(
            (d, type(plan.commits[0][1])(s.phase, s.stage, s.mb))
            for d, s in ref_pp.plan_pipeline(S, M, kind="1f1b",
                                             activation_bytes=1 << 10).commits)
