"""The port's ZeRO-1 StepProgram plans against the JAX package's:
``zero1_bucket_plan``, ``zero1_schedule`` and the program
``plan_sync`` builds (``build_step_program`` spliced after the sync
ops), for every fixed strategy × clip {off, on} × defer {off, on}, on
stand-in meshes (data 2; pod 2 × data 2; data 2 × model 4, whose sync
ops the zero1 reduce-scatters depend on).  Each plan equals the
reference's op for op — buckets, leaves and torch dtypes included — and
so do ``split_phases``, ``deferred_bytes`` and the refusal of leaves
already sharded over the dp axes.  Tolerance: exact — plans are pure
functions of the shapes and knobs.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.analysis import cli as ref_cli
from repro.core import GradSync as RefGradSync
from repro.core import GradSyncConfig as RefGradSyncConfig
from repro.core import get_strategy as ref_get_strategy
from repro.core.stepprogram import zero1_bucket_plan as ref_zero1_bucket_plan
from repro.core.stepprogram import zero1_schedule as ref_zero1_schedule
from repro_torch.analysis import cli
from repro_torch.analysis import mutations
from repro_torch.core import (
    GradSyncConfig,
    get_strategy,
    plan_sync,
    zero1_bucket_plan,
    zero1_schedule,
)
from repro_torch.core.schedule import ALL_GATHER, NORM, POST, PRE, REDUCE_SCATTER, UPDATE
from test_torch_plan import _dtype_name, _from_reference, _op_fields
from test_torch_plan import _plan_fields as _plan_fields_raw

STRATEGIES = ("funnel", "concom", "depcha", "priority", "rsag")
# name -> (axis sizes, dp axes, the axis the matmul weights shard over)
MESHES = {
    "data2": ({"data": 2, "model": 1}, ("data",), None),
    "pod2xdata2": ({"pod": 2, "data": 2, "model": 1}, ("pod", "data"), None),
    "data2xmodel4": ({"data": 2, "model": 4}, ("data",), "model"),
}


def _plan_fields(plan):
    """``test_torch_plan``'s plan fields with each bucket's pinned dtype
    by name (the zero1 plans pin f32: a torch dtype here, numpy's there)."""
    n, dt, buckets = _plan_fields_raw(plan)
    return n, dt, tuple((bid, ch, ax, None if cdt is None else _dtype_name(cdt), leaves)
                        for bid, ch, ax, cdt, leaves in buckets)


def _trees(mesh_name):
    """The analyzer's small transformer-ish tree on both sides, its
    matmul weights sharded over "model" where the mesh says so."""
    shape, _, model_axis = MESHES[mesh_name]
    ref_grads, ref_specs = ref_cli._model(model_axis)
    grads, specs = cli._model(model_axis)
    return (shape, (ref_grads, ref_specs, ref_cli.StaticMesh(shape)),
            (grads, specs, cli.static_mesh(shape)))


def _sync_cfgs(strategy, dp, clip, defer, **kw):
    fields = dict(strategy=strategy, bucket_bytes=256 * 1024, num_channels=4,
                  exclude_axes=dp, zero1_dp_axes=dp, zero1_clip=clip,
                  zero1_defer_ag=defer, **kw)
    return RefGradSyncConfig(**fields), GradSyncConfig(**fields)


@pytest.mark.parametrize("id_offset", [0, 5])
@pytest.mark.parametrize("bucket_bytes", [0, 64 * 1024, 4 * 1024 * 1024])
@pytest.mark.parametrize("num_channels", [1, 4])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_zero1_bucket_plan_matches_reference(mesh_name, num_channels, bucket_bytes,
                                             id_offset):
    _, (rg, rs, rmesh), (g, s, mesh) = _trees(mesh_name)
    dp = MESHES[mesh_name][1]
    kw = dict(dp_axes=dp, bucket_bytes=bucket_bytes, num_channels=num_channels,
              id_offset=id_offset)
    got = zero1_bucket_plan(g, s, mesh, **kw)
    want = ref_zero1_bucket_plan(rg, rs, rmesh, **kw)
    assert _plan_fields(got) == _plan_fields(want)
    assert all(b.comm_dtype == torch.float32 and b.reduce_axes == dp
               for b in got.buckets)
    assert all(l.dtype == torch.float32 for b in got.buckets for l in b.leaves)
    assert min(b.bucket_id for b in got.buckets) == id_offset


def test_zero1_bucket_plan_refuses_dp_sharded_leaves_as_the_reference():
    """FSDP-style leaves (already sharded over dp) keep their own storage:
    both packages refuse them with the same message."""
    _, (rg, rs, rmesh), (g, s, mesh) = _trees("data2")
    with pytest.raises(ValueError) as want:
        ref_zero1_bucket_plan(rg, jax.tree.map(lambda _: P("data"), rs), rmesh,
                              dp_axes=("data",))
    with pytest.raises(ValueError) as got:
        zero1_bucket_plan(g, {k: ("data",) for k in s}, mesh, dp_axes=("data",))
    assert str(got.value) == str(want.value)
    assert "replicated over the dp axes" in str(got.value)


@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_zero1_schedule_matches_reference(strategy, clip, defer):
    from repro.analysis.mutations import synthetic_plan as ref_synthetic_plan

    import jax.numpy as jnp

    base = get_strategy(strategy).plan(mutations.synthetic_plan(pin=torch.float32))
    ref_base = ref_get_strategy(strategy).plan(ref_synthetic_plan(pin=jnp.float32))
    got = zero1_schedule(base, dp_axes=("data",), clip=clip, defer_ag=defer)
    want = ref_zero1_schedule(ref_base, dp_axes=("data",), clip=clip, defer_ag=defer)
    assert got == _from_reference(want)
    assert _op_fields(got) == _op_fields(want)
    assert got.stats() == want.stats()
    n = len(base.bucket_order())
    kinds = got.stats()["kinds"]
    assert kinds[REDUCE_SCATTER] == kinds[UPDATE] == kinds[ALL_GATHER] == n
    assert kinds.get(NORM, 0) == int(clip)
    assert got.phase_counts() == ({POST: 2 * n + int(clip), PRE: n} if defer
                                  else {POST: 3 * n + int(clip)})
    assert got.deferred_bytes() == want.deferred_bytes()
    for g, w in zip(got.split_phases(), want.split_phases()):
        assert g == _from_reference(w)


@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_step_program_matches_reference(mesh_name, strategy, clip, defer):
    """``plan_sync`` under ``zero1_dp_axes`` against the reference's
    ``GradSync``: the spliced program, its two phases and its counts."""
    shape, (rg, rs, rmesh), (g, s, mesh) = _trees(mesh_name)
    dp = MESHES[mesh_name][1]
    ref_cfg, cfg = _sync_cfgs(strategy, dp, clip, defer)
    want = RefGradSync(ref_cfg, rmesh, rs, rg)
    got = plan_sync(cfg, mesh, s, g)
    prog, ref_prog = got.program, want.program
    assert got.schedule is prog.schedule
    assert prog.schedule == _from_reference(ref_prog.schedule)
    assert _op_fields(prog.schedule) == _op_fields(ref_prog.schedule)
    assert _plan_fields(prog.dp_plan) == _plan_fields(ref_prog.dp_plan)
    assert (prog.dp_axes, prog.dp_size, prog.clip, prog.num_sync_ops, prog.defer_ag) == (
        ref_prog.dp_axes, ref_prog.dp_size, ref_prog.clip, ref_prog.num_sync_ops,
        ref_prog.defer_ag)
    assert prog.dp_size == int(np.prod([shape[a] for a in dp]))
    assert prog.post_schedule() == _from_reference(ref_prog.post_schedule())
    assert prog.pre_schedule() == _from_reference(ref_prog.pre_schedule())
    assert prog.schedule.deferred_bytes() == ref_prog.schedule.deferred_bytes()
    assert (prog.schedule.deferred_bytes() > 0) == defer
    assert prog.stats() == ref_prog.stats()
    if mesh_name == "data2xmodel4":
        # the model-axis sum lands before the dp reduce-scatter reads it
        assert prog.num_sync_ops > 0
        assert any(d < prog.num_sync_ops for op in prog.schedule.ops
                   if op.kind == REDUCE_SCATTER for d in op.depends_on)


def test_plan_sync_verifies_the_program_with_its_defer(monkeypatch):
    """``verify`` holds the program to the carry pass with
    ``expect_defer`` = the plan's: a deferred program verifies clean, and
    a deferred gather flipped back to POST is refused."""
    from repro_torch.analysis import ScheduleError
    from repro_torch.core import stepprogram

    _, _, (g, s, mesh) = _trees("data2")
    _, cfg = _sync_cfgs("concom", ("data",), True, True)
    planned = plan_sync(cfg, mesh, s, g)
    assert planned.program.defer_ag

    def mixed(*a, **kw):
        prog = build(*a, **kw)
        victim = next(op for op in prog.schedule.ops if op.phase == PRE)
        ops = tuple(dataclasses.replace(op, phase=POST) if op is victim else op
                    for op in prog.schedule.ops)
        return dataclasses.replace(prog, schedule=type(prog.schedule)(ops))

    build = stepprogram.build_step_program
    monkeypatch.setattr(stepprogram, "build_step_program", mixed)
    with pytest.raises(ScheduleError) as e:
        plan_sync(cfg, mesh, s, g)
    assert e.value.code == "mixed-defer"
