"""The port's tree naming, bucket plans and schedules against the JAX
package's, on the ResNet smoke and full (ResNet-50/CIFAR) configs.
Tolerance: exact — names, plans and schedules are pure functions of the
shapes and knobs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import verify_schedule
from repro.configs import resnet50_cifar as ref_configs
from repro.core import buckets as ref_buckets
from repro.core import get_strategy as ref_get_strategy
from repro.core import make_bucket_plan as ref_make_bucket_plan
from repro.core import schedule as ref_schedule
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.models import resnet as ref_resnet
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.configs import resnet50_cifar as configs
from repro_torch.core import get_strategy, make_bucket_plan
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import resnet
from repro_torch.utils.trees import flatten_with_names

STRATEGIES = ("funnel", "concom", "depcha", "priority", "rsag")
CONFIGS = ("smoke", "full")


def _configs(which):
    if which == "smoke":
        return ref_configs.make_smoke(), configs.make_smoke()
    return ref_configs.make_config(), configs.make_config()


def _ref_params(cfg):
    return jax.eval_shape(lambda: ref_resnet.init_params(jax.random.PRNGKey(0), cfg))


def _ref_plan(cfg, **kw):
    params = _ref_params(cfg)
    specs = ref_resnet.param_rules(cfg).tree_specs(params)
    return ref_make_bucket_plan(params, specs, ref_smoke_mesh(1, 1), **kw)


def _plan(cfg, **kw):
    params = resnet.init_params(cfg, device="meta")
    return make_bucket_plan(params, resnet.param_specs(params),
                            make_smoke_mesh(1), **kw)


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if "torch" in str(dt) else np.dtype(dt).name


def _plan_fields(plan):
    return (plan.num_leaves, _dtype_name(plan.comm_dtype), tuple(
        (b.bucket_id, b.channel, b.reduce_axes, b.comm_dtype,
         tuple((l.name, l.index, tuple(l.shape), _dtype_name(l.dtype), l.size)
               for l in b.leaves))
        for b in plan.buckets))


def _op_fields(schedule):
    return tuple((op.op_id, op.bucket.bucket_id, op.chain, op.depends_on,
                  op.kind, op.phase) for op in schedule.ops)


@pytest.mark.parametrize("which", CONFIGS)
def test_leaf_names_and_order_match_reference(which):
    ref_cfg, cfg = _configs(which)
    ref_named, _ = ref_flatten(_ref_params(ref_cfg))
    named, _ = flatten_with_names(resnet.init_params(cfg, device="meta"))
    assert [n for n, _ in named] == [n for n, _ in ref_named]
    assert [tuple(p.shape) for _, p in named] == [tuple(p.shape) for _, p in ref_named]
    assert "stage0/0/c1" in dict(named) and "stem/conv" in dict(named)


@pytest.mark.parametrize("num_channels", [1, 4])
@pytest.mark.parametrize("bucket_bytes", [0, 64 * 1024, 4 * 1024 * 1024])
@pytest.mark.parametrize("which", CONFIGS)
def test_bucket_plan_matches_reference(which, bucket_bytes, num_channels):
    ref_cfg, cfg = _configs(which)
    kw = dict(bucket_bytes=bucket_bytes, num_channels=num_channels)
    assert _plan_fields(_plan(cfg, **kw)) == _plan_fields(_ref_plan(ref_cfg, **kw))


def test_resnet50_plan_sizes():
    """The main path's shape: 152 leaves, 23,513,152 params, 24 buckets of
    1-38 leaves and 1,856-2,359,296 elements at the default 4 MiB."""
    plan = _plan(configs.make_config(), num_channels=4)
    assert plan.num_leaves == 152
    assert sum(b.size for b in plan.buckets) == 23_513_152
    assert len(plan.buckets) == 24
    assert min(len(b.leaves) for b in plan.buckets) == 1
    assert max(len(b.leaves) for b in plan.buckets) == 38
    assert min(b.size for b in plan.buckets) == 1_856
    assert max(b.size for b in plan.buckets) == 2_359_296
    funnel = get_strategy("funnel").plan(plan).stats()
    concom = get_strategy("concom").plan(plan).stats()
    assert (funnel["num_chains"], funnel["max_chain_len"]) == (1, 24)
    assert (concom["num_chains"], concom["max_chain_len"]) == (4, 6)


def _to_reference(schedule):
    """The port's schedule rebuilt from reference objects."""
    ops = []
    for op in schedule.ops:
        b = op.bucket
        leaves = tuple(ref_buckets.LeafInfo(
            l.name, l.index, l.shape, jnp.dtype(_dtype_name(l.dtype)), l.size)
            for l in b.leaves)
        ops.append(ref_schedule.CollectiveOp(
            op.op_id, ref_buckets.Bucket(leaves, b.reduce_axes, b.channel,
                                         b.bucket_id),
            op.chain, op.depends_on, op.kind, op.reducer, op.phase, op.shift))
    return ref_schedule.CommSchedule(tuple(ops))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("which", CONFIGS)
def test_schedule_matches_reference_op_for_op(which, strategy):
    ref_cfg, cfg = _configs(which)
    plan = _plan(cfg, num_channels=4)
    ref_plan = _ref_plan(ref_cfg, num_channels=4)
    got = get_strategy(strategy).plan(plan)
    want = ref_get_strategy(strategy).plan(ref_plan)
    assert _op_fields(got) == _op_fields(want)
    assert got.stats() == want.stats()
    # the reference's static verifier as an oracle, on a 4-rank mesh
    verify_schedule(_to_reference(got), mesh_shape={"data": 4, "model": 1},
                    default_reducer="flat", plan_comm_dtype=jnp.float32)


def test_validate_rejects_what_the_reference_rejects():
    plan = _plan(configs.make_smoke(), num_channels=4)
    good = get_strategy("concom").plan(plan)
    first = good.ops[0]
    bad = type(good)((first, type(first)(
        op_id=1, bucket=first.bucket, chain=0, depends_on=(7,))))
    with pytest.raises(ValueError, match="dangling"):
        bad.validate()
    with pytest.raises(ValueError, match="unknown kind"):
        type(good)((type(first)(op_id=0, bucket=first.bucket, chain=0,
                                kind="bogus"),)).validate()


def _from_reference(schedule):
    """A reference schedule rebuilt from the port's objects."""
    from repro_torch.core.buckets import Bucket, LeafInfo
    from repro_torch.core.schedule import CollectiveOp, CommSchedule

    def tdt(d):
        return None if d is None else getattr(torch, np.dtype(d).name)

    return CommSchedule(tuple(CollectiveOp(
        op.op_id,
        Bucket(tuple(LeafInfo(l.name, l.index, l.shape, tdt(l.dtype), l.size)
                     for l in op.bucket.leaves),
               op.bucket.reduce_axes, op.bucket.channel, op.bucket.bucket_id,
               tdt(op.bucket.comm_dtype)),
        op.chain, op.depends_on, op.kind, op.reducer, op.phase, op.shift)
        for op in schedule.ops))


def test_phase_and_regroup_splits_match_reference():
    """The IR's step-program accessors on the reference's deferred ZeRO-1
    program (POST RS/NORM/UPDATE, PRE all-gathers) and on a schedule cut
    by a REGROUP barrier."""
    from repro.core import GradSync as RefGradSync
    from repro.core import GradSyncConfig as RefGradSyncConfig

    cfg = ref_configs.make_smoke()
    params = _ref_params(cfg)
    gs = RefGradSync(
        RefGradSyncConfig(strategy="concom", exclude_axes=("data",),
                          zero1_dp_axes=("data",), zero1_clip=True,
                          zero1_defer_ag=True, bucket_bytes=16 * 1024),
        ref_smoke_mesh(1, 1), ref_resnet.param_rules(cfg).tree_specs(params),
        params)
    want = gs.schedule
    got = _from_reference(want)
    assert _op_fields(got) == _op_fields(want)
    for g, w in zip(got.split_phases(), want.split_phases()):
        assert _op_fields(g) == _op_fields(w)
    assert got.deferred_bytes() == want.deferred_bytes() > 0
    assert [op.op_id for op in got.update_ops()] == [
        op.op_id for op in want.update_ops()]

    b = want.ops[0].bucket
    ops = (ref_schedule.CollectiveOp(0, b, 0),
           ref_schedule.CollectiveOp(1, b, 1),
           ref_schedule.CollectiveOp(2, b, 0, (0, 1), kind="regroup"),
           ref_schedule.CollectiveOp(3, b, 0, (2,)),
           ref_schedule.CollectiveOp(4, b, 1, (2, 3)))
    want = ref_schedule.CommSchedule(ops)
    got = _from_reference(want)
    for g, w in zip(got.split_regroup(), want.split_regroup()):
        assert _op_fields(g) == _op_fields(w)


# ------------------------------------------------ the transformer LM (Qwen3-1.7B)

def _lm_plans(which, **kw):
    """(the port's, the reference's) bucket plan of Qwen3-1.7B's smoke or
    full-width config at tp=1 on a one-rank ("data", "model") mesh, from
    the models' own sharding rules."""
    from repro.configs import qwen3_1_7b as ref_qwen3
    from repro.models import transformer as ref_tf
    from repro_torch.configs import qwen3_1_7b as qwen3
    from repro_torch.models import transformer

    if which == "smoke":
        ref_cfg, cfg = ref_qwen3.make_smoke(), qwen3.make_smoke()
    else:
        ref_cfg, cfg = ref_qwen3.make_config(tp=1), qwen3.make_config()
    ref_params = jax.eval_shape(lambda: ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg))
    ref_plan = ref_make_bucket_plan(ref_params, ref_tf.param_rules(ref_cfg).tree_specs(
        ref_params), ref_smoke_mesh(1, 1), **kw)
    params = transformer.init_params(cfg, device="meta")
    plan = make_bucket_plan(params, transformer.param_specs(params, cfg),
                            make_smoke_mesh(1), **kw)
    return plan, ref_plan, transformer.in_scan_param_names(params), \
        ref_tf.in_scan_param_names(ref_params)


@pytest.mark.parametrize("bucket_bytes", [0, 4 * 1024 * 1024])
@pytest.mark.parametrize("which", CONFIGS)
def test_lm_bucket_plan_matches_reference(which, bucket_bytes):
    plan, ref_plan, _, _ = _lm_plans(which, bucket_bytes=bucket_bytes, num_channels=4)
    assert _plan_fields(plan) == _plan_fields(ref_plan)


@pytest.mark.parametrize("in_scan", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("which", CONFIGS)
def test_lm_schedule_matches_reference_op_for_op(which, strategy, in_scan):
    """With ``in_scan`` the strategies that sum inside the backward (depcha)
    drop the ``blocks/`` leaves: their schedule carries only embed,
    lm_head and the final norm."""
    plan, ref_plan, names, ref_names = _lm_plans(which, num_channels=4)
    assert names == ref_names and names
    skip = names if in_scan and get_strategy(strategy).uses_in_scan else frozenset()
    got = get_strategy(strategy).plan(plan, skip_names=skip)
    want = ref_get_strategy(strategy).plan(ref_plan, skip_names=skip)
    assert _op_fields(got) == _op_fields(want)
    assert got.stats() == want.stats()
    if skip:
        assert got.leaf_names() == {"embed", "lm_head", "ln_f"}
    else:
        assert names <= got.leaf_names()
