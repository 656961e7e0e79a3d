"""The port's elastic training (``repro_torch.elastic``, the IR's RESHARD
and REGROUP, ``KVStore.regroup``, meshes below the world) against the JAX
package's.

One spawn: worker mode ``elastic`` of ``tests/_torch_mdworker.py`` on 4
gloo ranks, beside the reference on 4 fake devices, both on the
reference elastic worker's model (``tests/_elworker.py``'s ``mk_dense``:
2 layers, d 64, 8/2 heads, ff 128, vocab 96, f32), its sync (concom,
ZeRO-1, 4 KiB buckets, AdamW 1e-3, clip 0) and its pipeline
(``TokenPipeline(96, 32, 8, seed=5)``), over the ladder ``("tp2",
"tp1")``: data 2 × model 2 on the 4 ranks, then data 2 × model 1 on
ranks 0 and 1.  In the port, bit for bit (the reference's checks 1, 2,
3 without the simulator, 5, 6, 7 and 8): the codec's round trip on one
mesh, scheduled and deferred; a zero-step tp2 → tp1 → tp2 reshard; the
transition plan's byte count and the pass that rejects a PRE op across
the REGROUP; the faulty supervisor cycle (a transient at step 1, a rank
loss at 3, 2 checkpoint-I/O faults, grow-back after 2, 6 steps) equal
to its scripted clean replay under both plans, and deferred equal to
scheduled; the straggler shrink and its replay; the deferred plan's
exact resume through the plain checkpoint on the 2-rank rung and the
guard that refuses a checkpoint without the carry.

Against the reference: the same script, transition reasons and events,
each step's loss within rtol 1e-5, and the final params within 2e-5 of
each leaf's largest, but for at most 2 elements a leaf, which are within
5e-5: AdamW's g / (sqrt(v) + eps) turns last-bit gradient differences
of the tp2 steps into a larger step where g is near 0 (measured 4.5e-5
of the leaf's largest in one element of ``embed`` and one of
``blocks/wu``, the same after the first 3 steps, before any transition;
``test_torch_overlap``, ``test_torch_tp``).

ZeRO-1 state at tp > 1 on the plain checkpoint path: the port refuses
it, naming the elastic path; the reference writes one model rank's copy
(its own ``repro/elastic/reshard.py`` calls that view a lie), witnessed
here.  The world-rank repairs: coset groups, pod groups, the model axis,
FSDP's axes, the zero1 state and ``GradSync`` on a 2-rank mesh on world
ranks 2 and 3 give what the same mesh gives on ranks 0 and 1, the layout
of a whole world of 2, and the sums expected.  ``KVStore.regroup`` on
the 4 ranks and on one; the IR's ``split_regroup`` and the reshard pass.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as ref_tf
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.analysis import ScheduleError, run_passes, verify_schedule
from repro_torch.analysis.mutations import (
    NEW_MESH_RS,
    OLD_MESH_RS,
    synthetic_reshard_schedule,
)
from repro_torch.core import KVStore
from repro_torch.core import schedule as sched
from repro_torch.core.schedule import REGROUP, RESHARD, CommSchedule
from repro_torch.launch.mesh import init_dist

from _torch_mdworker import EL_SCRIPT, WORLD, el_config, run_all

CTX = dict(old_mesh_shape=OLD_MESH_RS, new_mesh_shape=NEW_MESH_RS)
PLANS = ("scheduled", "deferred")
LOSS_RTOL = 1e-5
PARAM_TOL, PARAM_FEW, PARAM_MAX = 2e-5, 2, 5e-5     # of each leaf's largest


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    params = ref_tf.init_params(jax.random.PRNGKey(2), el_config(1, ref=True))
    np.savez(d / "elastic_params.npz", **{n: np.asarray(p) for n, p in ref_flatten(params)[0]})
    run_all(d, "elastic", reference_too=True, timeout=600)
    return d


def _rank(d, r):
    return dict(np.load(d / f"elastic_rank{r}.npz", allow_pickle=True))


@pytest.fixture(scope="module")
def ref(workdir):
    return dict(np.load(workdir / "elastic_jax.npz", allow_pickle=True))


# ---------------------------------------------------- the port, bit for bit

@pytest.mark.parametrize("check", [
    "codec-roundtrip-scheduled", "codec-roundtrip-deferred", "reshard-2-1-2-roundtrip",
    "plan-reshard-bytes-cover-streams", "plan-reshard-rejects-pre-crossing-regroup",
    "supervisor-scheduled-faulty-equals-clean", "supervisor-deferred-faulty-equals-clean",
    "supervisor-deferred-equals-scheduled", "straggler-shrink-faulty-equals-clean",
    "deferred-plain-ckpt-exact-resume", "deferred-restore-guard-refuses-carry-less-ckpt"])
def test_elastic_check_passes_on_every_rank(workdir, check):
    ranks = (0, 1) if check.startswith("deferred-") else range(WORLD)  # the tp1 rung's
    for r in ranks:
        assert bool(_rank(workdir, r)[f"check/{check}"]), f"rank {r}"


def test_transition_anchor_is_what_save_now_writes(workdir):
    got = _rank(workdir, 0)
    assert "manifest.json" in [f.split("/")[-1] for f in got["anchor/files"]]
    assert bool(got["check/anchor-view-equals-save-now"])


def test_transition_plan_moves_params_and_both_moments(workdir):
    got = _rank(workdir, 0)
    assert int(got["plan/reshard_bytes"]) == 3 * int(got["plan/n_param"]) * 4
    kinds = list(got["plan/kinds"])
    assert kinds.count(REGROUP) == 1
    rg = kinds.index(REGROUP)
    assert set(kinds[:rg]) == set(kinds[rg + 1:]) == {RESHARD}


def test_straggler_shrink_is_decided_alike_on_every_rank(workdir):
    for r in range(WORLD):
        got = _rank(workdir, r)
        assert list(got["straggler/decisions"]) == ["shrink"]
        assert list(got["straggler/reasons"]) == ["straggler_shrink", "grow_back"]
        assert list(got["straggler/resume"]) == [8, 10]


def test_every_rank_takes_the_same_transitions(workdir):
    for plan in PLANS:
        want = [tuple(map(str, row)) for row in EL_SCRIPT]
        for r in range(WORLD):
            got = _rank(workdir, r)
            assert [tuple(row) for row in got[f"{plan}-faulty/script"]] == want
            assert int(got[f"{plan}-faulty/latency_count"]) == 2
            assert int(got[f"{plan}-faulty/reshard_bytes_total"]) == \
                2 * int(got["plan/reshard_bytes"])


# ------------------------------------------------------ against the reference

@pytest.mark.parametrize("plan", PLANS)
def test_supervisor_cycle_matches_reference(workdir, ref, plan):
    got, tag = _rank(workdir, 0), f"{plan}-faulty"
    assert got[f"{tag}/script"].tolist() == ref[f"{tag}/script"].tolist()
    assert got[f"{tag}/reasons"].tolist() == ref[f"{tag}/reasons"].tolist() == \
        ["rank_loss", "grow_back"]
    assert got[f"{tag}/events"].tolist() == ref[f"{tag}/events"].tolist()
    losses = sorted(k for k in ref if k.startswith(f"{tag}/loss/"))
    assert len(losses) == 6
    for k in losses:
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, err_msg=k)
    params = [k for k in ref if k.startswith(f"{tag}/param/")]
    assert params
    for k in params:
        want, diff = ref[k], np.abs(got[k] - ref[k])
        top = float(np.abs(want).max())
        assert int((diff > PARAM_TOL * top).sum()) <= PARAM_FEW, k
        assert float(diff.max()) <= PARAM_MAX * top, k


def test_each_rung_trains_as_the_reference(workdir):
    """The uninterrupted runs of each rung (tp1 on 2 of the 4 ranks) agree
    with the reference's first losses of the cycle."""
    got = _rank(workdir, 0)
    want = [float(x) for x in got["plain-tp2/losses"]]
    np.testing.assert_allclose(got["plain-tp1/losses"], want, rtol=LOSS_RTOL)


def test_plain_checkpoint_refuses_zero1_at_tp2_where_the_reference_collapses(workdir, ref):
    for r in range(WORLD):
        msg = str(_rank(workdir, r)["plain-zero1-tp2-refusal"])
        assert "ElasticCheckpointer" in msg and "tp=2" in msg, msg
    # the reference's global flat view of every bucket's m is model rank 0's
    # dp shards; model rank 1's differ where the bucket holds model-sharded
    # leaves, and are in no checkpoint
    buckets = sorted({k.split("/")[1] for k in ref if k.startswith("witness/")})
    lost = 0
    for b in buckets:
        rank0 = np.concatenate([ref[f"witness/{b}/shard/00"], ref[f"witness/{b}/shard/10"]])
        rank1 = np.concatenate([ref[f"witness/{b}/shard/01"], ref[f"witness/{b}/shard/11"]])
        np.testing.assert_array_equal(ref[f"witness/{b}/global"], rank0)
        lost += not np.array_equal(rank0, rank1)
    assert len(buckets) > 1 and lost > 0


# ------------------------------------------------------- meshes below the world

def test_world_rank_repairs_on_a_two_rank_mesh_inside_four(workdir):
    """On world ranks 2, 3 each function gives what the same mesh gives on
    ranks 0, 1 (where mesh rank = world rank, as in a world of 2)."""
    vals = [np.arange(6, dtype=np.float32) * (1 + m) + 0.5 for m in range(2)]
    params = ref_tf.init_params(jax.random.PRNGKey(2), el_config(1, ref=True))
    sizes = np.array([np.asarray(p).size for _, p in ref_flatten(params)[0]])
    for me, r_hi, r_lo in ((0, 2, 0), (1, 3, 1)):
        hi, lo = _rank(workdir, r_hi), _rank(workdir, r_lo)
        for fn in ("coset_groups", "pod_comms", "model_axis", "fsdp_axes", "zero1_state",
                   "gradsync"):
            np.testing.assert_array_equal(hi[f"sub23/{fn}"], lo[f"sub01/{fn}"], err_msg=fn)
        total = vals[0] + vals[1]
        np.testing.assert_array_equal(hi["sub23/coset_groups"], total)
        np.testing.assert_array_equal(hi["sub23/pod_comms"], np.concatenate([total, [1, 2]]))
        np.testing.assert_array_equal(hi["sub23/model_axis"], np.concatenate([total, [me, 2]]))
        np.testing.assert_array_equal(hi["sub23/fsdp_axes"],
                                      np.concatenate([vals[0], vals[1], [me, 2]]))
        # GradSync's sum over the 2 ranks of 1 and 2: 3 an element
        np.testing.assert_array_equal(hi["sub23/gradsync"], 3.0 * sizes)
    for r in (0, 1):      # outside the mesh on ranks 2, 3: nothing computed there
        assert not any(k.startswith("sub23/") for k in _rank(workdir, r))


def test_kvstore_regroup_on_four_ranks(workdir):
    for r in range(WORLD):
        got = _rank(workdir, r)
        np.testing.assert_array_equal(got["kvstore/before"], np.full(8, 10.0))
        assert float(got["kvstore/size"]) == 4.0
        # after the regroup the store sums over "data" alone: ranks r and r ^ 2
        peer = r ^ 2
        np.testing.assert_array_equal(got["kvstore/after"], np.full(8, 3.0 * (r + 1 + peer + 1)))
        assert list(got["kvstore/kinds"]) == ["allreduce", "allreduce", REGROUP, "allreduce"]
        assert list(got["kvstore/axes"]) == ["data+model"] * 3 + ["data"]


# ------------------------------------------------------ the IR, on one rank

def test_emitter_runs_the_elastic_kinds():
    # the elastic kinds run, as every kind of the IR does since the
    # simulator's slice (SEND/RECV since the pipeline's, DECODE a
    # scheduling point): the emitter keeps no list of refused kinds
    assert not hasattr(sched, "_NOT_PORTED")
    assert {sched.RESHARD, sched.REGROUP, sched.SEND, sched.RECV, sched.DECODE} <= set(
        sched.KINDS)
    src = inspect.getsource(sched._OpEmitter.emit)
    assert all(f"op.kind == {k.upper()}" in src for k in sched.KINDS)


def test_synthetic_transition_verifies_clean():
    s = synthetic_reshard_schedule()
    verify_schedule(s, **CTX)
    report = run_passes(s, **CTX)
    assert report.ok, report.render()


def test_split_regroup_sides():
    s = synthetic_reshard_schedule(streams=("param", "inner/m"))
    old, new = s.split_regroup()
    assert old.ops[-1].kind == REGROUP
    assert all(op.kind == RESHARD for op in new.ops)
    new_ids = {op.op_id for op in new.ops}
    for op in new.ops:
        assert set(op.depends_on) <= new_ids
    run_passes(old, mesh_shape=OLD_MESH_RS)
    run_passes(new, mesh_shape=NEW_MESH_RS)


def test_split_regroup_requires_regroup():
    s = synthetic_reshard_schedule()
    plain = CommSchedule(tuple(op for op in s.ops if op.kind != REGROUP))
    with pytest.raises(ValueError, match="no REGROUP"):
        plain.split_regroup()


def test_reshard_pass_leaf_divisibility():
    s = synthetic_reshard_schedule()
    with pytest.raises(ScheduleError, match="leaf-indivisible"):
        verify_schedule(s, **CTX, leaf_divisibility={"w0@dim0": (10, 4)})
    verify_schedule(s, **CTX, leaf_divisibility={"w0@dim0": (12, 4)})


def test_reshard_pass_byte_conservation():
    s = synthetic_reshard_schedule()
    report = run_passes(CommSchedule(s.ops[:-1]), **CTX)
    assert not report.ok
    assert any(f.code in ("leaf-lost", "leaf-size-drift") for f in report.findings)


@pytest.fixture(scope="module")
def one_rank():
    init_dist("cpu")


def test_kvstore_regroup_records_barrier_ir(one_rank):
    kv = KVStore("concom", reduce_axes=("data",), num_channels=2, mesh_shape={"data": 1},
                 device="cpu")
    x = torch.ones(8)
    kv.init(0, x)
    kv.init(1, x)
    kv.push(0, x)
    kv.push(1, x * 2)
    assert float(kv.regroup()) == 1.0
    kv.push(0, x * 3)
    np.testing.assert_allclose(kv.pull(0).numpy(), 3.0)
    s = kv.schedule()
    kinds = [op.kind for op in s.ops]
    assert kinds.count(REGROUP) == 1
    rg = next(op for op in s.ops if op.kind == REGROUP)
    pre = [op.op_id for op in s.ops if op.op_id < rg.op_id]
    assert set(rg.depends_on) == set(pre[-2:])          # every chain tail
    post = [op for op in s.ops if op.op_id > rg.op_id]
    assert post and all(rg.op_id in op.depends_on for op in post)
    assert run_passes(s, mesh_shape={"data": 1}).ok


def test_kvstore_regroup_switches_communicator(one_rank):
    kv = KVStore("concom", reduce_axes=("data", "model"), num_channels=1,
                 mesh_shape={"data": 1, "model": 1}, device="cpu")
    x = torch.ones(4)
    kv.init(0, x)
    kv.push(0, x)
    kv.regroup(reduce_axes=("data",), mesh_shape={"data": 1})
    kv.push(0, x)
    kv.pull(0)
    assert kv.reduce_axes == ("data",)
    s = kv.schedule(verify=False)
    rg = next(op for op in s.ops if op.kind == REGROUP)
    assert rg.bucket.reduce_axes == ("data", "model")
    post = [op for op in s.ops if op.op_id > rg.op_id]
    assert post and all(op.bucket.reduce_axes == ("data",) for op in post)


def test_a_mesh_spans_the_world_ranks_it_names(one_rank):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import Mesh

    rung = Mesh(("data", "model"), {"data": 2, "model": 1}, (2, 5))
    assert rung.world_ranks == (2, 5)
    assert [rung.rank_in(r) for r in range(6)] == [None, None, 0, None, None, 1]
    whole = Mesh(("data", "model"), {"data": 2, "model": 2})
    assert whole.world_ranks == (0, 1, 2, 3) and whole.rank_in(3) == 3
    assert whole.rank_in(4) is None
    for bad in ((1,), (3, 1), (1, 1)):
        with pytest.raises(ValueError, match="cannot span"):
            Mesh(("data",), {"data": 2}, bad)
    assert make_mesh(1).world_ranks == (0,)         # the world of one


def test_every_rung_starts_at_the_writer(one_rank, tmp_path):
    """The anchor is written from the view its writer assembled, so the
    rungs' first world rank is one rank, and a transfer needs the old
    mesh's first rank in the new mesh."""
    from types import SimpleNamespace

    from repro_torch.elastic import Supervisor, reshard_state
    from repro_torch.parallel.sharding import Mesh

    rungs = {"a": SimpleNamespace(mesh=Mesh(("data",), {"data": 2}, (0, 1))),
             "b": SimpleNamespace(mesh=Mesh(("data",), {"data": 2}, (1, 2)))}
    sup = Supervisor(lambda k: (rungs[k], None, None), ("a", "b"), str(tmp_path))
    with pytest.raises(ValueError, match="first rank must be one"):
        sup.run(1)
    with pytest.raises(ValueError, match="would hold the view"):
        reshard_state(rungs["a"], SimpleNamespace(mesh=Mesh(("data",), {"data": 1}, (2,))),
                      None, None)
