"""The port's checkpointing (``repro_torch.checkpoint``) and the Trainer's
fault rungs against the JAX package's, on one rank on the CPU.

  - ``tests/test_checkpoint.py``'s thirteen cases on torch trees: the
    round trip, atomicity, retention, async, shape mismatch, reshard,
    divisibility, save and restore retries, exhaustion, atomicity under
    a fault, ``save_now`` and the manifest; and
    ``tests/test_reshard_properties.py``'s properties against the port's
    ``validate_divisibility``.
  - Across the packages, on the qwen3-1.7b smoke config's params and
    AdamW state: a checkpoint written by ``repro.checkpoint.save``
    restores in the port with equal values and names, one written by the
    port restores in ``repro.checkpoint.restore``, and the two manifests
    are equal; bf16 leaves survive the f32 widening on disk exactly.
  - The async snapshot: the port's step updates its tensors in place, so
    an async save must copy them first: an in-place update right after
    ``maybe_save`` (the writer held back by its fault injector) leaves
    the saved step's values on disk.
  - The ``Trainer`` against the reference's for the same ``fail_at``,
    ``step_retries`` and ``fault_injector`` plans (checkpoints every 2
    steps): the same events at the same steps, the params within 1e-6.
  - The reference's elastic check 8 at tp = 1: a deferred ZeRO-1 run
    killed and recovered from the plain checkpoint equals the
    uninterrupted one bit for bit, and the restore guard refuses a
    checkpoint without the carry.
"""
import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as ref_restore
from repro.checkpoint import save as ref_save
from repro.configs import get_arch as ref_get_arch
from repro.core import GradSyncConfig as RefGradSyncConfig
from repro.data import TokenPipeline as RefTokenPipeline
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro.runtime import make_train_step as ref_make_train_step
from repro.runtime.train_loop import Trainer as RefTrainer
from repro.runtime.train_loop import TransientStepError as RefTransient
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.checkpoint import CheckpointManager, reshard, restore, save
from repro_torch.checkpoint.manager import latest_step
from repro_torch.checkpoint.reshard import validate_divisibility
from repro_torch.core import GradSyncConfig
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import init_dist, make_dp_mesh, make_smoke_mesh
from repro_torch.models.transformer import Transformer, TransformerConfig
from repro_torch.optim import adamw, zero1
from repro_torch.parallel.sharding import ShardingRules
from repro_torch.runtime import Trainer, TransientStepError, make_train_step
from repro_torch.utils.convert import params_from_numpy, tensor_from_numpy
from repro_torch.utils.trees import flatten_with_names, tree_leaves

TRAINER_TOL = 1e-6


def _tree():
    return {
        "params": {"w": torch.arange(24.0).reshape(4, 6),
                   "b": torch.ones(3, dtype=torch.bfloat16)},
        "opt": {"m": {"w": torch.zeros(4, 6), "b": torch.zeros(3)}},
    }


def _leaves(tree) -> list:
    return [t.float() for t in tree_leaves(tree)]


def _equal(a, b) -> None:
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# ----------------------------------------- tests/test_checkpoint.py's cases

def test_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 7, t)
    out = restore(str(tmp_path), 7, t)
    _equal(out, t)
    assert out["params"]["b"].dtype == torch.bfloat16


def test_atomicity_ignores_tmp(tmp_path):
    save(str(tmp_path), 3, _tree())
    os.makedirs(tmp_path / "step_00000009.tmp")      # a crashed write
    assert latest_step(str(tmp_path)) == 3


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2, blocking=True)
    t = _tree()
    for s in range(1, 6):
        mgr.maybe_save(s, t)
    steps = sorted(d for d in os.listdir(tmp_path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    assert len(steps) == 2
    assert mgr.latest() == 5


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=3, blocking=False)
    t = _tree()
    mgr.maybe_save(1, t)
    mgr.wait()
    s, out = mgr.restore(t)
    assert s == 1
    _equal(out["params"]["w"], t["params"]["w"])


def test_shape_mismatch_detected(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t)
    bad = _tree()
    bad["params"]["w"] = torch.zeros(5, 6)
    with pytest.raises(ValueError, match="checkpoint"):
        restore(str(tmp_path), 1, bad)


def test_reshard_elastic(tmp_path):
    """A checkpoint restores onto another mesh: the blocks each rank keeps
    (here the one-rank smoke mesh, so the whole tree)."""
    rules = ShardingRules(rules=(("w", (None, "model")),))
    t = {"w": torch.arange(32.0).reshape(4, 8), "b": torch.ones(4)}
    save(str(tmp_path), 1, t)
    placed = reshard(restore(str(tmp_path), 1, t), rules, make_smoke_mesh(1, 1), rank=0)
    _equal(placed, t)
    two = make_smoke_mesh(1, 2)
    np.testing.assert_array_equal(reshard(t, rules, two, rank=1)["w"].numpy(),
                                  t["w"][:, 4:].numpy())


def test_reshard_divisibility_error():
    rules = ShardingRules(rules=(("w", (None, "model")),))
    t = {"w": torch.zeros(4, 7)}      # 7 is not divisible by a model axis > 1

    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 2}

    with pytest.raises(ValueError, match="not divisible"):
        validate_divisibility(t, rules.tree_specs(t), FakeMesh())


class _FlakyIO:
    """Raises OSError for the first ``n`` attempts of the given ops."""

    def __init__(self, n, ops=("save", "restore"), sleep=0.0):
        self.left = n
        self.ops = ops
        self.calls = []
        self.sleep = sleep

    def __call__(self, op):
        self.calls.append(op)
        time.sleep(self.sleep)
        if op in self.ops and self.left > 0:
            self.left -= 1
            raise OSError(f"injected {op} fault")


def test_save_retries_absorb_transient_faults(tmp_path):
    flaky = _FlakyIO(2, ops=("save",))
    mgr = CheckpointManager(str(tmp_path), every=1, blocking=True, retries=3,
                            backoff_s=0.001, fault_injector=flaky)
    t = _tree()
    assert mgr.maybe_save(1, t)
    assert flaky.calls.count("save") == 3          # 2 faults + 1 success
    s, out = mgr.restore(t)
    assert s == 1
    _equal(out["params"]["w"], t["params"]["w"])


def test_restore_retries_absorb_transient_faults(tmp_path):
    t = _tree()
    CheckpointManager(str(tmp_path), every=1, blocking=True).maybe_save(1, t)
    flaky = _FlakyIO(2, ops=("restore",))
    mgr = CheckpointManager(str(tmp_path), every=1, retries=2, backoff_s=0.001,
                            fault_injector=flaky)
    s, _ = mgr.restore(t)
    assert s == 1 and flaky.calls.count("restore") == 3


def test_retries_exhausted_reraises(tmp_path):
    flaky = _FlakyIO(10)
    mgr = CheckpointManager(str(tmp_path), every=1, blocking=True, retries=2,
                            backoff_s=0.001, fault_injector=flaky)
    with pytest.raises(OSError, match="injected save fault"):
        mgr.maybe_save(1, _tree())
    assert flaky.calls.count("save") == 3          # retries + 1, then raise


def test_atomicity_preserved_under_fault(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, blocking=True)
    t = _tree()
    mgr.maybe_save(1, t)
    mgr2 = CheckpointManager(str(tmp_path), every=1, blocking=True, retries=1,
                             backoff_s=0.001, fault_injector=_FlakyIO(10))
    bad = _tree()
    for x in tree_leaves(bad):
        x.fill_(-1)
    with pytest.raises(OSError):
        mgr2.maybe_save(2, bad)
    assert latest_step(str(tmp_path)) == 1
    _, out = mgr.restore(t)
    _equal(out["params"]["w"], t["params"]["w"])


def test_save_now_blocking_anchor(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=100, blocking=False)
    t = _tree()
    assert not mgr.maybe_save(7, t)     # off the periodic grid
    mgr.save_now(7, t)                  # the supervisor's anchor path
    assert mgr.latest() == 7


def test_manifest_lists_leaf_names(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, blocking=True)
    t = _tree()
    t["opt"]["pending"] = {"0": torch.zeros(4)}
    mgr.maybe_save(1, t)
    names = mgr.manifest(1)
    assert "params/w" in names
    assert any("pending" in n for n in names)
    with pytest.raises(OSError):
        mgr.manifest(99)


def test_async_snapshot_survives_an_in_place_step(tmp_path):
    """The writer thread is held back by its fault injector while the
    tensors are updated in place, as the port's next step does: the
    checkpoint holds the values of the step it was taken at."""
    mgr = CheckpointManager(str(tmp_path), every=1, blocking=False,
                            fault_injector=_FlakyIO(0, sleep=0.3))
    t = _tree()
    want = {n: x.clone() for n, x in flatten_with_names(t)[0]}
    mgr.maybe_save(1, t)
    for x in tree_leaves(t):
        x.add_(1)
    mgr.wait()
    _, out = mgr.restore(t)
    for n, x in flatten_with_names(out)[0]:
        torch.testing.assert_close(x, want[n], rtol=0, atol=0)


# ----------------------------------------------- across the two packages

def _lm_trees(dtype=None):
    """The qwen3-1.7b smoke config's params and one AdamW step's state, in
    the reference (JAX) and the port (torch), equal leaf for leaf."""
    cfg = ref_get_arch("qwen3-1.7b").make_smoke()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg)
    opt = ref_adamw(1e-3)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), params)
    _, state = opt.update(grads, opt.init(params), params, jnp.int32(0))
    ref = {"params": params, "opt": state}
    port = {"params": params_from_numpy({n: np.asarray(p) for n, p in ref_flatten(params)[0]}),
            "opt": {k: {n: tensor_from_numpy(np.asarray(v))
                        for n, v in ref_flatten(sub)[0]} for k, sub in state.items()}}
    return ref, port


def _names_values(tree, ref: bool) -> dict:
    named = ref_flatten(tree)[0] if ref else flatten_with_names(tree)[0]
    if ref:
        return {n: np.asarray(v, np.float32) for n, v in named}
    return {n: v.float().numpy() for n, v in named}


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16], ids=["smoke", "bf16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    ref, port = _lm_trees(dtype)
    ref_save(str(tmp_path), 5, ref)
    out = restore(str(tmp_path), 5, port)
    got, want = _names_values(out, False), _names_values(ref, True)
    assert list(got) == list(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    if dtype is not None:
        assert out["params"]["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16], ids=["smoke", "bf16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, dtype):
    ref, port = _lm_trees(dtype)
    save(str(tmp_path / "port"), 5, port)
    ref_save(str(tmp_path / "ref"), 5, ref)
    out = ref_restore(str(tmp_path / "port"), 5, ref)
    got, want = _names_values(out, True), _names_values(port, False)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    if dtype is not None:
        assert np.asarray(out["params"]["embed"]).dtype == jnp.bfloat16
    manifests = [json.load(open(tmp_path / side / "step_00000005" / "manifest.json"))
                 for side in ("port", "ref")]
    assert manifests[0] == manifests[1]


# ------------------------------------------------ the Trainer's rungs

CFG = dict(name="pipelined", n_layers=2, d_model=32, n_heads=4, kv_heads=2, d_ff=64,
           vocab=64, tp=1, attn_chunk=16)
SYNC = dict(strategy="concom", bucket_bytes=1 << 14)
STEPS = 8
# (fail_at, step_retries, transient steps)
PLANS = {"fail": ({3}, 0, ()), "retry": (set(), 1, (1, 4)),
         "exhausted": ({6}, 0, (5,))}
# both Trainers time their steps on the host: a factor this far above any
# host noise keeps load-dependent ``straggler`` events out of the
# lifecycles compared
STRAGGLER_FACTOR = 1e9


@pytest.fixture(scope="module")
def group():
    init_dist("cpu")
    return make_dp_mesh()


def _weights():
    cfg = ref_tf.TransformerConfig(**CFG, dtype=jnp.float32)
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, {n: np.asarray(p) for n, p in ref_flatten(params)[0]}


def _injector(error, steps):
    fired = set()

    def inject(step):
        if step in steps and step not in fired:
            fired.add(step)
            raise error(f"injected transient @ {step}")
    return inject


def _ref_trainer(root, plan):
    cfg, params, _ = _weights()
    mesh = ref_smoke_mesh(1, 1)
    pipe = RefTokenPipeline(64, 16, 4, seed=7, mesh=mesh)
    ts = ref_make_train_step(cfg, mesh, RefGradSyncConfig(**SYNC), ref_adamw(1e-3),
                             batch_like=pipe.batch_at(0), params_like=params, clip_norm=0.0)
    fail_at, retries, transient = PLANS[plan]
    from repro.checkpoint import CheckpointManager as RefManager

    tr = RefTrainer(ts, pipe, RefManager(root, every=2, keep=0, blocking=True),
                    fail_at=frozenset(fail_at), step_retries=retries,
                    straggler_factor=STRAGGLER_FACTOR,
                    fault_injector=_injector(RefTransient, transient),
                    printer=lambda _s: None, log_every=10_000)
    p, _, rep = tr.run(params, ts.init_opt(), STEPS)
    return {n: np.asarray(v) for n, v in ref_flatten(p)[0]}, rep


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_trainer_rungs_match_the_reference(group, tmp_path, plan):
    _, _, named = _weights()
    cfg = TransformerConfig(**CFG, dtype=torch.float32)
    model = Transformer(cfg, params_from_numpy(named, "cpu"))
    ts = make_train_step(cfg, group, GradSyncConfig(**SYNC), adamw(1e-3), model=model,
                         clip_norm=0.0, device="cpu")
    fail_at, retries, transient = PLANS[plan]
    tr = Trainer(ts, TokenPipeline(64, 16, 4, seed=7, mesh=group, device="cpu"),
                 CheckpointManager(str(tmp_path / "port"), every=2, keep=0, blocking=True),
                 fail_at=frozenset(fail_at), step_retries=retries,
                 straggler_factor=STRAGGLER_FACTOR,
                 fault_injector=_injector(TransientStepError, transient),
                 printer=lambda _s: None, log_every=10_000)
    model, _, rep = tr.run(model, ts.init_opt(), STEPS)
    want, ref_rep = _ref_trainer(str(tmp_path / "ref"), plan)

    def lifecycle(events):
        return [(e["kind"], e["step"]) for e in events if e["kind"] != "compile"]

    assert lifecycle(rep["events"]) == lifecycle(ref_rep["events"])
    assert lifecycle(rep["events"])          # the plan did fire
    for n, p in flatten_with_names(model.params_tree())[0]:
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=TRAINER_TOL,
                                   err_msg=n)


def _deferred(tmp_path, name, fail_at=frozenset(), every=2, ckpt=True):
    _, _, named = _weights()
    cfg = TransformerConfig(**CFG, dtype=torch.float32)
    mesh = make_dp_mesh()
    model = Transformer(cfg, params_from_numpy(named, "cpu"))
    ts = make_train_step(cfg, mesh, GradSyncConfig(**SYNC, exclude_axes=("data",)),
                         zero1(adamw(1e-3), ("data",), 1), model=model, clip_norm=0.0,
                         zero1_mode=True, zero1_plan="deferred", device="cpu")
    ck = CheckpointManager(str(tmp_path / name), every=every, keep=0, blocking=True) \
        if ckpt else None
    tr = Trainer(ts, TokenPipeline(64, 16, 4, seed=7, mesh=mesh, device="cpu"), ck,
                 fail_at=frozenset(fail_at), printer=lambda _s: None, log_every=10_000)
    return ts, model, tr


def test_deferred_plan_resumes_exactly_from_the_plain_checkpoint(group, tmp_path):
    ts, model, tr = _deferred(tmp_path, "kill", fail_at={5})
    m_kill, o_kill, rep = tr.run(model, ts.init_opt(), STEPS)
    ts2, model2, tr2 = _deferred(tmp_path, "ok", ckpt=False)
    m_ok, o_ok, _ = tr2.run(model2, ts2.init_opt(), STEPS)
    assert "recover" in [e["kind"] for e in rep["events"]]
    ts.finalize(m_kill, o_kill)
    ts2.finalize(m_ok, o_ok)
    for (n, a), (_, b) in zip(flatten_with_names(m_kill.params_tree())[0],
                              flatten_with_names(m_ok.params_tree())[0]):
        assert torch.equal(a, b), n


def test_restore_guard_refuses_a_checkpoint_without_the_carry(group, tmp_path):
    ts, model, tr = _deferred(tmp_path, "guard")
    state = ts.init_opt()
    CheckpointManager(str(tmp_path / "guard"), every=1, blocking=True).maybe_save(
        1, {"params": model.params_tree(),
            "opt": {k: v for k, v in state.items() if k != "pending"}})
    with pytest.raises(RuntimeError, match="pending"):
        tr.run(model, state, STEPS)


# ----------------------------------- tests/test_reshard_properties.py's

hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies

mesh_sizes = st.fixed_dictionaries({"data": st.sampled_from([1, 2, 4, 8]),
                                    "model": st.sampled_from([1, 2, 4, 8])})
SETTINGS = hypothesis.settings(max_examples=60, deadline=None,
                               suppress_health_check=list(hypothesis.HealthCheck))


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _leaf(shape):
    return torch.empty(tuple(shape), device="meta")


@SETTINGS
@hypothesis.given(mesh=mesh_sizes, rows=st.integers(1, 8), cols=st.integers(1, 8))
def test_divisible_layouts_always_validate(mesh, rows, cols):
    tree = {"w": _leaf((rows * mesh["data"], cols * mesh["model"])),
            "b": _leaf((cols * mesh["model"],))}
    validate_divisibility(tree, {"w": ("data", "model"), "b": ("model",)}, FakeMesh(mesh))


@SETTINGS
@hypothesis.given(mesh=mesh_sizes, rows=st.integers(1, 8))
def test_indivisible_leaf_fails_loudly(mesh, rows):
    hypothesis.assume(mesh["model"] > 1)
    tree = {"ok": _leaf((4 * mesh["data"],)), "bad": _leaf((2, rows * mesh["model"] + 1))}
    with pytest.raises(ValueError) as e:
        validate_divisibility(tree, {"ok": ("data",), "bad": (None, "model")}, FakeMesh(mesh))
    assert "bad" in str(e.value) and "not divisible" in str(e.value)


@SETTINGS
@hypothesis.given(mesh=mesh_sizes, k=st.integers(1, 6))
def test_tuple_axis_specs_use_product(mesh, k):
    prod = mesh["data"] * mesh["model"]
    specs = {"w": (("data", "model"), None)}
    validate_divisibility({"w": _leaf((k * prod, 3))}, specs, FakeMesh(mesh))
    if prod > 1:
        with pytest.raises(ValueError, match="not divisible"):
            validate_divisibility({"w": _leaf((k * prod + 1, 3))}, specs, FakeMesh(mesh))


@SETTINGS
@hypothesis.given(old=mesh_sizes, new=mesh_sizes, k=st.integers(1, 4))
def test_grow_shrink_roundtrip_validates_against_target(old, new, k):
    tree = {"w": _leaf((k * old["data"] * new["data"], old["model"] * new["model"]))}
    specs = {"w": ("data", "model")}
    validate_divisibility(tree, specs, FakeMesh(old))
    validate_divisibility(tree, specs, FakeMesh(new))


@SETTINGS
@hypothesis.given(mesh=mesh_sizes)
def test_plan_reshard_divisibility_shares_the_rule(mesh):
    from repro_torch.analysis import ScheduleError, verify_schedule
    from repro_torch.analysis.mutations import (
        NEW_MESH_RS,
        OLD_MESH_RS,
        synthetic_reshard_schedule,
    )

    s = synthetic_reshard_schedule()
    n = mesh["data"] * mesh["model"]
    verify_schedule(s, old_mesh_shape=OLD_MESH_RS, new_mesh_shape=NEW_MESH_RS,
                    leaf_divisibility={"w@dim0": (8 * n, n)})
    if n > 1:
        with pytest.raises(ScheduleError, match="leaf-indivisible"):
            verify_schedule(s, old_mesh_shape=OLD_MESH_RS, new_mesh_shape=NEW_MESH_RS,
                            leaf_divisibility={"w@dim0": (8 * n + 1, n)})
