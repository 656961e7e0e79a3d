"""The port's ``obs`` against the JAX package's: ``comm_byte_counters``
over the reference's schedules carried into the port's IR, the JSONL
``EventLog`` rows and ``heartbeat_line``, and the ``Trainer``'s metrics
on the ResNet smoke config (one-rank gloo group) beside the reference
``Trainer``'s on the same weights and batches.  Tolerance: exact for
names, counters and byte counts; the losses as
``tests/test_torch_train_step.py`` holds them (rtol 1e-4).
"""
import io
import json

import jax
import numpy as np
import pytest

from repro.analysis import mutations as ref_mutations
from repro.configs.resnet50_cifar import make_smoke as ref_make_smoke
from repro.core import GradSyncConfig as RefGradSyncConfig
from repro.data import ImagePipeline as RefImagePipeline
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.models import resnet as ref_resnet
from repro.obs import EventLog as RefEventLog
from repro.obs import MetricsRegistry as RefMetricsRegistry
from repro.obs import comm_byte_counters as ref_comm_byte_counters
from repro.obs import heartbeat_line as ref_heartbeat_line
from repro.optim import linear_scaling_rule as ref_lsr
from repro.optim import sgd as ref_sgd
from repro.runtime import Trainer as RefTrainer
from repro.runtime import make_train_step as ref_make_train_step
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.configs.resnet50_cifar import make_smoke
from repro_torch.core import GradSyncConfig
from repro_torch.data import ImagePipeline
from repro_torch.launch.mesh import init_dist, make_dp_mesh
from repro_torch.models.resnet import ResNet
from repro_torch.obs import EventLog, MetricsRegistry, comm_byte_counters, heartbeat_line
from repro_torch.optim import linear_scaling_rule, sgd
from repro_torch.runtime import Trainer, make_train_step
from repro_torch.sim import SimConfig, simulate
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names
from test_torch_plan import _from_reference

STEPS, BATCH = 4, 8
SIM_METRICS = {"sim.step_time_s", "sim.exposed_comm_s"}


def _schedules():
    out = [(name, s) for name, s, _ in ref_mutations.valid_cases()]
    tagged = ref_mutations._compressed_int_wire()[0]
    return out + [("compressed-tags", tagged)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("name,schedule", _schedules(), ids=[n for n, _ in _schedules()])
def test_comm_byte_counters_match_reference(name, schedule, itemsize):
    want, got = RefMetricsRegistry(), MetricsRegistry()
    ref_comm_byte_counters(schedule, want, itemsize=itemsize)
    comm_byte_counters(_from_reference(schedule), got, itemsize=itemsize)
    assert got.snapshot() == want.snapshot()
    wire = any(op.kind in ("allreduce", "reduce_scatter", "all_gather")
               for op in schedule.ops)
    assert bool(got.snapshot()) == wire


def _rows(log_cls, fields):
    buf = io.StringIO()
    log = log_cls(buf)
    for kind, kw in fields:
        log.emit(kind, **kw)
    log.close()
    log.emit("after-close", x=1)         # a closed log drops rows
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def test_event_log_rows_match_reference():
    fields = [("compile", {"step": 0, "dt": 1.5}),
              ("step", {"step": 1, "loss": 2.25, "dt": 0.1, "grad_norm": 0.5,
                        "tokens": 0, "compile_step": False})]
    got, want = _rows(EventLog, fields), _rows(RefEventLog, fields)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert {k: v for k, v in g.items() if not k.startswith("t_")} == {
            k: v for k, v in w.items() if not k.startswith("t_")}


@pytest.mark.parametrize("kw", [
    {}, {"loss": 2.3456789, "step_ms": 12.345},
    {"loss": 1.0, "step_ms": 3.0, "avg_ms": 2.5, "tokens_per_s": 123456.7,
     "grad_norm": 0.1234, "compile_s": 4.56},
    {"grad_norm": 0.0, "compile_s": 0.0}])
def test_heartbeat_line_matches_reference(kw):
    assert heartbeat_line(7, **kw) == ref_heartbeat_line(7, **kw)


@pytest.fixture(scope="module")
def group():
    init_dist("cpu")
    return make_dp_mesh()


@pytest.fixture(scope="module")
def ref_run():
    cfg = ref_make_smoke()
    mesh = ref_smoke_mesh(1, 1)
    params = ref_resnet.init_params(jax.random.PRNGKey(0), cfg)
    named = {n: np.asarray(p) for n, p in ref_flatten(params)[0]}
    pipe = RefImagePipeline(cfg.img_size, cfg.num_classes, BATCH, mesh=mesh)
    opt = ref_sgd(ref_lsr(0.1, 256, 256), momentum=0.9)
    ts = ref_make_train_step(
        cfg, mesh, RefGradSyncConfig(strategy="concom", num_channels=4), opt,
        batch_like=pipe.batch_at(0), params_like=params, clip_norm=1.0)
    _, _, hist = RefTrainer(ts, pipe, None, log_every=1000,
                            printer=lambda _m: None).run(params, opt.init(params), STEPS)
    return named, hist


def test_trainer_metrics_match_reference(group, ref_run, tmp_path):
    named, want = ref_run
    cfg = make_smoke()
    model = ResNet(cfg, params_from_numpy(named, "cpu"))
    opt = sgd(linear_scaling_rule(0.1, 256, 256), momentum=0.9)
    ts = make_train_step(cfg, group, GradSyncConfig(strategy="concom", num_channels=4),
                         opt, model=model, clip_norm=1.0, device="cpu")
    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, BATCH, mesh=group,
                         device="cpu")
    params = dict(flatten_with_names(model.params_tree())[0])
    lines = []
    events = tmp_path / "events.jsonl"
    trainer = Trainer(ts, pipe, log_every=2, printer=lines.append,
                      events_path=str(events))
    _, _, hist = trainer.run(model, opt.init(params), STEPS)

    snap, ref_snap = hist["metrics"], want["metrics"]
    assert set(snap) == set(ref_snap)
    assert SIM_METRICS <= set(snap)
    # the simulator's gauges: the port's simulate on the step's schedule
    gs = ts.gradsync
    tl = simulate(gs.schedule, gs.mesh_shape, compute=gs.cfg.sim_compute,
                  sim=SimConfig(itemsize=4, reducer="flat", fused_staging=True))
    assert (snap["sim.step_time_s"], snap["sim.exposed_comm_s"]) == (
        tl.step_time, tl.exposed_comm)
    assert tl.step_time > 0
    for k in snap:
        if k.startswith("comm_bytes.") or k in ("steps_total", "mem.state_bytes"):
            assert snap[k] == ref_snap[k], k
    assert any(k.startswith("comm_bytes.allreduce.") for k in snap)
    assert snap["step_time_s"]["count"] == ref_snap["step_time_s"]["count"] == STEPS - 1
    assert snap["compile_time_s"] == hist["compile_time"] == trainer.first_step_time > 0
    assert snap["loss"] == hist["losses"][-1]
    np.testing.assert_allclose(hist["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(snap["grad_norm"], ref_snap["grad_norm"], rtol=1e-4)
    assert [e["kind"] for e in hist["events"]] == [
        e["kind"] for e in want["events"]] == ["compile"]

    rows = [json.loads(line) for line in events.read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["compile"] + ["step"] * STEPS
    assert [r["compile_step"] for r in rows[1:]] == [True] + [False] * (STEPS - 1)
    assert [r["loss"] for r in rows[1:]] == hist["losses"]
    # the trainer line and the heartbeat at steps 0 and 2
    assert len(lines) == 4 and lines[1].startswith("[obs] step 0 loss ")
    assert "(compile " in lines[3] and "avg " in lines[3]
