"""The port's ``auto`` strategy (``repro_torch.sim.autotune.plan_auto``)
against the JAX package's, and the slice as a whole: a ResNet smoke
``make_train_step(strategy="auto")`` on a one-rank gloo group against
the reference's.

- ``plan_auto`` on the analyzer's stand-in plans, with the same model
  values handed to both (the network through the context), without and
  with a ZeRO-1 context (scheduled and deferred, accumulation on and
  off) and with a pipeline context: the same winner, the same ranking
  (bit-equal step times: both are float64 over the same arithmetic), the
  same family, and the winner's schedule op for op.
- The network ``auto`` ranks with: a profile under
  ``$REPRO_TORCH_NETPROFILE_DIR`` is used, a poor one and one under the
  reference's ``$REPRO_NETPROFILE_DIR`` never are.
- The step: both packages rank with the same ``sim_compute`` and a
  network profile of the same values (each under its own directory), so
  they pick the same winner, plan the same schedule op for op, and the
  losses agree within rtol 1e-4 as ``tests/test_torch_train_step.py``
  holds them; the Trainer's ``sim.*`` gauges equal the port's
  ``simulate`` on the step's schedule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.sim as R
from repro.configs.resnet50_cifar import make_smoke as ref_make_smoke
from repro.core import GradSyncConfig as RefGradSyncConfig
from repro.data import ImagePipeline as RefImagePipeline
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.models import resnet as ref_resnet
from repro.obs import calibrate as ref_calibrate
from repro.optim import linear_scaling_rule as ref_lsr
from repro.optim import sgd as ref_sgd
from repro.runtime import make_train_step as ref_make_train_step
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch import sim as T
from repro_torch.analysis import cli as port_cli
from repro_torch.configs.resnet50_cifar import make_smoke
from repro_torch.core import GradSyncConfig
from repro_torch.data import ImagePipeline
from repro_torch.launch.mesh import init_dist, make_dp_mesh
from repro_torch.models.resnet import ResNet
from repro_torch.obs import MetricsRegistry, calibrate
from repro_torch.optim import linear_scaling_rule, sgd
from repro_torch.runtime import Trainer, make_train_step
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names

from test_torch_plan import _op_fields
from test_torch_sim import COMPUTE, _plans, ref_cm, ref_net

STEPS, BATCH = 3, 8


def _ctx(net, mesh_shape, **extra):
    return {"mesh_shape": mesh_shape, "reducer": "flat", "itemsize": 4,
            "fused_staging": True, "net": net, **extra}


ZERO1 = [None,
         {"dp_axes": ("data",), "dp_size": 0, "clip": True, "defer": False},
         {"dp_axes": ("data",), "dp_size": 0, "clip": True, "defer": True},
         {"dp_axes": ("data",), "dp_size": 0, "clip": False, "defer": False,
          "accum": 4, "accum_overlap": False}]


@pytest.mark.parametrize("mesh_name", sorted(port_cli.MESHES))
@pytest.mark.parametrize("zero1", range(len(ZERO1)), ids=["plain", "zero1", "deferred",
                                                          "accum4"])
def test_plan_auto_matches_reference(mesh_name, zero1):
    net = T.default_network()
    mesh_shape = port_cli.MESHES[mesh_name][0]
    z = ZERO1[zero1]
    plan, ref_plan = _plans(mesh_name, zero1=z is not None, bucket_bytes=256 * 1024,
                            num_channels=4)
    extra = {} if z is None else {"zero1": {**z, "dp_size": mesh_shape["data"]}}
    for compute in (T.ComputeModel(t_fwd=0.0, t_bwd=0.0), COMPUTE):
        got = T.plan_auto(plan, context=_ctx(net, mesh_shape, compute=compute, **extra))
        got_report = T.last_auto_report()
        want = R.plan_auto(ref_plan, context=_ctx(ref_net(net), mesh_shape,
                                                  compute=ref_cm(compute), **extra))
        want_report = R.last_auto_report()
        assert got_report == want_report
        assert got_report["net"] == "context"
        assert _op_fields(got) == _op_fields(want)
        assert got_report["zero1"] is (z is not None)
        if z is not None:
            assert got_report["plan"] == ("deferred" if z["defer"] else "zero1")


def test_plan_auto_pipeline_context_matches_reference():
    net = T.default_network()
    mesh_shape = {"data": 2, "stage": 2}
    plan, ref_plan = _plans("dp8", zero1=True, bucket_bytes=256 * 1024, num_channels=4)
    for sched in ("auto", "gpipe", "1f1b"):
        pp = {"stages": 2, "schedule": sched, "microbatches": 4,
              "activation_bytes": 1 << 20}
        z = {"zero1": {"dp_axes": ("data",), "dp_size": 2, "clip": False,
                       "defer": False}}
        got = T.plan_auto(plan, context=_ctx(net, mesh_shape, compute=COMPUTE, pp=pp, **z))
        got_report = T.last_auto_report()
        want = R.plan_auto(ref_plan, context=_ctx(ref_net(net), mesh_shape,
                                                  compute=ref_cm(COMPUTE), pp=pp, **z))
        assert got_report == R.last_auto_report()
        assert got_report["plan"].startswith("pp:")
        if sched != "auto":
            assert got_report["pp_schedule"] == sched
        assert _op_fields(got) == _op_fields(want)


def test_auto_ranks_with_the_ports_own_profiles(tmp_path, monkeypatch):
    """``auto`` without a network in its context reads the port's profile
    directory: a fitted profile ranks, a poor one and one in the
    reference's directory do not."""
    mesh_shape = {"data": 2, "model": 4}
    plan, _ = _plans("smoke-dp2tp4", bucket_bytes=256 * 1024, num_channels=4)
    ctx = {"mesh_shape": mesh_shape, "compute": COMPUTE}
    fitted = T.NetworkModel(links=(
        ("data", T.LinkModel("data", bandwidth=8e9, latency=4e-6)),
        ("model", T.LinkModel("model", bandwidth=3.2e10, latency=1.5e-6))))
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_calibrate.save_profile(ref_net(fitted), mesh_shape, dir=str(ref_dir))
    monkeypatch.setenv("REPRO_NETPROFILE_DIR", str(ref_dir))
    monkeypatch.setenv(calibrate.PROFILE_DIR_ENV, str(port_dir))
    T.plan_auto(plan, context=ctx)
    default = T.last_auto_report()
    assert default["net"] == "default"

    calibrate.save_profile(fitted, mesh_shape, dir=str(port_dir),
                           info={"quality": "poor"})
    T.plan_auto(plan, context=ctx)
    assert T.last_auto_report()["net"] == "default"

    path = calibrate.save_profile(fitted, mesh_shape, dir=str(port_dir))
    T.plan_auto(plan, context=ctx)
    report = T.last_auto_report()
    assert report["net"] == f"fitted:{path}"
    want = T.rank_strategies(plan, mesh_shape, compute=COMPUTE, net=fitted,
                             sim=T.SimConfig(), in_scan_active=False)
    assert report["ranking"] == [(n, tl.step_time) for n, tl in want]
    assert report["ranking"] != default["ranking"]


# ------------------------------------------------ the slice as a whole

@pytest.fixture(scope="module")
def group():
    init_dist("cpu")
    return make_dp_mesh()


@pytest.fixture(scope="module")
def ref_weights():
    params = ref_resnet.init_params(jax.random.PRNGKey(0), ref_make_smoke())
    return params, {n: np.asarray(p) for n, p in ref_flatten(params)[0]}


def test_auto_train_step_matches_reference(group, ref_weights, tmp_path, monkeypatch):
    # one network model for both packages, each from its own profile dir
    net = T.NetworkModel(links=(("data", T.LinkModel("data", 2e9, 2e-5)),))
    mesh_shape = {"data": 1, "model": 1}
    monkeypatch.setenv("REPRO_NETPROFILE_DIR", str(tmp_path / "ref"))
    monkeypatch.setenv(calibrate.PROFILE_DIR_ENV, str(tmp_path / "port"))
    ref_calibrate.save_profile(ref_net(net), mesh_shape, dir=str(tmp_path / "ref"))
    port_profile = calibrate.save_profile(net, mesh_shape, dir=str(tmp_path / "port"))

    cfg = ref_make_smoke()
    mesh = ref_smoke_mesh(1, 1)
    params, named = ref_weights
    pipe = RefImagePipeline(cfg.img_size, cfg.num_classes, BATCH, mesh=mesh)
    opt = ref_sgd(ref_lsr(0.1, 256, 256), momentum=0.9)
    ref_ts = ref_make_train_step(
        cfg, mesh, RefGradSyncConfig(strategy="auto", num_channels=4,
                                     sim_compute=ref_cm(COMPUTE)),
        opt, batch_like=pipe.batch_at(0), params_like=params, clip_norm=1.0)
    want_report = R.last_auto_report()
    opt_state = opt.init(params)
    want = []
    for step in range(STEPS):
        params, opt_state, m = ref_ts.fn(params, opt_state, pipe.batch_at(step),
                                         jnp.int32(step))
        want.append(float(m["loss"]))

    cfg = make_smoke()
    model = ResNet(cfg, params_from_numpy(named, "cpu"))
    opt = sgd(linear_scaling_rule(0.1, 256, 256), momentum=0.9)
    ts = make_train_step(cfg, group, GradSyncConfig(strategy="auto", num_channels=4,
                                                    sim_compute=COMPUTE),
                         opt, model=model, clip_norm=1.0, device="cpu")
    report = T.last_auto_report()
    assert report["winner"] == want_report["winner"]
    assert report["ranking"] == want_report["ranking"]
    assert report["net"] == f"fitted:{port_profile}"
    assert _op_fields(ts.gradsync.schedule) == _op_fields(ref_ts.gradsync.schedule)
    # the delegated schedule is the winner's own
    fixed = T.simulate_strategy(report["winner"], ts.gradsync.plan, mesh_shape)[0]
    assert _op_fields(ts.gradsync.schedule) == _op_fields(fixed)

    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, BATCH, mesh=group, device="cpu")
    metrics = MetricsRegistry()
    params = dict(flatten_with_names(model.params_tree())[0])
    trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None, metrics=metrics)
    _, _, hist = trainer.run(model, opt.init(params), STEPS)
    ts.close()
    np.testing.assert_allclose(hist["losses"], want, rtol=1e-4)
    tl = T.simulate(ts.gradsync.schedule, ts.gradsync.mesh_shape, compute=COMPUTE,
                    sim=T.SimConfig(itemsize=4, reducer="flat", fused_staging=True))
    snap = metrics.snapshot()
    assert snap["sim.step_time_s"] == tl.step_time > COMPUTE.end
    assert snap["sim.exposed_comm_s"] == tl.exposed_comm
