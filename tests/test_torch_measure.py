"""The port's measured path (``repro_torch.obs.measure``, ``calibrate``,
``python -m repro_torch.obs``) against the JAX package's.

- Calibration: ``fit_network`` and ``fit_staging`` recover known α/β and
  staging figures from synthetic rows, as the reference's tests do
  (``tests/test_obs.py``), and give the reference's fit on the same rows
  (the models' figures within rtol 1e-9: both solve one least-squares
  problem with numpy, whose result may differ in the last bits between
  the two orders the packages build their rows' axes in; the quality
  verdicts equal); the quality gate; a profile saved by either package
  loads into an equal model in the other; a poor or corrupt profile is
  absent.
- The measured replay (worker mode ``measure`` of
  ``tests/_torch_mdworker.py``: one spawn of 4 gloo ranks at data 2 ×
  model 2): at reps 1 and 3 the replayed outputs are bit-equal to
  ``execute``'s (for a ZeRO-1 StepProgram with clipping also the grad
  norm and the update shards); the Timeline's ops, kinds and bucket ids
  equal the reference simulator's on the reference's own schedule of the
  same configuration, which equals the port's op for op.
- ``python -m repro_torch.obs --diff --trace`` on 4 gloo ranks.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import repro.sim as R
from repro.analysis.cli import StaticMesh
from repro.core import GradSync as RefGradSync
from repro.core import GradSyncConfig as RefGradSyncConfig
from repro.obs import calibrate as ref_calibrate
from repro.parallel.sharding import localize_structs as ref_localize
from repro_torch import sim as T
from repro_torch.obs import SCHEMA_VERSION, bench_metadata, calibrate

from _torch_mdworker import MEASURE_KIB, MEASURE_MESH, MEASURE_RUNS, WORLD, run_all
from test_torch_sim import ref_net

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_RTOL = 1e-9


def _true_network():
    # "model" FASTER than "data": the fastest-link-first RS/AG order under
    # the fitted model differs from the default's (the refit loop runs)
    return T.NetworkModel(links=(
        ("data", T.LinkModel("data", bandwidth=8e9, latency=4e-6)),
        ("model", T.LinkModel("model", bandwidth=3.2e10, latency=1.5e-6))))


def _wire_rows(true, mesh_shape, *, with_staging=False):
    rows = []
    for kind in ("allreduce", "reduce_scatter", "all_gather"):
        for nbytes in (1 << 14, 1 << 16, 1 << 18, 1 << 20):
            for axes in (("data",), ("model",), ("data", "model")):
                t = true.collective_time(kind, nbytes, axes, mesh_shape)
                row = {"kind": kind, "nbytes": float(nbytes), "axes": axes,
                       "mesh_shape": mesh_shape, "t": t}
                if with_staging:
                    row["num_leaves"] = 7
                    row["t"] += true.staging_time(kind, nbytes, 7)
                rows.append(row)
    return rows


def _same_fit(got, want):
    for axis in ("data", "model", "pod"):
        g, w = got.link(axis), want.link(axis)
        assert g.bandwidth == pytest.approx(w.bandwidth, rel=FIT_RTOL)
        assert g.latency == pytest.approx(w.latency, rel=FIT_RTOL, abs=1e-18)


@pytest.mark.parametrize("staging", [False, True], ids=["wire", "staged"])
def test_fit_network_recovers_known_alpha_beta_as_the_reference(staging):
    true = _true_network()
    mesh_shape = {"data": 4, "model": 8}
    rows = _wire_rows(true, mesh_shape, with_staging=staging)
    model, info = calibrate.fit_network(rows, staging=true.staging)
    want, want_info = ref_calibrate.fit_network(rows, staging=ref_net(true).staging,
                                                ref=ref_net(T.default_network()))
    assert info["rms_residual_s"] < 1e-12 and info["quality"] == want_info["quality"] == "ok"
    for axis in ("data", "model"):
        assert model.link(axis).bandwidth == pytest.approx(true.link(axis).bandwidth,
                                                           rel=1e-6)
        assert model.link(axis).latency == pytest.approx(true.link(axis).latency, rel=1e-6)
    _same_fit(model, want)


def test_fit_network_quality_gate_and_refusal():
    true = _true_network()
    rows = _wire_rows(true, {"data": 4, "model": 8})
    noisy = [dict(r, t=r["t"] * (4.0 if i % 2 else 0.25)) for i, r in enumerate(rows)]
    _, bad = calibrate.fit_network(noisy)
    _, ref_bad = ref_calibrate.fit_network(noisy)
    assert bad["quality"] == ref_bad["quality"] == "poor"
    assert bad["rel_residual"] > calibrate.REL_RESIDUAL_MAX == ref_calibrate.REL_RESIDUAL_MAX
    with pytest.raises(ValueError):
        calibrate.fit_network([{"kind": "allreduce", "nbytes": 1e6, "axes": ("data",),
                                "mesh_shape": {"data": 1}, "t": 0.0}])


def test_fit_staging_recovers_known_params_as_the_reference():
    true = T.StagingModel(hbm_bw=5e11, leaf_overhead=1e-6)
    rows = [{"nbytes": float(n), "num_leaves": leaves, "fused": fused,
             "t": true.stage_time(n, leaves, fused=fused)}
            for n in (1 << 16, 1 << 20, 1 << 22) for leaves in (1, 16, 128)
            for fused in (True, False)]
    model, info = calibrate.fit_staging(rows)
    want, want_info = ref_calibrate.fit_staging(rows)
    assert model.hbm_bw == pytest.approx(true.hbm_bw, rel=1e-6)
    assert model.leaf_overhead == pytest.approx(true.leaf_overhead, rel=1e-6)
    assert info["rms_residual_s"] < 1e-12
    assert model.hbm_bw == pytest.approx(want.hbm_bw, rel=FIT_RTOL)
    assert model.leaf_overhead == pytest.approx(want.leaf_overhead, rel=FIT_RTOL)
    assert info["quality"] == want_info["quality"] == "ok"


def test_profiles_load_across_the_packages(tmp_path):
    true = _true_network()
    mesh_shape = {"data": 2, "model": 4}
    path = calibrate.save_profile(true, mesh_shape, dir=str(tmp_path / "port"),
                                  info={"n_rows": 3})
    assert path == calibrate.profile_path(mesh_shape, str(tmp_path / "port"))
    assert os.path.basename(path) == os.path.basename(
        ref_calibrate.profile_path(mesh_shape, str(tmp_path)))
    ref_path = ref_calibrate.save_profile(ref_net(true), mesh_shape,
                                          dir=str(tmp_path / "ref"))
    for loaded in (calibrate.load_profile(path), calibrate.load_profile(ref_path)):
        assert loaded == calibrate.load_profile(path)
    assert ref_calibrate.load_profile(path) == ref_calibrate.load_profile(ref_path)
    assert ref_calibrate.load_profile(path) == ref_net(calibrate.load_profile(path))
    doc = json.load(open(path))
    assert doc["schema_version"] == SCHEMA_VERSION
    assert doc["meta"]["mesh_shape"] == mesh_shape and doc["fit"]["n_rows"] == 3
    assert "jax_version" not in doc["meta"] and doc["meta"]["torch_version"]
    got, got_path = calibrate.fitted_network(mesh_shape, str(tmp_path / "port"))
    assert (got, got_path) == (calibrate.load_profile(path), path)
    assert calibrate.fitted_network({"data": 16}, str(tmp_path / "port")) == (None, None)
    calibrate.save_profile(true, mesh_shape, dir=str(tmp_path / "poor"),
                           info={"quality": "poor"})
    assert calibrate.fitted_network(mesh_shape, str(tmp_path / "poor")) == (None, None)
    bad = calibrate.profile_path(mesh_shape, str(tmp_path / "bad"))
    os.makedirs(os.path.dirname(bad))
    with open(bad, "w") as f:
        f.write("{not json")
    assert calibrate.fitted_network(mesh_shape, str(tmp_path / "bad")) == (None, None)
    assert calibrate.DEFAULT_PROFILE_DIR != ref_calibrate.DEFAULT_PROFILE_DIR
    assert calibrate.PROFILE_DIR_ENV != ref_calibrate.PROFILE_DIR_ENV
    meta = bench_metadata({"data": 2}, run="x")
    assert meta["run"] == "x" and meta["backend"] and "device_count" in meta


# ------------------------------------------------ the measured replay

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("measure")
    run_all(d, "measure", timeout=300)
    return [dict(np.load(d / f"measure_rank{r}.npz")) for r in range(WORLD)]


def jax_struct(shape):
    import jax

    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _ref_schedule(strategy: str, zero1: bool):
    """The reference's schedule of ``obs/cli.py::build_setup``'s stack on
    a stand-in mesh of the worker's shape."""
    mesh_shape = dict(zip(("data", "model"), MEASURE_MESH))
    specs, grads = {}, {}
    for i in range(4):
        for name, shape, spec in (("wi", (128, 512), P(None, "model")),
                                  ("wo", (512, 128), P("model", None)),
                                  ("scale", (128,), P())):
            grads[f"layer{i}.{name}"] = jax_struct(shape)
            specs[f"layer{i}.{name}"] = spec
    z = dict(exclude_axes=("data",), zero1_dp_axes=("data",), zero1_clip=True) if zero1 else {}
    mesh = StaticMesh(mesh_shape)
    gs = RefGradSync(RefGradSyncConfig(strategy=strategy, mean_axes=("data",),
                                       bucket_bytes=MEASURE_KIB << 10, **z),
                     mesh, specs, ref_localize(grads, specs, mesh))
    return gs.schedule, mesh_shape


@pytest.mark.parametrize("run", sorted(MEASURE_RUNS))
def test_replay_is_bit_equal_to_execute_and_times_every_op(ranks, run):
    strategy, zero1 = MEASURE_RUNS[run]
    want, mesh_shape = _ref_schedule(strategy, zero1)
    sim = R.simulate(want, mesh_shape)
    want_ops = sorted((e.op_id, e.kind, e.bucket_id) for e in sim.events)
    for r, out in enumerate(ranks):
        assert bool(out[f"{run}/reps1/bit_equal"]) and bool(out[f"{run}/reps3/bit_equal"]), r
        got_ops = [(int(i), str(k), int(b)) for (i, b), k in zip(out[f"{run}/events"],
                                                                 out[f"{run}/kinds"])]
        assert got_ops == want_ops
        assert [tuple(x) for x in out[f"{run}/schedule"]] == [
            (op.op_id, op.bucket.bucket_id, op.chain) for op in want.ops]
        assert (out[f"{run}/durations"] > 0).all()
    if zero1:
        assert {"norm", "update", "reduce_scatter", "all_gather"} <= {k for _, k, _ in want_ops}


def test_obs_cli_diff_and_trace_on_four_ranks(tmp_path):
    trace = tmp_path / "trace.json"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_NETPROFILE_DIR=str(tmp_path / "profiles"))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "4", "-m", "repro_torch.obs", "--diff", "--trace", str(trace),
         "--device", "cpu", "--model", "2", "--reps", "1"],
        capture_output=True, text=True, env=env, timeout=240, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "match" in out.stdout and "largest divergence" in out.stdout
    doc = json.loads(trace.read_text())
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"}
    assert names == {"measured:concom", "simulated:concom"}
    assert "jax" not in out.stdout + out.stderr
