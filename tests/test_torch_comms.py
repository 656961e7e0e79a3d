"""The training communicators' life: ``TrainStep.close`` destroys every
process group ``make_train_step`` created, and the training launcher's
pipeline, events and metrics flags.

One spawn of 4 gloo ranks (worker mode ``close`` of
``tests/_torch_mdworker.py``): three build–step–close cycles each of
concom on 4 channels (data 4), depcha with its in-backward ``LayerSync``
at data 2 × model 2, and FSDP at data 2 × model 2.  After every cycle the
live process groups (c10d's group map, ``dependency.live_groups``) are
back to their count before the first, the default group alone; a step
held more while it lived.  A regrouped ``KVStore`` and a ``GradSync``
close alike.

The launcher (``repro_torch.launch.train``) on 2 gloo ranks with
``--pp-stages 2 --pp-schedule gpipe --smoke --device cpu``: it trains,
and ``--events-jsonl`` and ``--metrics-json`` write the reference
``Trainer``'s event kinds, step-row fields and metric names (the
reference's, from its own ``Trainer`` on a one-device LM run here, the
simulator's gauges included).  ``--pp-stages 2``
without ``--smoke`` exits as the reference's launcher does.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from _torch_mdworker import CLOSE_CYCLES, CLOSE_RUNS, WORLD, run_all

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
LAUNCH = ["-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b", "--smoke",
          "--device", "cpu", "--pp-stages", "2", "--pp-schedule", "gpipe",
          "--microbatch", "4", "--strategy", "concom", "--steps", "3", "--seq", "16",
          "--batch", "4"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("close")
    run_all(d, "close", timeout=300)
    return [dict(np.load(d / f"close_rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("run", sorted(CLOSE_RUNS))
def test_closed_steps_leave_no_process_group(ranks, run):
    for out in ranks:
        before = int(out["before"])
        assert before == 1                       # the default group
        for c in range(CLOSE_CYCLES):
            assert int(out[f"{run}/held/{c}"]) > before, (run, c)
            assert int(out[f"{run}/after/{c}"]) == before, (run, c)
            assert np.isfinite(out[f"{run}/loss/{c}"])
        assert int(out["end"]) == before


def _env(rank: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), PYTHONPATH=SRC)
    return env


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = LAUNCH + ["--events-jsonl", str(d / "events.jsonl"),
                     "--metrics-json", str(d / "metrics.json")]
    procs = [subprocess.Popen([sys.executable, *args], env=_env(r, port),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    rows = [json.loads(line) for line in (d / "events.jsonl").read_text().splitlines()]
    return outs[0], rows, json.loads((d / "metrics.json").read_text())


@pytest.fixture(scope="module")
def reference_names(tmp_path_factory):
    """The reference ``Trainer``'s event rows and metric names on a
    one-device LM run (``mk_dense``, 3 steps)."""
    import jax

    from repro.core import GradSyncConfig
    from repro.data import TokenPipeline
    from repro.launch.mesh import make_smoke_mesh
    from repro.models import transformer as ref_tf
    from repro.optim import adamw
    from repro.runtime import Trainer, make_train_step

    from _torch_mdworker import tp_config

    path = tmp_path_factory.mktemp("ref_events") / "events.jsonl"
    cfg = tp_config(1, ref=True)
    mesh = make_smoke_mesh(1, 1)
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg)
    pipe = TokenPipeline(96, 16, 4, mesh=mesh)
    opt = adamw(3e-4)
    ts = make_train_step(cfg, mesh, GradSyncConfig(strategy="concom"), opt,
                         batch_like=pipe.batch_at(0), params_like=params, clip_norm=1.0)
    _, _, hist = Trainer(ts, pipe, None, log_every=1000, printer=lambda _m: None,
                         events_path=str(path)).run(params, opt.init(params), 3)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return rows, set(hist["metrics"])


def test_launcher_trains_over_pipeline_stages(launched):
    out, rows, _ = launched
    assert "[train] qwen3-1.7b concom: loss" in out
    losses = [r["loss"] for r in rows if r["kind"] == "step"]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_launcher_events_and_metrics_are_the_references(launched, reference_names):
    _, rows, metrics = launched
    ref_rows, ref_metrics = reference_names
    assert [r["kind"] for r in rows] == [r["kind"] for r in ref_rows] == \
        ["compile"] + ["step"] * 3
    for got, want in zip(rows, ref_rows):
        assert set(got) == set(want), got["kind"]
    assert set(metrics) == ref_metrics
    assert {"sim.step_time_s", "sim.exposed_comm_s"} <= set(metrics)
    assert metrics["steps_total"] == 3
    assert metrics["loss"] == rows[-1]["loss"]


def test_launcher_refuses_stages_without_smoke():
    args = [a for a in LAUNCH if a != "--smoke"]
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = SRC
    p = subprocess.run([sys.executable, *args], env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 1
    assert "--pp-stages needs the smoke mesh (--smoke)" in p.stderr


def test_supervisor_close_closes_its_steps_in_build_order():
    """``Supervisor.close`` closes every step its builder gave it, once,
    in build order (every rank builds the rungs in one order)."""
    from repro_torch.elastic import Supervisor

    closed = []

    class Step:
        def __init__(self, key):
            self.key = key

        def close(self):
            closed.append(self.key)

    sup = Supervisor(lambda k: (Step(k), None, None), ("big", "small"), "unused",
                     group=object())
    sup._get("small")
    sup._get("big")
    sup._get("small")
    sup.close()
    assert closed == ["small", "big"]
    sup.close()
    assert closed == ["small", "big"]
