"""The port's static verifier against the JAX package's: the six passes
give the reference's exact findings (pass, code, message, ops and the
witness's rendering) on all 24 mutations of its corpus, pass all 13 of
its valid cases clean, and the port's own corpus (all 24 mutations and
13 valid cases, the ZeRO-1 ones built by the port's ``zero1_schedule``,
the pipeline ones by its ``plan_pipeline`` and ``compose_step``),
planning hook and CLI agree with it.  Tolerance: exact — the passes are
pure functions of the IR.  ``_from_reference`` carries the reference's
schedules into the port's IR, torch dtypes and all; the pipeline
entries are run as the port builds them, each held equal to the
reference's first.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.analysis import cli as ref_cli
from repro.analysis import mutations as ref_mutations
from repro.analysis import run_passes as ref_run_passes
from repro_torch.analysis import (
    PASS_NAMES,
    ScheduleError,
    reducer_stages,
    run_passes,
    verify_schedule,
)
from repro_torch.analysis import cli
from repro_torch.analysis import mutations
from repro_torch.core import GradSync, GradSyncConfig, KVStore, plan_sync
from repro_torch.core import registry
from repro_torch.core.registry import StrategyInfo, get_strategy
from repro_torch.launch.mesh import init_dist, make_dp_mesh
from repro_torch.models import resnet
from test_torch_plan import _from_reference

REF_MUTATIONS = {m.name: m for m in ref_mutations.MUTATIONS}
REF_VALID = {name: (s, ctx) for name, s, ctx in ref_mutations.valid_cases()}
PORT_MUTATIONS = {m.name: m for m in mutations.MUTATIONS}
PORT_VALID = {name: (s, ctx) for name, s, ctx in mutations.valid_cases()}
# the entries the port's pipeline planner builds (core/pipeline_program.py)
PIPELINE = {"pp-unmatched-send", "pp-boundary-bytes", "pp-gpipe", "pp-1f1b",
            "pp-1f1b-zero1-joint"}


def _built(name: str, ref_s, ref_ctx) -> tuple:
    """The schedule and context the passes run on: a pipeline entry as the
    port's planner builds it (held equal to the reference's first), any
    other as the reference built it, carried into the port's IR."""
    if name not in PIPELINE:
        return _from_reference(ref_s), _ctx(ref_ctx)
    s, ctx = (PORT_MUTATIONS[name].build() if name in PORT_MUTATIONS
              else PORT_VALID[name])
    assert s == _from_reference(ref_s) and ctx == _ctx(ref_ctx), name
    return s, ctx


def _ctx(ctx: dict) -> dict:
    """A reference ``run_passes`` context with its dtype in torch's."""
    out = dict(ctx)
    if out.get("plan_comm_dtype") is not None:
        out["plan_comm_dtype"] = getattr(torch, np.dtype(out["plan_comm_dtype"]).name)
    return out


def _findings(report) -> list:
    return [(f.pass_name, f.code, f.message, f.ops,
             f.witness.render() if f.witness is not None else None)
            for f in report.findings]


def test_corpus_sizes():
    assert len(ref_mutations.MUTATIONS) == 24 and len(REF_VALID) == 13
    assert len(mutations.MUTATIONS) == 24 and len(mutations.valid_cases()) == 13
    assert set(PORT_MUTATIONS) == set(REF_MUTATIONS) and set(PORT_VALID) == set(REF_VALID)
    assert PIPELINE <= set(PORT_MUTATIONS) | set(PORT_VALID)
    assert PASS_NAMES == ("deadlock", "spmd", "carry", "accounting", "donation",
                          "reshard")


@pytest.mark.parametrize("name", sorted(REF_VALID))
def test_reference_valid_cases_pass_clean(name):
    s, ctx = _built(name, *REF_VALID[name])
    report = run_passes(s, **ctx)
    assert report.ok, report.render()
    verify_schedule(s, **ctx)


@pytest.mark.parametrize("name", sorted(REF_MUTATIONS))
def test_reference_mutations_get_the_reference_findings(name):
    m = REF_MUTATIONS[name]
    ref_s, ref_ctx = m.build()
    want = ref_run_passes(ref_s, **ref_ctx)
    s, ctx = _built(name, ref_s, ref_ctx)
    got = run_passes(s, **ctx)
    assert (m.owner, m.code) in {(f.pass_name, f.code) for f in got.findings}
    assert _findings(got) == _findings(want)
    assert got.error_classes == want.error_classes
    assert got.to_dict() == want.to_dict()
    with pytest.raises(ScheduleError) as e:
        verify_schedule(s, **ctx)
    assert str(e.value) == "\n".join(f.render() for f in want.findings)


@pytest.mark.parametrize("m", mutations.MUTATIONS, ids=lambda m: m.name)
def test_port_corpus_matches_the_reference_corpus(m):
    ref = REF_MUTATIONS[m.name]
    assert (m.owner, m.code, m.description) == (ref.owner, ref.code, ref.description)
    s, ctx = m.build()
    ref_s, ref_ctx = ref.build()
    assert s == _from_reference(ref_s)
    assert _findings(run_passes(s, **ctx)) == _findings(ref_run_passes(ref_s, **ref_ctx))


def test_port_valid_cases_match_the_reference():
    for name, s, ctx in mutations.valid_cases():
        ref_s, ref_ctx = REF_VALID[name]
        assert s == _from_reference(ref_s), name
        assert ctx == _ctx(ref_ctx), name
        assert run_passes(s, **ctx).ok, name


def test_dtype_checks_read_torch_dtypes():
    """An int8 wire under a compressed reducer is a finding on every op;
    f32 and bf16 wires are not (the corpus's compressed-int-wire,
    ag-dtype-mismatch and update-bucket-not-f32 hold the rest)."""
    plan = mutations.synthetic_plan(pin=torch.int8)
    s = get_strategy("concom").plan(plan)
    tagged = type(s)(tuple(dataclasses.replace(op, reducer="compressed")
                           for op in s.ops))
    codes = [f.code for f in run_passes(tagged).findings]
    assert codes.count("comm-dtype-illegal") == len(s.ops)
    for dt in (torch.float32, torch.bfloat16):
        s = get_strategy("concom").plan(mutations.synthetic_plan(pin=dt))
        ok = type(s)(tuple(dataclasses.replace(op, reducer="compressed")
                           for op in s.ops))
        assert run_passes(ok, plan_comm_dtype=torch.float32).ok
    assert reducer_stages(tagged.ops[0]) == (("all_to_all", ("data",)),
                                             ("all_gather", ("data",)))


def _dropped_edge(plan, *, skip_names=frozenset()):
    """funnel with its third op's chain edge dropped: two allreduces race
    on one communicator (the corpus's dropped-chain-edge)."""
    s = get_strategy("funnel").plan(plan, skip_names=skip_names)
    return type(s)(tuple(dataclasses.replace(op, depends_on=())
                         if op.op_id == 2 else op for op in s.ops))


@pytest.fixture
def bad_strategy(monkeypatch):
    monkeypatch.setitem(registry._STRATEGIES, "dropped-edge", StrategyInfo(
        "dropped-edge", _dropped_edge, single_chain=True))
    return "dropped-edge"


def _smoke_tree():
    from repro_torch.configs.resnet50_cifar import make_smoke

    params = resnet.init_params(make_smoke(), device="meta")
    return params, resnet.param_specs(params)


@pytest.fixture(scope="module")
def group():
    init_dist("cpu")
    return make_dp_mesh()


def test_gradsync_refuses_a_bad_schedule_before_any_communicator(bad_strategy,
                                                                 monkeypatch):
    """The passes run while planning: no process group is touched."""
    import torch.distributed as dist

    def no_group(*_a, **_kw):
        raise AssertionError("planning touched torch.distributed")

    monkeypatch.setattr(dist, "get_world_size", no_group)
    monkeypatch.setattr(dist, "new_group", no_group)
    params, specs = _smoke_tree()
    mesh = cli.static_mesh({"data": 4, "model": 1})
    with pytest.raises(ScheduleError) as e:
        GradSync(GradSyncConfig(strategy=bad_strategy, bucket_bytes=0), mesh,
                 specs, params, device="cpu")
    assert e.value.code == "concurrent-collectives" and e.value.pass_name == "spmd"
    assert "unordered collectives" in str(e.value)
    # verify=False skips the passes: the bad schedule is planned as is
    planned = plan_sync(GradSyncConfig(strategy=bad_strategy, bucket_bytes=0,
                                       verify=False), mesh, specs, params)
    assert not run_passes(planned.schedule, mesh_shape=planned.mesh_shape).ok


def test_gradsync_without_verify_builds_its_communicators(bad_strategy, group):
    params, specs = _smoke_tree()
    gs = GradSync(GradSyncConfig(strategy=bad_strategy, bucket_bytes=0,
                                 verify=False), group, specs, params, device="cpu")
    assert gs.schedule.ops[2].depends_on == ()
    gs.close()
    good = GradSync(GradSyncConfig(strategy="depcha"), group, specs, params,
                    device="cpu")
    assert run_passes(good.schedule, mesh_shape=good.mesh_shape).ok


def test_kvstore_schedule_runs_the_passes(group):
    kv = KVStore("funnel", reduce_axes=("data",), mesh_shape={"data": 1},
                 device="cpu")
    for key in range(3):
        kv.push(key, torch.full((5,), float(key)))
    for key in range(3):
        assert torch.equal(kv.pull(key), torch.full((5,), float(key)))
    assert len(kv.schedule().ops) == 3
    kv._ops[2] = dataclasses.replace(kv._ops[2], depends_on=())
    with pytest.raises(ScheduleError) as e:
        kv.schedule()
    assert e.value.code == "concurrent-collectives"
    assert kv.schedule(verify=False).ops[2].depends_on == ()
    kv._ops[2] = dataclasses.replace(kv._ops[2], depends_on=(7,))
    with pytest.raises(ValueError, match="dangling"):
        kv.schedule()
    kv.schedule(verify=False)


def test_cli_matches_the_reference_on_every_cell_both_plan(tmp_path, capsys):
    assert ref_cli.main(["--json", str(tmp_path / "ref.json")]) == 0
    assert cli.main(["--json", str(tmp_path / "port.json")]) == 0
    out = capsys.readouterr().out
    ref = json.loads((tmp_path / "ref.json").read_text())["cells"]
    port = json.loads((tmp_path / "port.json").read_text())
    key = ("mesh", "strategy", "reducer", "channels", "zero1", "accum")
    ref_by = {tuple(c[k] for k in key): c for c in ref}
    cells = port["cells"]
    assert [tuple(c[k] for k in key) for c in cells] == list(ref_by)
    both = 0
    for c in cells:
        r = ref_by[tuple(c[k] for k in key)]
        assert c["status"] == r["status"], c
        if c["status"] == "rejected":
            assert c["reason"] == r["reason"]
            continue
        both += 1
        assert (c["ok"], c["num_ops"], c["findings"]) == (
            r["ok"], r["num_ops"], r["findings"]), c
    s = port["summary"]
    assert both == s["planned"] == s["clean"] == 768
    assert (s["total"], s["rejected"], s["not_ported"], s["not_ported_by_item"]) == (
        864, 96, 0, {})
    assert sum(c["strategy"] == "auto" and c["status"] == "ok" for c in cells) == 144
    assert "768 planned (768 clean, 0 with findings)" in out


def test_cli_module_entry_points(tmp_path):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    for mod in ("repro_torch.analyze", "repro_torch.analysis"):
        res = subprocess.run([sys.executable, "-m", mod], capture_output=True,
                             text=True, timeout=120, env=env, cwd=tmp_path)
        assert res.returncode == 0, res.stderr[-2000:]
        assert "864 cells" in res.stdout
    assert list(tmp_path.iterdir()) == []      # no report unless --json
