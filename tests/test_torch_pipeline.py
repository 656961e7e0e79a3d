"""The port's pipeline stages (``parallel/pipeline.py``, the transformer's
``pipeline_train_forward``, ``make_train_step(pp_stages=...)``) against
the JAX package's, and against its own stage = 1 twin.

One spawn: worker mode ``pp`` of ``tests/_torch_mdworker.py`` on 4 gloo
ranks beside the reference on 4 fake devices, on the reference's check
14 (``tests/_mdworker.py``): ``mk_pp`` (2 layers, d 64, 8/2 heads, ff
128, vocab 96, f32), concom with 4 KiB buckets, AdamW 1e-3, 2 steps,
``TokenPipeline(96, 32, 8, seed=5)``, at data 1 × stage 2 × model 2 and
data 2 × stage 2 × model 1.

- gpipe and 1f1b at M 4: each rank's losses (rtol 1e-5) and param
  shards against the reference's at the same mesh; granite-moe's smoke
  config (the MoE aux in the carry) at data 1 × stage 2 × model 2
  likewise.  Params:
  within 2e-5 of each leaf's largest, but for at most 2 elements a leaf,
  within 1e-4 (the allowance of ``test_torch_elastic.py``, with a bound
  measured here): AdamW's g / (sqrt(v) + eps) turns last-bit gradient
  differences into a larger step where g is near 0.  The port's plain
  accumulation path, which this slice does not touch, shows the same
  outliers against the reference's plain path at these inputs (6.6e-5
  of ``embed``'s largest in one element, 2.6e-5 of ``blocks/wu``'s), and
  is held here by the same rule.
- Within the port, bit for bit: staged gpipe ≡ its stage = 1 twin (the
  same mesh with a stage extent of 1, on the first data × model ranks;
  the others stay outside it), and 1f1b at M = S ≡ gpipe at stage 1.
- 1f1b at M 4 (two chunks, their sums re-associated) against its stage
  = 1 run within 1e-5; the clipped gpipe (clip 0.05) against the
  reference's stage-1 clipped step at model 1, loss and grad norm within
  rtol 1e-5 (not against its staged one: the reference's
  ``pp-clip-gnorm-bitexact`` fails; nor at tp > 1, where it clips each
  model rank by its own shards: ROADMAP queue 3); staged S = 1 against
  the plain accumulation path within 1e-4.
- The staged step's GradSync schedule equals the reference's op for op;
  the hops a step are the waves' (M + S − 2 each way); every step's
  communicators are destroyed by ``TrainStep.close``.
- A staged run recovered from its checkpoint (failed at step 3) ends
  bit-equal to the same run uninterrupted.
- ``pipeline_forward`` over 4 stages at M 6, both broadcasts, and
  ``bubble_fraction``; every refusal of a staged step (in process).
"""
import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as ref_tf
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.core import GradSyncConfig, plan_sync
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw, zero1
from repro_torch.parallel.pipeline import bubble_fraction
from repro_torch.parallel.sharding import Mesh, localize_structs, stage_shard_specs
from repro_torch.runtime import make_train_step
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names

from _torch_mdworker import (
    PP_FORWARD,
    PP_MESHES,
    PP_MOE_MESHES,
    PP_RUNS,
    PP_STEPS,
    PP_SYNC,
    WORLD,
    pp_config,
    run_all,
)
from test_torch_plan import _from_reference

LOSS_RTOL = 1e-5
PARAM_TOL, PARAM_FEW, PARAM_MAX = 2e-5, 2, 1e-4     # of each leaf's largest
CLOSE = {"1f1b": 1e-5, "plain": 1e-4}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp")
    for name, arch in (("pp", None), ("pp-granite", "granite")):
        params = ref_tf.init_params(jax.random.PRNGKey(2),
                                    pp_config(PP_MOE_MESHES[0], arch, ref=True))
        np.savez(d / f"{name}_params.npz",
                 **{n: np.asarray(p) for n, p in ref_flatten(params)[0]})
    run_all(d, "pp", reference_too=True, timeout=600)
    return d


@pytest.fixture(scope="module")
def ranks(workdir):
    return [dict(np.load(workdir / f"pp_rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def ref(workdir):
    return dict(np.load(workdir / "pp_jax.npz"))


def _mesh(name, stage):
    data, _, model = PP_MESHES[name]
    return make_smoke_mesh(data, model, stage)


def _params(out, key):
    pre = f"{key}/param/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _twin_rank(name, r):
    """The stage = 1 twin's rank holding rank ``r``'s data and model shards."""
    c = _mesh(name, 2).coords(r)
    return _mesh(name, 1).rank_of({**c, "stage": 0})


def _twin_slice(name, r, n, v):
    """Rank ``r``'s stage slice of the twin's leaf ``v``."""
    if not n.startswith("blocks/"):
        return v
    s = _mesh(name, 2).coords(r)["stage"]
    per = v.shape[0] // PP_MESHES[name][1]
    return v[s * per:(s + 1) * per]


def _close_to(got: dict, want: dict, what: str) -> None:
    """Each leaf within ``PARAM_TOL`` of its largest, but for at most
    ``PARAM_FEW`` elements, within ``PARAM_MAX``."""
    assert set(got) == set(want), what
    for n, g in got.items():
        w = want[n]
        err = np.abs(g - w) / max(float(np.abs(w).max()), 1e-30)
        assert int((err > PARAM_TOL).sum()) <= PARAM_FEW, f"{what} {n}: {np.sort(err)[-4:]}"
        assert float(err.max()) <= PARAM_MAX, f"{what} {n}: {float(err.max()):.3g}"


def _ref_shards(ref, key, name, r, arch=None, stage=2):
    cfg = pp_config(name, arch)
    glob = _params(ref, key)
    tree = params_from_numpy(glob, "cpu", mesh=_mesh(name, stage), rank=r,
                             rules=tf.param_rules(cfg))
    return {n: p.numpy() for n, p in flatten_with_names(tree)[0]}


@pytest.mark.parametrize("name,run,arch", [(n, "gpipe", None) for n in sorted(PP_MESHES)]
                         + [(n, "1f1b", None) for n in sorted(PP_MESHES)]
                         + [(n, "granite", "granite") for n in PP_MOE_MESHES]
                         + [(n, "plain", None) for n in sorted(PP_MESHES)])
def test_staged_step_matches_reference(ranks, ref, name, run, arch):
    """The staged gpipe (and granite's), the staged 1f1b at M 4 (two
    chunks, each through its own backward, their gradients summed), and
    the plain accumulation path they are held beside, against the
    reference's same run."""
    key = f"{name}/{run}"
    stage = 0 if run == "plain" else 2
    for r, out in enumerate(ranks[:_mesh(name, stage).size]):
        for k in range(PP_STEPS):
            np.testing.assert_allclose(out[f"{key}/loss/{k}"], ref[f"{key}/loss/{k}"],
                                       rtol=LOSS_RTOL, err_msg=f"{key} rank {r} step {k}")
        _close_to(_params(out, key),
                  _ref_shards(ref, key, name, r, arch, stage),
                  f"{key} rank {r}")


@pytest.mark.parametrize("name", sorted(PP_MESHES))
@pytest.mark.parametrize("staged,twin", [("gpipe", "gpipe-s1"), ("1f1b-m2", "gpipe-s1-m2")])
def test_staged_step_is_bit_identical_to_its_stage1_twin(ranks, name, staged, twin):
    for r, out in enumerate(ranks):
        t = ranks[_twin_rank(name, r)]
        for k in range(PP_STEPS):
            assert out[f"{name}/{staged}/loss/{k}"] == t[f"{name}/{twin}/loss/{k}"]
        want = _params(t, f"{name}/{twin}")
        for n, v in _params(out, f"{name}/{staged}").items():
            np.testing.assert_array_equal(v, _twin_slice(name, r, n, want[n]),
                                          err_msg=f"{name} {staged} rank {r} {n}")


@pytest.mark.parametrize("name", sorted(PP_MESHES))
@pytest.mark.parametrize("run,against", [("1f1b", "1f1b-s1"), ("plain", "gpipe-s1")])
def test_staged_step_is_close_to_its_reassociations(ranks, name, run, against):
    """1f1b at M 4 (two chunks) against its stage-1 run; the plain
    accumulation path (no stage axis) against the staged S = 1 step."""
    tol = CLOSE[run.split("-")[0]]
    for r, out in enumerate(ranks):
        if run == "plain" and r >= len(_mesh(name, 1).world_ranks):
            continue
        t = ranks[r if run == "plain" else _twin_rank(name, r)]
        want = _params(t, f"{name}/{against}")
        got = _params(out, f"{name}/{run}")
        for n, v in got.items():
            w = want[n] if run == "plain" else _twin_slice(name, r, n, want[n])
            assert float(np.abs(v - w).max()) < tol, f"{name} {run} rank {r} {n}"


@pytest.mark.parametrize("name", sorted(PP_MESHES))
def test_clipped_step_matches_reference_stage1(ranks, ref, name):
    """The staged clipped gpipe against the reference's stage-1 clipped
    step at model 1 (its staged clip's norm fails its own bit-exact
    check, and at tp > 1 it clips each model rank by its own shards:
    ROADMAP queue 3).  Loss and grad norm within rtol 1e-5; params by
    the AdamW rule of ``_close_to``."""
    key = f"{name}/clip-s1"
    for r, out in enumerate(ranks):
        for k in range(PP_STEPS):
            for what in ("loss", "gnorm"):
                np.testing.assert_allclose(out[f"{name}/clip/{what}/{k}"],
                                           ref[f"{key}/{what}/{k}"], rtol=LOSS_RTOL,
                                           err_msg=f"{name} clip {what} rank {r} step {k}")
        _close_to(_params(out, f"{name}/clip"), _ref_shards(ref, key, name, r),
                  f"{name} clip rank {r}")


@pytest.mark.parametrize("name", sorted(PP_MESHES))
def test_gradsync_schedule_matches_reference(workdir, name):
    """The staged step's post-backward schedule (its buckets: the block
    slices over the dp axes and "model", the stage-replicated leaves
    over "stage" too), planned by the port from rank 0's shard shapes,
    equals the reference's op for op."""
    with open(workdir / f"pp-{name}_schedule.pkl", "rb") as f:
        want = _from_reference(pickle.load(f))
    mesh = _mesh(name, 2)
    cfg = pp_config(name)
    like = tf.init_params(cfg, device="meta")
    specs = stage_shard_specs(tf.param_specs(like, cfg))
    got = plan_sync(GradSyncConfig(**PP_SYNC), mesh, specs,
                    localize_structs(like, specs, mesh)).schedule
    assert got == want


@pytest.mark.parametrize("name", sorted(PP_MESHES))
def test_hops_and_communicators(ranks, name):
    """A staged step hops once a wave boundary each way: M + S − 2 forward
    and as many backward (1f1b: a chunk of S at a time); a stage-1 twin
    hops none.  Every step's communicators were destroyed by its close,
    and its pipeline context reached GradSyncConfig."""
    S = PP_MESHES[name][1]
    for out in ranks:
        for run, (s, sched, mb, _, arch) in PP_RUNS.items():
            if s != 2 or (arch and name not in PP_MOE_MESHES):
                continue
            chunk = mb if sched == "gpipe" else S
            want = (mb // chunk) * 2 * (chunk + S - 2)
            assert [int(out[f"{name}/{run}/hops/{k}"]) for k in range(PP_STEPS)] == \
                [want] * PP_STEPS, (name, run)
        if f"{name}/gpipe-s1/hops/0" in out:                 # a rank of the twin
            assert int(out[f"{name}/gpipe-s1/hops/0"]) == 0
        rows = 8 // PP_MESHES[name][0]
        assert out[f"{name}/gpipe/pp_context"].tolist() == [S, 4, rows // 4 * 32 * 64 * 4]
        assert int(out["groups_after"]) == int(out["groups_before"]) == 1


def test_staged_run_recovers_from_its_checkpoint(ranks):
    """A staged run checkpointed every 2 steps and failed at step 3
    restores step 2's checkpoint (each rank its stage slice and shards)
    and ends bit-equal to the same run uninterrupted."""
    for out in ranks:
        assert out["ckpt/recovered/events"].tolist() == ["compile", "failure", "recover"]
        assert bool(out["ckpt/same"])


def test_pipeline_forward_both_broadcasts(ranks):
    S, M, D = PP_FORWARD
    mbs = np.arange(M * D, dtype=np.float32).reshape(M, D) + 1.0
    expect = mbs * float(np.prod(np.arange(1, S + 1)))
    for out in ranks:
        np.testing.assert_array_equal(out["forward/psum"], expect)
        hop = expect if int(out["forward/stage"]) == 0 else np.zeros_like(expect)
        np.testing.assert_array_equal(out["forward/hop"], hop)
    assert abs(bubble_fraction(4, 6) - 3 / 9) < 1e-12
    assert bubble_fraction(1, 5) == 0.0 and bubble_fraction(2, 4) == 0.2


def _refusal(**kw):
    cfg = kw.pop("cfg", tf.TransformerConfig(name="t", n_layers=2, d_model=16, n_heads=2, kv_heads=1,
                                             d_ff=32, vocab=32, dtype=torch.float32))
    mesh = kw.pop("mesh", make_smoke_mesh(1, 1, 2))
    opt = kw.pop("opt", adamw(1e-3))
    model = tf.Transformer(cfg, tf.init_params(cfg, device="cpu"))
    args = dict(pp_stages=2, pp_schedule="gpipe", clip_norm=0.0, microbatch=4)
    args.update(kw)
    return make_train_step(cfg, mesh, GradSyncConfig(), opt, model=model, device="cpu", **args)


@pytest.mark.parametrize("case,exc,match", [
    ("no-stage-axis", ValueError, "needs a 'stage' mesh axis"),
    ("extent", ValueError, "!= mesh 'stage' extent"),
    ("family", ValueError, "has no pipeline_train_forward"),
    ("depcha-in-scan", ValueError, "depcha_in_scan"),
    ("layers", ValueError, "not divisible by pp_stages"),
    ("zero1-clip", ValueError, "scheduled ZeRO-1 clipping"),
    ("auto", None, None),
    ("schedule", ValueError, "pp_schedule must be"),
])
def test_staged_step_refusals(case, exc, match):
    """The reference's refusals of a staged step.  "auto" is none: it
    resolves to the reference's ``choose_pp_schedule`` pick on the same
    model values (``_auto_resolves``)."""
    base = tf.TransformerConfig(name="t", n_layers=2, d_model=16, n_heads=2, kv_heads=1, d_ff=32,
                                vocab=32, dtype=torch.float32)
    kw = {
        "no-stage-axis": dict(mesh=make_smoke_mesh(2, 1)),
        "extent": dict(pp_stages=4),
        "depcha-in-scan": dict(cfg=dataclasses.replace(base, depcha_in_scan=True)),
        "layers": dict(cfg=dataclasses.replace(base, n_layers=3)),
        "zero1-clip": dict(opt=zero1(adamw(1e-3), ("data",), 1), zero1_mode=True,
                           clip_norm=1.0),
        "schedule": dict(pp_schedule="interleaved"),
    }.get(case, {})
    if case == "auto":
        _auto_resolves()
        return
    if case == "family":
        from repro_torch.configs import get_arch
        from repro_torch.models import rwkv

        cfg = get_arch("rwkv6-7b").make_smoke()
        model = rwkv.RWKV(cfg, rwkv.init_params(cfg, device="cpu"))
        with pytest.raises(exc, match=match):
            make_train_step(cfg, make_smoke_mesh(1, 1, 2), GradSyncConfig(), adamw(1e-3),
                            model=model, pp_stages=2, pp_schedule="gpipe", device="cpu")
        return
    with pytest.raises(exc, match=match):
        _refusal(**kw)


def _auto_resolves():
    """``pp_schedule="auto"`` at stage 2 picks what the reference's
    ``choose_pp_schedule`` picks from the same compute model, payload and
    network values, over batches whose hops weigh from nothing to more
    than the compute; and a one-rank staged run (stage extent 1) under
    "auto" is bit-equal to the same run under its pick."""
    from repro.sim import choose_pp_schedule as ref_choose
    from repro_torch.launch.mesh import init_dist
    from repro_torch.runtime.train_loop import (
        _micro_compute,
        pp_activation_bytes,
        resolve_pp_schedule,
    )
    from repro_torch.sim import default_network

    from test_torch_sim import ref_cm, ref_net

    base = tf.TransformerConfig(name="t", n_layers=2, d_model=16, n_heads=2, kv_heads=1, d_ff=32,
                                vocab=32, dtype=torch.float32)
    picks = set()
    for data, rows, seq, d_model in ((1, 8, 16, 16), (2, 4, 64, 4096), (1, 32, 1024, 8192)):
        cfg = dataclasses.replace(base, d_model=d_model)
        mesh = make_smoke_mesh(data, 1, 2)
        batch = {"tokens": torch.zeros((rows, seq), dtype=torch.int64),
                 "labels": torch.zeros((rows, seq), dtype=torch.int64),
                 "global_tokens": torch.tensor(float(rows * data * seq))}
        got = resolve_pp_schedule(cfg, mesh, 2, "auto", 4, batch)
        assert got == ref_choose(2, 4, activation_bytes=pp_activation_bytes(cfg, batch, 4),
                                 compute=ref_cm(_micro_compute(cfg, batch, mesh, 1)),
                                 mesh_shape=dict(mesh.shape), net=ref_net(default_network()))
        picks.add(got)
    assert picks <= {"gpipe", "1f1b"}

    init_dist("cpu")
    mesh = make_smoke_mesh(1, 1, 1)
    batch = {"tokens": torch.randint(0, 32, (8, 16), generator=torch.Generator().manual_seed(0)),
             "global_tokens": torch.tensor(128.0)}
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    runs = {}
    pick = resolve_pp_schedule(base, mesh, 1, "auto", 4, batch)
    for sched in ("auto", pick):
        model = tf.Transformer(base, tf.init_params(base, seed=0, device="cpu"))
        opt = adamw(1e-3)
        ts = make_train_step(base, mesh, GradSyncConfig(**PP_SYNC), opt, model=model,
                             pp_stages=1, pp_schedule=sched, microbatch=4, clip_norm=0.0,
                             batch_like=batch, device="cpu")
        state = ts.init_opt()
        losses = []
        for step in range(2):
            model, state, m = ts.fn(model, state, batch, step)
            losses.append(float(m["loss"]))
        ts.close()
        runs[sched] = (losses, [p.detach().clone() for p in model.parameters()])
    assert runs["auto"][0] == runs[pick][0]
    for a, b in zip(runs["auto"][1], runs[pick][1]):
        assert torch.equal(a, b)


def test_cross_attention_is_refused():
    from repro_torch.configs import get_arch

    cfg = get_arch("llama-3.2-vision-11b").make_smoke()
    params = tf.init_params(cfg, device="cpu")
    mbs = {"tokens": torch.zeros((2, 1, 4), dtype=torch.int64),
           "labels": torch.zeros((2, 1, 4), dtype=torch.int64),
           "global_tokens": torch.full((2,), 4.0)}
    with pytest.raises(ValueError, match="cross-attention"):
        tf.pipeline_train_forward(params, mbs, cfg)


def test_stage_mesh_and_specs():
    """``make_smoke_mesh(data, model, stage)`` puts "stage" between "data"
    and "model", ranks row-major; a replica's stages and model ranks read
    one dp slice; the overlay shards dim 0 of the blocks only."""
    from repro_torch.parallel.sharding import batch_spec, dp_axes_of, dp_index

    mesh = make_smoke_mesh(2, 2, 3)
    assert mesh.axis_names == ("data", "stage", "model") and mesh.size == 12
    assert mesh.coords(7) == {"data": 1, "stage": 0, "model": 1}
    assert [dp_index(r, mesh) for r in range(12)] == [0] * 6 + [1] * 6
    assert dp_axes_of(mesh) == ("data",) and batch_spec(mesh) == ("data",)
    assert make_smoke_mesh(2, 2).axis_names == ("data", "model")
    specs = stage_shard_specs({"embed": ("model", None), "blocks": {"wq": (None, None, "model"),
                                                                     "ln1": ()}})
    assert specs == {"embed": ("model", None),
                     "blocks": {"wq": ("stage", None, "model"), "ln1": ("stage",)}}
    with pytest.raises(ValueError, match="already shards"):
        stage_shard_specs({"blocks": {"w": ("model",)}})
    twin = Mesh(("data", "stage", "model"), {"data": 1, "stage": 1, "model": 2}, (0, 1))
    assert twin.world_ranks == (0, 1) and twin.rank_in(3) is None
