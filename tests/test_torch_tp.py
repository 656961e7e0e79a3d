"""Tensor parallelism (ROADMAP queue 1 item 9): the LM's training at data
× model on 4 gloo ranks, against the JAX package on 4 fake devices.

Two spawns run at once, one a mesh (``tests/_torch_mdworker.py``, modes
``tp-2x2`` and ``tp-1x4``): four port ranks and the reference's process.
The model is the reference's ``mk_dense`` (2 layers, d 64, 8/2 heads, ff
128, vocab 96, f32): on data 2 × model 2 its kv heads are sharded (2 ≥
tp), on data 1 × model 4 they are sliced from the replicated wk/wv (2 <
tp).  Held to the reference:

  - each rank's loss and reduced gradient shards, for every registered
    strategy with ``flat`` and for ``ring``, ``compressed`` and
    ``hierarchical``, against the reference's at the same mesh cut to the
    rank's blocks: rtol 1e-5 / atol 1e-6 (compressed: one quantization
    step of its largest gradient, 2/127, as the two round the int8 sum
    differently, ``tests/test_torch_compression.py``);
  - tp = 1 ≡ tp > 1 at ``tests/_mdworker.py::compare_tp``'s tolerances
    (loss 3e-4, gradients 2e-3 of each leaf's largest; compressed 5e-2 /
    0.35; ring 3e-4 / 5e-3), against the reference at tp = 1;
  - the hierarchical reducer on pod 2 × data 1 × model 2 (the pod stages
    at each model coordinate, then the psum over "model");
  - three AdamW steps through ``Trainer`` under depcha's in-backward sync
    at 2 × 2 (losses equal; params within 2e-5: Adam's g / (sqrt(v) +
    eps) magnifies last-bit gradient differences, ``test_torch_overlap``);
    replicated leaves bit-identical across the ranks of a model group;
  - the clipped SGD step (clip 0.05, binding) against the reference's
    tp = 1 step: the port clips by the global norm.  The reference at
    tp > 1 clips each model rank by its own shards' norm, so its
    replicated leaves come out different on different model ranks (the
    reference-fault test);
  - ZeRO-1 at 2 × 2: scheduled and monolithic against the reference's,
    and the scheduled NORM's clip against the tp = 1 step.

FSDP (ZeRO-3 storage, ``cfg.fsdp``) on data 2 × model 2 and on data 4 ×
model 1 (a third spawn, mode ``tp-4x1``), held to the reference:

  - each rank's loss and gradient shards against the reference's at the
    same mesh with FSDP, cut to the rank's blocks (rtol 1e-5 / atol
    1e-6), for every registered strategy with ``flat`` and for ``ring``
    at 2 × 2; no FSDP leaf in a GradSync bucket, and depcha's
    in-backward sync passes exactly the FSDP leaves through;
  - the reference's check 5 (``tests/_mdworker.py``): one concom AdamW
    step, unclipped, against the reference at dp 1 × tp 1 (loss 3e-4,
    params 5e-4);
  - the clipped SGD step against the reference's dp 1 × tp 1 step: the
    port clips by the global norm.  The reference under FSDP clips each
    data rank by its own shards' norm, so its leaves replicated over
    "data" come out different on different data ranks (the
    reference-fault test, at data 4 × model 1);
  - ZeRO-1 with FSDP refused, as in the reference.

The MoE FFN with its experts sharded over "model": granite-moe's smoke
config (8 experts; vocab 96 so that it splits) at 2 × 2 (concom, depcha,
and concom under FSDP) and 1 × 4, kimi-k2's (a shared expert) at 2 × 2:
loss and gradient shards against the reference at the same mesh (rtol
1e-5 / atol 1e-6), and tp > 1 ≡ tp = 1 at compare_tp's tolerances,
against the reference's tp = 1 run at the same dp (an expert's capacity
follows the rank's token count).

And unit checks: ``localize_structs``, ``batch_spec``, the rank ↔
coordinates map, the shard cut and the batch rows against the
reference's mesh and ``device_put``; the vocab-sharded embedding and
cross-entropy and the column/row-parallel matmuls with their gradients
on 4 gloo ranks (mode ``tp-ops``).
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_mdworker import (FSDP_GRADS, FSDP_MESHES, MESHES, MOE_ARCHS, MOE_RUNS,
                             SPLIT_REFERENCE, TP_GRADS, TP_MESHES, TP_POD_MESH, TP_STEPS, WORLD,
                             XR_RUNS, XR_STRATEGIES, family_lib, moe_config, run_all, run_tp_ops,
                             tp_config, xr_config)
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.models import common as ref_common
from repro.models import rwkv as ref_rwkv
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.parallel import sharding as ref_sharding
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.launch.mesh import make_pod_mesh, make_smoke_mesh
from repro_torch.models import rwkv, ssm
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names

RTOL, ATOL = 1e-5, 1e-6
# compare_tp's (loss, gradient) tolerances, tests/_mdworker.py
TP_TOL = {"compressed": (5e-2, 0.35), "ring": (3e-4, 5e-3)}
MESH_RUNS = [(m, run) for m in TP_MESHES for run in TP_GRADS.values()]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tp")
    params = ref_tf.init_params(jax.random.PRNGKey(1), tp_config(1, ref=True))
    np.savez(d / "tp_params.npz", **{n: np.asarray(v) for n, v in ref_flatten(params)[0]})
    for arch in MOE_ARCHS:
        mp = ref_tf.init_params(jax.random.PRNGKey(1), moe_config(arch, 1, ref=True))
        np.savez(d / f"moe-{arch}_params.npz",
                 **{n: np.asarray(v) for n, v in ref_flatten(mp)[0]})
    # the cross-attention, RWKV and Zamba2 weights: gate_attn nonzero, and
    # RWKV's and Zamba2's constant leaves perturbed as their tests perturb them
    vp = {n: np.asarray(v) for n, v in ref_flatten(ref_tf.init_params(
        jax.random.PRNGKey(1), xr_config("vision", 1, ref=True)))[0]}
    vp["cross_blocks/gate_attn"] = np.full_like(vp["cross_blocks/gate_attn"], 0.7)
    np.savez(d / "xr-vision_params.npz", **vp)
    for kind, ref_lib, lib in (("rwkv", ref_rwkv, rwkv), ("zamba2", ref_ssm, ssm),
                               ("zamba2-kv2", ref_ssm, ssm)):
        rp = params_from_numpy({n: np.asarray(v) for n, v in ref_flatten(ref_lib.init_params(
            jax.random.PRNGKey(1), xr_config(kind, 1, ref=True)))[0]})
        np.savez(d / f"xr-{kind}_params.npz", **{n: t.numpy() for n, t in flatten_with_names(
            lib.perturb_constant_leaves(rp, seed=1))[0]})
    (d / "ops").mkdir()
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        runs = [ex.submit(run_all, d, f"tp-{m}", timeout=400,
                          reference_too=(f"tp-{m}", f"tp-{m}+") if m in SPLIT_REFERENCE
                          else True) for m in MESHES]
        ops = ex.submit(run_tp_ops, d / "ops", WORLD)
        for f in runs:
            f.result()
        return d, ops.result()


def _load(d, mesh_name):
    got = [dict(np.load(d / f"tp-{mesh_name}_rank{r}.npz")) for r in range(WORLD)]
    want = dict(np.load(d / f"tp-{mesh_name}_jax.npz"))
    if mesh_name in SPLIT_REFERENCE:
        want.update(np.load(d / f"tp-{mesh_name}+_jax.npz"))
    return got, want


def _mesh(mesh_name):
    return make_smoke_mesh(*MESHES[mesh_name])


def _cut(full, name, mesh, rank, model, cfg=None):
    """Rank ``rank``'s block of a global reference array (under ``cfg``'s
    rules, by default ``tp_config(model)``'s)."""
    cfg = cfg or tp_config(model)
    spec = family_lib(cfg).param_rules(cfg).spec(name)
    return sharding.shard_leaf(torch.from_numpy(np.ascontiguousarray(full)), spec, mesh,
                               mesh.coords(rank)).numpy()


def _leaves(npz, prefix):
    return {k[len(prefix):]: v for k, v in npz.items() if k.startswith(prefix)}


# ----------------------------------------------------------- unit checks

def _spec(p):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in p)


class _StandIn:
    def __init__(self, names, shape):
        self.axis_names, self.shape = names, shape


@pytest.mark.parametrize("shape", [{"data": 2, "model": 4}, {"data": 1, "model": 2},
                                   {"pod": 2, "data": 2, "model": 2}])
def test_localize_structs_and_batch_spec_match_reference(shape):
    mesh = _StandIn(tuple(shape), shape)
    model = shape["model"]
    ref_cfg, cfg = tp_config(model, ref=True), tp_config(model)
    ref_params = jax.eval_shape(lambda: ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg))
    want = ref_sharding.localize_structs(ref_params, ref_tf.param_rules(ref_cfg)
                                         .tree_specs(ref_params), mesh)
    params = tf.init_params(cfg, device="meta")
    got = sharding.localize_structs(params, tf.param_specs(params, cfg), mesh)
    want_shapes = {n: tuple(s.shape) for n, s in ref_flatten(want)[0]}
    got_shapes = {n: tuple(t.shape) for n, t in flatten_with_names(got)[0]}
    assert got_shapes == want_shapes
    assert all(t.device.type == "meta" for _, t in flatten_with_names(got)[0])
    assert sharding.batch_spec(mesh) == _spec(ref_sharding.batch_spec(mesh))


@pytest.mark.parametrize("mesh_name", list(TP_MESHES) + ["pod"])
def test_rank_coordinates_shard_cut_and_batch_follow_the_reference_mesh(workdir, mesh_name):
    """Rank r is the reference mesh's r-th device in row-major order; the
    port's cut of the global params (``params_from_numpy`` with the mesh)
    is what ``device_put`` gives that device, and its batch rows are the
    device's (every rank of a model group reads its data index's)."""
    d, _ = workdir
    if mesh_name == "pod":
        got, want = _load(d, "2x2")
        mesh, tag = make_pod_mesh(*TP_POD_MESH), "pod/"
    else:
        got, want = _load(d, mesh_name)
        mesh, tag = _mesh(mesh_name), ""
    ids = want[f"{tag}device_ids"]
    for r in range(WORLD):
        c = mesh.coords(r)
        dev = int(ids[tuple(c[a] for a in mesh.axis_names)])
        assert mesh.rank_of(c) == r
        np.testing.assert_array_equal(got[r][f"{tag}batch"], want[f"{tag}batch/{dev}"])
        assert sharding.dp_index(r, mesh) == r // mesh.shape["model"]
        for n, block in _leaves(got[r], f"{tag}shard/").items():
            np.testing.assert_array_equal(block, want[f"{tag}shard/{n}/{dev}"], err_msg=n)
    assert sorted(int(i) for i in ids.ravel()) == list(range(WORLD))


def test_model_axis_ops_match_reference(workdir):
    """The vocab-sharded embedding and cross-entropy and the column- then
    row-parallel matmuls at tp = 4, against the reference at tp = 1: the
    outputs equal on every rank; each rank's gradient of its shard is
    tp × the shard of the reference's (psum's transpose is psum, as in
    the reference's shard_map), and the replicated input's gradients sum
    over the ranks to tp × the reference's."""
    from _torch_mdworker import tp_ops_inputs

    _, ranks = workdir
    inp = {k: jnp.asarray(v) for k, v in tp_ops_inputs().items()}
    mesh = ref_smoke_mesh(1, 1)

    def run(fn, *args):
        f = jax.shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args), out_specs=P(),
                          check_vma=False)
        return jax.jit(f)(*args)

    def embed(e):
        return ref_common.embed_lookup(e, inp["ids"], 1)

    def xent(x):
        return ref_common.sharded_softmax_xent(x, inp["labels"], 1)

    def mlp(x, w1, w2):
        return ref_common.row_parallel(jnp.tanh(ref_common.col_parallel(x, w1)), w2)

    want = {
        "embed": run(embed, inp["emb"]),
        "embed_grad": run(jax.grad(lambda e: jnp.sum(embed(e) * inp["emb_cot"])), inp["emb"]),
        "xent": run(xent, inp["logits"]),
        "xent_grad": run(jax.grad(lambda x: jnp.sum(xent(x))), inp["logits"]),
        "mlp": run(mlp, inp["x"], inp["w1"], inp["w2"]),
    }
    g = run(jax.grad(lambda x, a, b: jnp.sum(mlp(x, a, b) * inp["mlp_cot"]), argnums=(0, 1, 2)),
            inp["x"], inp["w1"], inp["w2"])
    want.update(mlp_x_grad=g[0], mlp_w1_grad=g[1], mlp_w2_grad=g[2])
    want = {k: np.asarray(v) for k, v in want.items()}
    tp = WORLD
    shard_dim = {"embed_grad": 0, "xent_grad": 2, "mlp_w1_grad": 1, "mlp_w2_grad": 0}
    for r, got in enumerate(ranks):
        for k in ("embed", "xent", "mlp"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
        for k, dim in shard_dim.items():
            n = want[k].shape[dim] // tp
            np.testing.assert_allclose(got[k] / tp, np.take(want[k], range(r * n, (r + 1) * n),
                                                            axis=dim),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{k} rank {r}")
    np.testing.assert_allclose(sum(g["mlp_x_grad"] for g in ranks) / tp, want["mlp_x_grad"],
                               rtol=RTOL, atol=ATOL)


# --------------------------------------------------- gradients and loss

def _quant_bound(want):
    return 2.0 / 127 * np.max(np.abs(want))


@pytest.mark.parametrize("mesh_name,run", MESH_RUNS)
def test_loss_and_gradient_shards_match_reference(workdir, mesh_name, run):
    d, _ = workdir
    got, want = _load(d, mesh_name)
    mesh, model = _mesh(mesh_name), TP_MESHES[mesh_name][1]
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][f"{run}/loss"], want[f"{run}/loss"], rtol=RTOL)
        grads = _leaves(got[r], f"{run}/grad/")
        assert set(grads) == set(_leaves(want, f"{run}/grad/"))
        for n, g in grads.items():
            w = _cut(want[f"{run}/grad/{n}"], n, mesh, r, model)
            if run == "compressed":
                assert np.max(np.abs(g - w)) <= _quant_bound(want[f"{run}/grad/{n}"]), n
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{n} rank {r}")


@pytest.mark.parametrize("mesh_name,run", MESH_RUNS)
def test_tp_equals_tp1(workdir, mesh_name, run):
    """compare_tp: the loss within 3e-4 of the reference's tp = 1 loss,
    every gradient shard within 2e-3 of the leaf's largest tp = 1
    gradient (compressed and ring at their looser bounds)."""
    d, _ = workdir
    got, want = _load(d, mesh_name)
    mesh, model = _mesh(mesh_name), TP_MESHES[mesh_name][1]
    tol, grad_tol = TP_TOL.get(run, (3e-4, 2e-3))
    for r in range(WORLD):
        assert abs(float(got[r][f"{run}/loss"]) - float(want["tp1/loss"])) < tol
        for n, g in _leaves(got[r], f"{run}/grad/").items():
            full = want[f"tp1/grad/{n}"]
            w = _cut(full, n, mesh, r, model)
            assert np.max(np.abs(g - w)) / (np.max(np.abs(full)) + 1e-8) < grad_tol, (n, r)


@pytest.mark.parametrize("strategy", ["concom", "depcha"])
def test_hierarchical_on_pods_with_a_model_axis(workdir, strategy):
    """pod 2 × data 1 × model 2: the pod stages at each model coordinate,
    then a psum over "model" (post-backward, and in the backward under
    depcha), against the reference at the same mesh and at tp = 1."""
    d, _ = workdir
    got, want = _load(d, "2x2")
    run, mesh = f"pod-{strategy}", make_pod_mesh(*TP_POD_MESH)
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][f"{run}/loss"], want[f"{run}/loss"], rtol=RTOL)
        for n, g in _leaves(got[r], f"{run}/grad/").items():
            np.testing.assert_allclose(g, _cut(want[f"{run}/grad/{n}"], n, mesh, r, 2),
                                       rtol=RTOL, atol=ATOL, err_msg=n)
            full = want[f"tp1/grad/{n}"]
            w = _cut(full, n, mesh, r, 2)
            assert np.max(np.abs(g - w)) / (np.max(np.abs(full)) + 1e-8) < 2e-3, n


def test_kvstore_reduces_over_a_subset_of_the_ranks(workdir):
    """The paper's KVStore with ``reduce_axes=("model",)`` sums over the
    ranks of the rank's data coordinate only (rank r pushes r + 1): on
    data 2 x model 2 a subset of the ranks."""
    d, _ = workdir
    for mesh_name, (data, model) in TP_MESHES.items():
        got, _ = _load(d, mesh_name)
        for r in range(WORLD):
            want = sum(q + 1 for q in range(WORLD) if q // model == r // model)
            np.testing.assert_array_equal(got[r]["kvstore"], np.full(5, want, np.float32))


# ------------------------------------------------------- steps and clip

def _replicated(model):
    specs = tf.param_rules(tp_config(model))
    names = [n for n, _ in flatten_with_names(tf.init_params(tp_config(model), device="meta"))[0]]
    return [n for n in names if specs.spec(n) == ()]


def _model_groups(mesh):
    return [[r for r in range(WORLD) if r // mesh.shape["model"] == g]
            for g in range(WORLD // mesh.shape["model"])]


def test_adamw_steps_through_trainer_match_reference(workdir):
    d, _ = workdir
    got, want = _load(d, "2x2")
    mesh = _mesh("2x2")
    for r in range(WORLD):
        for step in range(TP_STEPS):
            np.testing.assert_allclose(got[r][f"adamw/loss/{step}"], want[f"adamw/loss/{step}"],
                                       rtol=RTOL)
        for n, p in _leaves(got[r], "adamw/param/").items():
            np.testing.assert_allclose(p, _cut(want[f"adamw/param/{n}"], n, mesh, r, 2),
                                       rtol=RTOL, atol=2e-5, err_msg=n)
    for group in _model_groups(mesh):
        for n in _replicated(2):
            for r in group[1:]:
                np.testing.assert_array_equal(got[r][f"adamw/param/{n}"],
                                              got[group[0]][f"adamw/param/{n}"], err_msg=n)


def _check_clipped_step(got, want, run, mesh, model, p0):
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][f"{run}/grad_norm"], want["tp1-clip/grad_norm"],
                                   rtol=3e-4)
        for n, p in _leaves(got[r], f"{run}/param/").items():
            full = want[f"tp1-clip/param/{n}"] - p0[n]
            upd = p - _cut(p0[n], n, mesh, r, model)
            w = _cut(full, n, mesh, r, model)
            assert np.max(np.abs(upd - w)) / (np.max(np.abs(full)) + 1e-12) < 2e-3, (n, r)
    for group in _model_groups(mesh):
        for n in _replicated(model):
            for r in group[1:]:
                np.testing.assert_array_equal(got[r][f"{run}/param/{n}"],
                                              got[group[0]][f"{run}/param/{n}"], err_msg=n)


@pytest.mark.parametrize("mesh_name", TP_MESHES)
def test_clipped_step_matches_reference_at_tp1(workdir, mesh_name):
    """One SGD step clipped at 0.05 (binding: the norm is 2.76): the
    port's norm is the reference's tp = 1 norm within 3e-4 and its update
    the tp = 1 update within 2e-3 of each leaf's largest; the replicated
    leaves are equal bit for bit on every rank of a model group."""
    d, _ = workdir
    got, want = _load(d, mesh_name)
    p0 = dict(np.load(d / "tp_params.npz"))
    _check_clipped_step(got, want, "clip", _mesh(mesh_name), TP_MESHES[mesh_name][1], p0)


def test_the_reference_clips_each_model_rank_by_its_own_shards(workdir):
    """The fault this port does not copy (ROADMAP queue 3): at data 1 ×
    model 4 the reference's plain step clips by a norm each model rank
    takes over its own shards, so no rank has the tp = 1 norm, the norms
    differ between ranks, and the replicated leaves (equal before the
    step) come out different on different model ranks."""
    d, _ = workdir
    _, want = _load(d, "1x4")
    norms, tp1 = want["fault/norms"], float(want["tp1-clip/grad_norm"])
    assert norms.shape == (4,)
    assert np.all(norms < tp1 * 0.9)
    assert len(set(norms.tolist())) == 4
    differ = [n for n in _replicated(4)
              if not all(np.array_equal(want[f"fault/param/{n}"][i], want[f"fault/param/{n}"][0])
                         for i in range(4))]
    assert differ == _replicated(4)


def test_zero1_at_data_x_model_matches_reference(workdir):
    """ZeRO-1 at data 2 × model 2 (SGD with momentum, two steps):
    scheduled and monolithic against the reference's at rtol 1e-5 /
    atol 1e-6; the scheduled step clipped by its NORM op against the
    reference's tp = 1 clipped step."""
    d, _ = workdir
    got, want = _load(d, "2x2")
    mesh = _mesh("2x2")
    for run in ("zero1-scheduled", "zero1-monolithic"):
        for r in range(WORLD):
            for step in range(2):
                np.testing.assert_allclose(got[r][f"{run}/loss/{step}"],
                                           want[f"{run}/loss/{step}"], rtol=RTOL)
            for n, p in _leaves(got[r], f"{run}/param/").items():
                np.testing.assert_allclose(p, _cut(want[f"{run}/param/{n}"], n, mesh, r, 2),
                                           rtol=RTOL, atol=ATOL, err_msg=f"{run} {n}")
    p0 = dict(np.load(d / "tp_params.npz"))
    _check_clipped_step(got, want, "zero1-scheduled-clip", mesh, 2, p0)


# ------------------------------------------------------------------ FSDP

FSDP_MESH_RUNS = [(m, run) for m in FSDP_MESHES for run in FSDP_GRADS[m].values()]


def _fsdp_leaves(model):
    cfg = tp_config(model, fsdp=True)
    names = [n for n, _ in flatten_with_names(tf.init_params(cfg, device="meta"))[0]]
    return sorted(n for n in names if "data" in sharding.flat_spec_axes(
        tf.param_rules(cfg).spec(n)))


@pytest.mark.parametrize("mesh_name,run", FSDP_MESH_RUNS)
def test_fsdp_gradient_shards_match_reference(workdir, mesh_name, run):
    """Each rank's loss and its gradient shards (the FSDP leaves' the dp
    sum of their dp shards, reduce-scattered in the backward) against the
    reference with FSDP at the same mesh, cut to the rank's blocks; the
    FSDP leaves never enter a GradSync bucket, and depcha's in-backward
    sync passes exactly them through."""
    d, _ = workdir
    got, want = _load(d, mesh_name)
    mesh, model = _mesh(mesh_name), MESHES[mesh_name][1]
    cfg = tp_config(model, fsdp=True)
    fsdp_leaves = _fsdp_leaves(model)
    assert len(fsdp_leaves) == 5
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][f"{run}/loss"], want[f"{run}/loss"], rtol=RTOL)
        grads = _leaves(got[r], f"{run}/grad/")
        assert set(grads) == set(_leaves(want, f"{run}/grad/"))
        for n, g in grads.items():
            w = _cut(want[f"{run}/grad/{n}"], n, mesh, r, model, cfg)
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{n} rank {r}")
        assert not set(got[r][f"{run}/bucketed"].tolist()) & set(fsdp_leaves)
        if run == "fsdp-depcha":
            assert sorted(got[r][f"{run}/passthrough"].tolist()) == fsdp_leaves


@pytest.mark.parametrize("mesh_name", FSDP_MESHES)
def test_fsdp_step_matches_reference_at_dp1_tp1(workdir, mesh_name):
    """The reference's check 5: one concom AdamW step (lr 1e-3, no clip)
    with FSDP against the reference's step at dp 1 × tp 1: the loss
    within 3e-4, every param shard within 5e-4."""
    d, _ = workdir
    got, want = _load(d, mesh_name)
    mesh, model = _mesh(mesh_name), MESHES[mesh_name][1]
    cfg = tp_config(model, fsdp=True)
    for r in range(WORLD):
        assert abs(float(got[r]["fsdp-step/loss/0"]) - float(want["tp1-adamw/loss/0"])) < 3e-4
        for n, p in _leaves(got[r], "fsdp-step/param/").items():
            w = _cut(want[f"tp1-adamw/param/{n}"], n, mesh, r, model, cfg)
            assert np.max(np.abs(p - w)) < 5e-4, (n, r)


def _dp_replicas(mesh, model):
    """Rank groups that hold the same block of a leaf replicated over
    "data": the ranks of one model coordinate."""
    return [[r for r in range(WORLD) if r % model == m] for m in range(model)]


@pytest.mark.parametrize("mesh_name", FSDP_MESHES)
def test_fsdp_clipped_step_matches_reference_at_tp1(workdir, mesh_name):
    """One SGD step clipped at 0.05 (binding) with FSDP: the norm is the
    reference's dp 1 × tp 1 norm within 3e-4 (each leaf's squares summed
    over the axes its spec shards it over) and the update its update
    within 2e-3 of each leaf's largest; a leaf replicated over "data"
    is equal bit for bit on every data rank."""
    d, _ = workdir
    got, want = _load(d, mesh_name)
    mesh, model = _mesh(mesh_name), MESHES[mesh_name][1]
    cfg = tp_config(model, fsdp=True)
    p0 = dict(np.load(d / "tp_params.npz"))
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["fsdp-clip/grad_norm"], want["tp1-clip/grad_norm"],
                                   rtol=3e-4)
        for n, p in _leaves(got[r], "fsdp-clip/param/").items():
            full = want[f"tp1-clip/param/{n}"] - p0[n]
            upd = p - _cut(p0[n], n, mesh, r, model, cfg)
            w = _cut(full, n, mesh, r, model, cfg)
            assert np.max(np.abs(upd - w)) / (np.max(np.abs(full)) + 1e-12) < 2e-3, (n, r)
    replicated = [n for n in _leaves(got[0], "fsdp-clip/param/") if n not in _fsdp_leaves(model)]
    for group in _dp_replicas(mesh, model):
        for n in replicated:
            for r in group[1:]:
                np.testing.assert_array_equal(got[r][f"fsdp-clip/param/{n}"],
                                              got[group[0]][f"fsdp-clip/param/{n}"], err_msg=n)


def test_the_reference_clips_each_data_rank_by_its_own_fsdp_shards(workdir):
    """The fault this port does not copy (ROADMAP queue 3): at data 4 ×
    model 1 under FSDP the reference's plain step clips by a norm each
    data rank takes over its own shards of the FSDP leaves (and the
    synced replicated leaves), so no rank has the dp 1 norm, the norms
    differ between data ranks, and the leaves replicated over "data"
    (equal before the step) come out different on different data
    ranks."""
    d, _ = workdir
    _, want = _load(d, "4x1")
    norms, tp1 = want["fsdp-fault/norms"], float(want["tp1-clip/grad_norm"])
    assert norms.shape == (4,)
    assert np.all(norms < tp1 * 0.9)
    assert len(set(norms.tolist())) == 4
    leaves = _leaves(want, "fsdp-fault/param/")
    names = [n for n, _ in flatten_with_names(tf.init_params(tp_config(1), device="meta"))[0]]
    assert sorted(leaves) == sorted(n for n in names if n not in _fsdp_leaves(1))
    differ = [n for n, v in leaves.items() if not all(np.array_equal(v[i], v[0])
                                                       for i in range(4))]
    assert sorted(differ) == sorted(leaves)


@pytest.mark.parametrize("mesh_name", FSDP_MESHES)
def test_fsdp_with_zero1_is_refused(workdir, mesh_name):
    d, _ = workdir
    got, _ = _load(d, mesh_name)
    assert all(bool(got[r]["fsdp-zero1-refused"]) for r in range(WORLD))


# ------------------------------------------------------------------- MoE

MOE_MESH_RUNS = [(m, run) for m in MOE_RUNS for run in MOE_RUNS[m]]


def _moe_cfg(mesh_name, run):
    arch, _, fsdp = MOE_RUNS[mesh_name][run]
    return arch, moe_config(arch, MESHES[mesh_name][1], fsdp=fsdp)


@pytest.mark.parametrize("mesh_name,run", MOE_MESH_RUNS)
def test_moe_gradient_shards_match_reference(workdir, mesh_name, run):
    """MoE with the experts sharded over "model" (each rank runs its
    e_local experts on every local token and one psum combines them):
    each rank's loss and gradient shards against the reference at the
    same mesh, rtol 1e-5 / atol 1e-6."""
    d, _ = workdir
    got, want = _load(d, mesh_name)
    mesh, model = _mesh(mesh_name), MESHES[mesh_name][1]
    _, cfg = _moe_cfg(mesh_name, run)
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][f"{run}/loss"], want[f"{run}/loss"], rtol=RTOL)
        grads = _leaves(got[r], f"{run}/grad/")
        assert set(grads) == set(_leaves(want, f"{run}/grad/")) and "blocks/router" in grads
        for n, g in grads.items():
            np.testing.assert_allclose(g, _cut(want[f"{run}/grad/{n}"], n, mesh, r, model, cfg),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{n} rank {r}")


@pytest.mark.parametrize("mesh_name,run", MOE_MESH_RUNS)
def test_moe_tp_equals_tp1(workdir, mesh_name, run):
    """compare_tp for MoE: the loss within 3e-4 of the reference's tp = 1
    loss at the same dp, every gradient shard within 2e-3 of the leaf's
    largest tp = 1 gradient."""
    d, _ = workdir
    got, want = _load(d, mesh_name)
    mesh, model = _mesh(mesh_name), MESHES[mesh_name][1]
    arch, cfg = _moe_cfg(mesh_name, run)
    for r in range(WORLD):
        assert abs(float(got[r][f"{run}/loss"]) - float(want[f"moe-{arch}-tp1/loss"])) < 3e-4
        for n, g in _leaves(got[r], f"{run}/grad/").items():
            full = want[f"moe-{arch}-tp1/grad/{n}"]
            w = _cut(full, n, mesh, r, model, cfg)
            assert np.max(np.abs(g - w)) / (np.max(np.abs(full)) + 1e-8) < 2e-3, (n, r)


# ------------------------------ cross-attention, RWKV-6 and the Zamba2 hybrid

XR_MESH_RUNS = [(m, run) for m in XR_RUNS for run in XR_RUNS[m]]


@pytest.mark.parametrize("mesh_name,run", XR_MESH_RUNS)
def test_cross_attention_and_rwkv_match_reference_at_tp1(workdir, mesh_name, run):
    """llama-3.2-vision's smoke config (gate_attn 0.7) at data 4, data 1 ×
    model 4 (kv heads sliced), data 2 × model 2 (kv heads sharded) and
    FSDP at 2 × 2, RWKV-6's (constant leaves perturbed) at 1 × 4 and 2 × 2,
    and Zamba2's (constant leaves perturbed) at data 4, 1 × 4 (kv heads
    sharded, and with 2 kv heads sliced) and 2 × 2: under funnel, concom
    and depcha each rank's loss and reduced gradient shards equal one
    another (rtol 1e-5 / atol 1e-6) and compare_tp's 3e-4 loss / 2e-3
    gradient of the reference's tp = 1 run (``tests/test_torch_vision.py``,
    ``tests/test_torch_rwkv_train.py``, ``tests/test_torch_ssm.py``)."""
    d, _ = workdir
    got, _ = _load(d, mesh_name)
    _, oracle = _load(d, "4x1")
    kind, fsdp = XR_RUNS[mesh_name][run]
    mesh, model = _mesh(mesh_name), MESHES[mesh_name][1]
    cfg = xr_config(kind, model, fsdp=fsdp)
    want_loss = float(oracle[f"xr-{kind}-tp1/loss"])
    for r in range(WORLD):
        base = _leaves(got[r], f"xr-{run}-{XR_STRATEGIES[0]}/grad/")
        assert set(base) == set(_leaves(oracle, f"xr-{kind}-tp1/grad/"))
        for strategy in XR_STRATEGIES:
            tag = f"xr-{run}-{strategy}"
            loss = float(got[r][f"{tag}/loss"])
            assert abs(loss - want_loss) < 3e-4, (tag, r, loss, want_loss)
            np.testing.assert_allclose(loss, float(got[r][f"xr-{run}-funnel/loss"]), rtol=RTOL)
            for n, g in _leaves(got[r], f"{tag}/grad/").items():
                np.testing.assert_allclose(g, base[n], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{tag} {n} rank {r}")
                full = oracle[f"xr-{kind}-tp1/grad/{n}"]
                w = _cut(full, n, mesh, r, model, cfg)
                assert np.max(np.abs(g - w)) / (np.max(np.abs(full)) + 1e-8) < 2e-3, (tag, n, r)
