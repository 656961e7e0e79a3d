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

from _torch_mdworker import (TP_GRADS, TP_MESHES, TP_POD_MESH, TP_STEPS, WORLD, run_all,
                             run_tp_ops, tp_config)
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro.parallel import sharding as ref_sharding
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.launch.mesh import make_pod_mesh, make_smoke_mesh
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding
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
    (d / "ops").mkdir()
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        runs = [ex.submit(run_all, d, f"tp-{m}", reference_too=True, timeout=400)
                for m in TP_MESHES]
        ops = ex.submit(run_tp_ops, d / "ops", WORLD)
        for f in runs:
            f.result()
        return d, ops.result()


def _load(d, mesh_name):
    got = [dict(np.load(d / f"tp-{mesh_name}_rank{r}.npz")) for r in range(WORLD)]
    return got, dict(np.load(d / f"tp-{mesh_name}_jax.npz"))


def _mesh(mesh_name):
    return make_smoke_mesh(*TP_MESHES[mesh_name])


def _cut(full, name, mesh, rank, model):
    """Rank ``rank``'s block of a global reference array."""
    spec = tf.param_rules(tp_config(model)).spec(name)
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
