"""Depcha's in-backward gradient sync (``repro_torch/core/overlap.py``) and
the LM's data-parallel step on 4 gloo ranks, against the JAX package.

Four rank processes (``tests/_torch_mdworker.py``, mode ``lm``) train the
quickstart LM (4 layers, d 128, 8/4 heads, ff 256, vocab 512, f32) from
the reference's weights, each on its slice of the reference's batches.
The oracle is the reference's full-batch step on one device (the LM has
no batch statistics, so the sum of the shards' gradients is the full
batch's): for funnel, concom and depcha in-scan, each step's loss and
reduced gradients within rtol 1e-5 / atol 1e-6 of JAX's at its own
params, over three steps; params bit-identical across the ranks; exactly
``n_layers`` in-backward collectives a depcha step and none under the
others.  The params after three AdamW steps are not held to 1e-5: the
normalised update g / (sqrt(v) + eps) magnifies a gradient's last-bit
difference in the few elements where |g| is near eps (2 of 131,072
elements of ``blocks/wg`` move 4e-6 against the reference's).
The in-backward sync's branches: ``hierarchical`` on pod 2 x data 2 within
the same tolerance of JAX's gradients; ``compressed`` (int8; on data 4, and
on pod 2 x data 2 with the f32 sum across the pods) within the
quantization bound of each layer's slot, as
``tests/test_torch_multirank.py`` bounds the compressed reducer.

In one process on a one-rank group: the syncer fires once a layer under
every ``remat``, its slot staging gives the plain backward's gradients bit
for bit, and ``remat`` none / dots / full give the same gradients bit for
bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import GradSyncConfig as RefGradSyncConfig
from repro.data import TokenPipeline as RefTokenPipeline
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro.optim import cosine_warmup as ref_cosine_warmup
from repro.runtime import make_train_step as ref_make_train_step
from repro.utils.trees import flatten_with_names as ref_flatten

from _torch_mdworker import LM_BATCH, LM_RUNS, LM_SEQ, LM_STEPS, WORLD, lm_config, run_all
from repro_torch.configs.qwen3_1_7b import make_smoke
from repro_torch.data import TokenPipeline
from repro_torch.kernels.quantize import ref as quantize_ref
from repro_torch.launch.mesh import init_dist, make_dp_mesh
from repro_torch.models import transformer
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names

RTOL, ATOL = 1e-5, 1e-6
STEP_RUNS = ("lm-funnel", "lm-concom", "lm-depcha")


def _ref_cfg():
    return ref_tf.TransformerConfig(
        name="quickstart-lm", n_layers=4, d_model=128, n_heads=8, kv_heads=4,
        d_ff=256, vocab=512, tp=1, attn_chunk=64, dtype=jnp.float32)


def _ref_value_and_grad(cfg, mesh):
    def vg(params, batch):
        return jax.value_and_grad(lambda p: ref_tf.train_forward(p, batch, cfg))(params)

    def run(params, batch):
        specs = jax.tree.map(lambda _: P(), params)
        return jax.shard_map(vg, mesh=mesh, in_specs=(specs, {k: P() for k in batch}),
                             out_specs=(P(), specs), check_vma=False)(params, batch)
    return jax.jit(run)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The reference's weights in, the 4 workers run, their outputs here."""
    d = tmp_path_factory.mktemp("torch_lm")
    params = ref_tf.init_params(jax.random.PRNGKey(0), _ref_cfg())
    np.savez(d / "lm_params.npz", **{n: np.asarray(p) for n, p in ref_flatten(params)[0]})
    run_all(d, "lm")
    return d, params


@pytest.fixture(scope="module")
def reference(workdir):
    """JAX's full-batch step for LM_STEPS steps: each step's loss and its
    gradients at the reference's own params."""
    _, params = workdir
    cfg, mesh = _ref_cfg(), ref_smoke_mesh(1, 1)
    pipe = RefTokenPipeline(cfg.vocab, LM_SEQ, LM_BATCH, mesh=mesh)
    opt = ref_adamw(ref_cosine_warmup(1e-3, 20, 200))
    ts = ref_make_train_step(cfg, mesh, RefGradSyncConfig(strategy="funnel"), opt,
                             batch_like=pipe.batch_at(0), params_like=params,
                             clip_norm=1.0)
    vg = _ref_value_and_grad(cfg, mesh)
    state, steps = opt.init(params), []
    for step in range(LM_STEPS):
        loss, grads = vg(params, pipe.batch_at(step))
        steps.append((float(loss), {n: np.asarray(g) for n, g in ref_flatten(grads)[0]}))
        params, state, _ = ts.fn(params, state, pipe.batch_at(step), jnp.int32(step))
    return steps


def _load(d, run, rank):
    return dict(np.load(d / f"{run}_rank{rank}.npz"))


@pytest.mark.parametrize("run", STEP_RUNS)
def test_steps_match_the_full_batch_reference(workdir, reference, run):
    """Every step's global loss and reduced gradients, on every rank."""
    d, _ = workdir
    for rank in range(WORLD):
        got = _load(d, run, rank)
        for step, (want_loss, want_grads) in enumerate(reference):
            np.testing.assert_allclose(got[f"loss/{step}"], want_loss, rtol=RTOL)
            for n, want in want_grads.items():
                np.testing.assert_allclose(got[f"grad{step}/{n}"], want, rtol=RTOL,
                                           atol=ATOL, err_msg=f"{run} rank {rank} "
                                           f"step {step} {n}")


@pytest.mark.parametrize("run", list(LM_RUNS))
def test_params_are_bit_identical_across_ranks(workdir, run):
    d, _ = workdir
    base = _load(d, run, 0)
    params = [k for k in base if k.startswith("param/")]
    assert params
    for rank in range(1, WORLD):
        got = _load(d, run, rank)
        for k in params:
            np.testing.assert_array_equal(got[k].view(np.uint32), base[k].view(np.uint32),
                                          err_msg=f"{run} rank {rank} {k}")


@pytest.mark.parametrize("run", list(LM_RUNS))
def test_in_backward_collectives_a_step(workdir, run):
    """n_layers a step under depcha in-scan (one a layer), none otherwise."""
    d, _ = workdir
    strategy, _, _, _, steps = LM_RUNS[run]
    want = lm_config().n_layers if strategy == "depcha" else 0
    for rank in range(WORLD):
        got = _load(d, run, rank)
        assert [int(got[f"collectives/{s}"]) for s in range(steps)] == [want] * steps


def test_hierarchical_branch_matches_the_reference(workdir, reference):
    d, _ = workdir
    _, want_grads = reference[0]
    for rank in range(WORLD):
        got = _load(d, "lm-depcha-hierarchical", rank)
        for n, want in want_grads.items():
            np.testing.assert_allclose(got[f"grad0/{n}"], want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {rank} {n}")


def _block_scales(buf: np.ndarray) -> np.ndarray:
    pad = (-buf.size) % (256 * WORLD)
    x = np.pad(buf, (0, pad)).reshape(-1, 256)
    return quantize_ref.quantize_ref(torch.from_numpy(x))[1].numpy()


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("run", ["lm-depcha-compressed", "lm-depcha-compressed-pods"])
def test_compressed_branch_is_within_the_quantization_bound(workdir, reference, run, rank):
    """Each layer's slot (its leaves in tree order, f32): per 256-element
    block |compressed - sum| <= sum_r scale_r / 2 + scale_2 / 2 (the ranks'
    quantization of their own slots and the requantized reduced shard),
    plus rtol 1e-5 / atol 1e-6 against JAX's sum; on data 4, and on pod 2
    x data 2 (int8 inside a pod, the shard summed in f32 across the pods).
    The other leaves go through the post-backward schedule (flat;
    hierarchical on the pods): rtol 1e-5 / atol 1e-6."""
    d, _ = workdir
    _, want_grads = reference[0]
    got = {k[len("grad0/"):]: v for k, v in _load(d, run, rank).items()
           if k.startswith("grad0/")}
    local = [dict(np.load(d / f"lm-local_rank{r}.npz")) for r in range(WORLD)]
    blocks = sorted(n for n in want_grads if n.startswith("blocks/"))
    for n in set(want_grads) - set(blocks):
        np.testing.assert_allclose(got[n], want_grads[n], rtol=RTOL, atol=ATOL, err_msg=n)
    for li in range(lm_config().n_layers):
        def cat(t):
            return np.concatenate([t[n][li].ravel() for n in blocks])
        out, want = cat(got), cat(want_grads)
        assert out.size >= 256 * WORLD
        s_sum = sum(_block_scales(cat(loc)) for loc in local)
        pad = (-out.size) % (256 * WORLD)
        s2 = np.abs(np.pad(out, (0, pad))).reshape(-1, 256).max(1) / 127
        bound = np.repeat((s_sum + s2 * (1 + 1e-6)) / 2, 256)[:out.size]
        assert np.all(np.abs(out - want) <= bound + RTOL * np.abs(want) + ATOL), li
        assert not np.array_equal(out, want)       # it did quantize


# ------------------------------------------------------- one process

@pytest.fixture(scope="module")
def group():
    init_dist("cpu")
    return make_dp_mesh()


def _smoke_grads(remat: str, sync: bool, mesh):
    """The qwen3 smoke config's gradients on a seeded batch, with the
    in-backward sync or without; returns (grads, collectives)."""
    import dataclasses

    cfg = dataclasses.replace(make_smoke(), remat=remat, depcha_in_scan=sync)
    params = transformer.init_params(cfg, seed=1, device="cpu")
    model = transformer.Transformer(cfg, params)
    layer_sync = transformer.layer_sync(cfg, model.params_tree(), mesh, "cpu")
    batch = TokenPipeline(cfg.vocab, 40, 2, device="cpu").batch_at(0)
    if layer_sync is not None:
        layer_sync.begin()
    model(batch, layer_sync).backward()
    named = flatten_with_names(model.params_tree())[0]
    collectives = 0
    if layer_sync is not None:
        stacked = dict(named)
        layer_sync.finish([stacked[n] for n in layer_sync.names])
        collectives = layer_sync.collectives
    return {n: p.grad.clone() for n, p in named}, collectives


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_layer_sync_fires_once_a_layer_and_stages_bit_exactly(group, remat):
    want, _ = _smoke_grads(remat, False, group)
    got, collectives = _smoke_grads(remat, True, group)
    assert collectives == make_smoke().n_layers
    for n, g in want.items():
        assert torch.equal(got[n], g), n


def test_remat_policies_give_the_same_gradients(group):
    base, _ = _smoke_grads("none", False, group)
    for remat in ("dots", "full"):
        got, _ = _smoke_grads(remat, False, group)
        for n, g in base.items():
            assert torch.equal(got[n], g), (remat, n)


def test_finish_refuses_a_layer_that_never_fired(group):
    import dataclasses

    cfg = dataclasses.replace(make_smoke(), depcha_in_scan=True)
    model = transformer.Transformer(cfg, transformer.init_params(cfg, device="cpu"))
    layer_sync = transformer.layer_sync(cfg, model.params_tree(), group, "cpu")
    layer_sync.begin()
    with pytest.raises(RuntimeError, match="no in-backward gradient for layers"):
        layer_sync.finish([p for _, p in sorted(model.params_tree()["blocks"].items())])


def test_unknown_remat_raises():
    from repro_torch.core.overlap import rematted

    with pytest.raises(ValueError, match="remat"):
        rematted(lambda p, x: x, "offload")


def test_params_carry_from_the_reference(workdir):
    """The worker's weights are the reference's, leaf for leaf."""
    d, params = workdir
    named = dict(np.load(d / "lm_params.npz"))
    tree = params_from_numpy(named, "cpu")
    port = dict(flatten_with_names(tree)[0])
    assert list(port) == [n for n, _ in ref_flatten(params)[0]]
    meta = flatten_with_names(transformer.init_params(lm_config(), device="meta"))[0]
    assert [(n, tuple(p.shape)) for n, p in meta] == [(n, tuple(p.shape))
                                                      for n, p in port.items()]
