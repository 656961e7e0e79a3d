"""The port's cross-attention (llama-3.2-vision) against the JAX package's,
with the reference's weights carried over by name (``params_from_numpy``)
and ``gate_attn`` set nonzero on both sides: at its zero init the cross
blocks add nothing to the loss and their projections get no gradient.

Two configs: the smoke config (5 layers: one group of 4 self blocks and
a cross block) and a 12-layer variant (two groups and a remainder of 2
self blocks, the order ``_layer_order`` must keep).  Held to the
reference in f32:

  - ``train_forward``'s loss and every leaf's gradient against JAX's
    ``value_and_grad(train_forward)`` inside ``shard_map`` on the
    one-device smoke mesh, with ``img_embeds`` drawn by the pipelines as
    the arch's extra input: within 1e-5 of each leaf's largest gradient
    (the loss to rtol 1e-5);
  - prefill's logits and KV cache, then 4 decode steps' logits and cache,
    against the reference's ``prefill``/``decode_step`` with the same
    image embeddings: atol/rtol 1e-5;
  - the parameter tree (``cross_blocks`` with ``lnkv`` and the zero
    ``gate_attn``) and its sharding rules against the reference's;
  - the launcher trains the arch on the CPU.

The multi-rank cases (funnel, concom and depcha at data 4, data 1 ×
model 4 with the kv heads sliced, data 2 × model 2 with them sharded, and
FSDP at 2 × 2, against the reference's tp = 1) run on the tensor-parallel
spawns of ``tests/test_torch_tp.py``, which holds them.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch as ref_get_arch
from repro.data import TokenPipeline as RefTokenPipeline
from repro.models import transformer as ref_tf
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.configs import get_arch
from repro_torch.data import TokenPipeline
from repro_torch.models import transformer as tf
from repro_torch.models.registry import family_of
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names

ARCH = "llama-3.2-vision-11b"
SEQ, BATCH = 24, 2
GRAD_TOL = 1e-5
TOL = dict(atol=1e-5, rtol=1e-5)
LAYERS = {"smoke": 5, "12-layer": 12}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(layers: int):
    return (dataclasses.replace(ref_get_arch(ARCH).make_smoke(), n_layers=layers),
            dataclasses.replace(get_arch(ARCH).make_smoke(), n_layers=layers))


def _weights(ref_cfg, seed=0):
    """The reference's weights with ``gate_attn`` drawn in [0.3, 0.9): as a
    JAX tree and as numpy arrays by name."""
    params = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    named, treedef = ref_flatten(params)
    arrays = {n: np.asarray(p) for n, p in named}
    gate = arrays["cross_blocks/gate_attn"]
    arrays["cross_blocks/gate_attn"] = np.random.default_rng(seed).uniform(
        0.3, 0.9, gate.shape).astype(gate.dtype)
    leaves = [jnp.asarray(arrays[n]) for n, _ in named]
    return jax.tree_util.tree_unflatten(treedef, leaves), arrays


def _extras(cfg):
    return {name: (tuple(fn(cfg, SEQ)), np.float32)
            for name, fn, _ in get_arch(ARCH).extra_inputs}


def _jax_run(mesh, fn, *args):
    f = jax.shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                      out_specs=P(), check_vma=False)
    return jax.jit(f)(*args)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("layers", sorted(LAYERS))
def test_loss_and_grads_match_reference(smoke_mesh, layers):
    ref_cfg, cfg = _cfgs(LAYERS[layers])
    params, arrays = _weights(ref_cfg)
    batch = RefTokenPipeline(cfg.vocab, SEQ, BATCH, extra_specs=_extras(cfg)).batch_at(2)
    assert batch["img_embeds"].shape == (BATCH, 576, cfg.d_model)

    def vg(p, b):
        return jax.value_and_grad(lambda q: ref_tf.train_forward(q, b, ref_cfg))(p)

    specs = jax.tree.map(lambda _: P(), params)
    run = jax.jit(jax.shard_map(vg, mesh=smoke_mesh, in_specs=(specs, {k: P() for k in batch}),
                                out_specs=(P(), specs), check_vma=False))
    want_loss, want_grads = run(params, batch)
    want_grads = {n: np.asarray(g) for n, g in ref_flatten(want_grads)[0]}

    model = tf.Transformer(cfg, params_from_numpy(arrays, "cpu"))
    loss = model(TokenPipeline(cfg.vocab, SEQ, BATCH, extra_specs=_extras(cfg),
                               device="cpu").batch_at(2))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = dict(flatten_with_names(model.params_tree())[0])
    assert list(got) == list(want_grads)
    for n, want in want_grads.items():
        scale = np.max(np.abs(want))
        assert scale > 0, f"{n} has no gradient"
        assert np.max(np.abs(got[n].grad.numpy() - want)) <= GRAD_TOL * scale, n


@pytest.mark.parametrize("layers", sorted(LAYERS))
def test_prefill_and_decode_match_reference(smoke_mesh, layers):
    ref_cfg, cfg = _cfgs(LAYERS[layers])
    params, arrays = _weights(ref_cfg, seed=1)
    tree = params_from_numpy(arrays, "cpu")
    rng = np.random.default_rng(7)
    B, S, max_len = 2, 10, 16
    toks = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    img = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    want, rcache = _jax_run(smoke_mesh, lambda p, t, i: ref_tf.prefill(p, t, ref_cfg,
                                                                       img_embeds=i),
                            params, jnp.asarray(toks), jnp.asarray(img))
    got, cache = tf.prefill(tree, torch.from_numpy(toks), cfg, img_embeds=torch.from_numpy(img))
    np.testing.assert_allclose(_np(got), _np(want), err_msg="prefill logits", **TOL)
    assert cache["k"].shape[0] == cfg.n_self
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(cache[n]), _np(rcache[n]), err_msg=n, **TOL)
    rcache = jax.tree.map(
        lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, max_len - S), (0, 0), (0, 0))), rcache)
    cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, max_len - S))
             for n, c in cache.items()}
    feed = rng.integers(1, cfg.vocab, (4, B)).astype(np.int32)
    for step in range(4):
        pos = S + step
        want, rcache = _jax_run(
            smoke_mesh, lambda p, c, t, i: ref_tf.decode_step(p, c, t, pos, ref_cfg,
                                                              img_embeds=i),
            params, rcache, jnp.asarray(feed[step]), jnp.asarray(img))
        got, cache2 = tf.decode_step(tree, cache, torch.from_numpy(feed[step]), pos, cfg,
                                     img_embeds=torch.from_numpy(img))
        assert cache2 is cache
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"step {step}", **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(_np(cache[n]), _np(rcache[n]),
                                       err_msg=f"{n}, step {step}", **TOL)


@pytest.mark.parametrize("fsdp", [False, True])
def test_params_and_rules_match_reference(fsdp):
    """The tree's names, shapes and dtypes and every leaf's spec (the cross
    blocks' under the reference's patterns, with and without FSDP) at the
    full config on ``meta``; the init's constant leaves as the
    reference's."""
    ref_cfg = ref_get_arch(ARCH).make_config(tp=4, fsdp=fsdp)
    cfg = get_arch(ARCH).make_config(tp=4, fsdp=fsdp)
    want = jax.eval_shape(lambda: ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg))
    got = tf.init_params(cfg, device="meta")
    want_named = dict(ref_flatten(want)[0])
    got_named = dict(flatten_with_names(got)[0])
    assert list(got_named) == list(want_named)
    for n, w in want_named.items():
        assert tuple(got_named[n].shape) == tuple(w.shape), n
        assert str(got_named[n].dtype) == f"torch.{w.dtype}", n
        want_spec = tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                          for e in ref_tf.param_rules(ref_cfg).spec(n))
        assert tf.param_rules(cfg).spec(n) == want_spec, n
    assert cfg.n_cross == 8 and cfg.n_self == 32
    smoke = tf.init_params(get_arch(ARCH).make_smoke(), device="cpu")
    assert torch.equal(smoke["cross_blocks"]["gate_attn"], torch.zeros(1))
    assert torch.equal(smoke["cross_blocks"]["lnkv"], torch.ones(1, 64))
    assert family_of(cfg).in_scan_names(got) >= {"cross_blocks/wq", "cross_blocks/gate_attn"}


def test_in_backward_sync_covers_both_stacks(tmp_path):
    """depcha's in-backward sync of a cross-attention config: one
    ``LayerSync`` a stack behind one ``StackSyncs`` (the second sharing the
    first's communicators), whose names are exactly the in-scan leaves;
    on one CPU rank its sum is the identity, so the step's gradients are
    the plain backward's."""
    import torch.distributed as dist

    from repro_torch.core import GradSyncConfig
    from repro_torch.core.overlap import StackSyncs
    from repro_torch.launch.mesh import init_dist, make_smoke_mesh
    from repro_torch.optim import sgd
    from repro_torch.runtime import make_train_step

    init_dist("cpu", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        cfg = dataclasses.replace(get_arch(ARCH).make_smoke(), n_layers=12,
                                  depcha_in_scan=True)
        params = tf.init_params(cfg, device="cpu")
        params["cross_blocks"]["gate_attn"].fill_(0.5)
        model = tf.Transformer(cfg, params)
        ts = make_train_step(cfg, make_smoke_mesh(1), GradSyncConfig(strategy="depcha"),
                             sgd(0.0), model=model, clip_norm=0.0, device="cpu")
        ls = ts.layer_sync
        assert isinstance(ls, StackSyncs)
        assert set(ls.names) == family_of(cfg).in_scan_names(model.params_tree())
        assert ls.of("cross_blocks/").comms is ls.of("blocks/").comms
        batch = TokenPipeline(cfg.vocab, SEQ, BATCH, extra_specs=_extras(cfg),
                              device="cpu").batch_at(0)
        ts.fn(model, ts.init_opt(), batch, 0)
        assert ls.collectives == cfg.n_layers            # one slot a layer
        got = {n: p.grad.clone() for n, p in flatten_with_names(model.params_tree())[0]}
        model.zero_grad(set_to_none=True)
        model(batch).backward()
        for n, p in flatten_with_names(model.params_tree())[0]:
            torch.testing.assert_close(got[n], p.grad, rtol=0, atol=0, msg=n)
    finally:
        dist.destroy_process_group()


def test_launcher_trains_the_arch_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env = {k: v for k, v in env.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--strategy", "depcha", "--steps", "2", "--seq", "16",
         "--batch", "2"], capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[train] llama-3.2-vision-11b depcha: loss" in out.stdout


def test_params_from_numpy_carries_cross_blocks():
    """The reference's bf16 weights into the port: every leaf, the cross
    blocks' included, bit for bit at tp = 1; at data 1 × model 2 each
    rank's blocks (``param_rules``) put back together along the sharded
    dim are the whole leaf, and a replicated leaf is whole on each rank."""
    from repro_torch.launch.mesh import make_smoke_mesh

    ref_cfg = dataclasses.replace(ref_get_arch(ARCH).make_smoke(), dtype=jnp.bfloat16,
                                  vocab=96)
    _, arrays = _weights(ref_cfg)
    whole = dict(flatten_with_names(params_from_numpy(arrays))[0])
    assert whole["cross_blocks/gate_attn"].dtype == torch.bfloat16
    for n, a in arrays.items():
        np.testing.assert_array_equal(whole[n].view(torch.int16).numpy(), a.view(np.int16),
                                      err_msg=n)
    cfg = dataclasses.replace(get_arch(ARCH).make_smoke(), tp=2, dtype=torch.bfloat16,
                              vocab=96)
    rules, mesh = tf.param_rules(cfg), make_smoke_mesh(1, 2)
    ranks = [dict(flatten_with_names(params_from_numpy(arrays, mesh=mesh, rank=r,
                                                       rules=rules))[0]) for r in range(2)]
    for n, w in whole.items():
        spec = rules.spec(n)
        if "model" in spec:
            got = torch.cat([rk[n] for rk in ranks], dim=spec.index("model"))
            assert ranks[0][n].shape[spec.index("model")] * 2 == w.shape[spec.index("model")]
        else:
            assert torch.equal(ranks[1][n], w), n
            got = ranks[0][n]
        assert torch.equal(got, w), n
