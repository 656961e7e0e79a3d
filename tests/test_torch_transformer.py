"""The port's transformer against the JAX package's, with the
reference's weights carried over by name (``params_from_numpy``): the
dense configs and granite-moe's smoke config (8 experts, top 2, the MoE
FFN in prefill and both decode steps).

The JAX side runs inside ``shard_map`` on the one-device smoke mesh, as
its own serving runtime runs it, and with ``use_flash=False`` (its
chunked path: the Pallas kernel does not run on the CPU outside interpret
mode).  The port runs both its chunked path and its flash dispatch, which
on CPU tensors is the plain ``ref.py``.  Everything is f32 and held to
atol/rtol 1e-5: the same math, summed in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.granite_moe_1b_a400m import make_smoke as ref_granite_smoke
from repro.configs.qwen3_1_7b import make_smoke as ref_qwen3_smoke
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro.utils.trees import flatten_with_names as ref_flatten
from _torch_mdworker import run_tp_ops
from repro_torch.configs.granite_moe_1b_a400m import make_smoke as granite_smoke
from repro_torch.configs.qwen3_1_7b import make_smoke as qwen3_smoke
from repro_torch.models import attention, common
from repro_torch.models import transformer as tf
from repro_torch.models.moe import MoECfg
from repro_torch.models.registry import family_of
from repro_torch.utils.convert import params_from_numpy, tensor_from_numpy
from repro_torch.utils.trees import flatten_with_names

TOL = dict(atol=1e-5, rtol=1e-5)


def _serve_cfgs():
    """(reference config, port config) pairs: the qwen3 and granite-moe
    smoke configs and ``tests/test_serve_runtime.py``'s (head_dim 8,
    chunk 16)."""
    kw = dict(name="serve", n_layers=2, d_model=32, n_heads=4, kv_heads=2,
              d_ff=64, vocab=64, tp=1, attn_chunk=16)
    return {
        "qwen3-smoke": (ref_qwen3_smoke(), qwen3_smoke()),
        "granite-smoke": (ref_granite_smoke(), granite_smoke()),
        "serve": (ref_tf.TransformerConfig(dtype=jnp.float32, **kw),
                  tf.TransformerConfig(dtype=torch.float32, **kw)),
    }


CFGS = _serve_cfgs()


def _jax_run(mesh, fn, *args):
    """``fn(*args)`` inside a jitted one-device ``shard_map``, every input
    and output replicated."""
    f = jax.shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                      out_specs=P(), check_vma=False)
    return jax.jit(f)(*args)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **TOL)


def _weights(ref_cfg, seed=0):
    params = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    named = {n: np.asarray(p) for n, p in ref_flatten(params)[0]}
    return params, params_from_numpy(named, "cpu")


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(np.int32)


# ------------------------------------------------------------ building blocks
def test_config_has_every_reference_field():
    ref_fields = [f.name for f in dataclasses.fields(ref_tf.TransformerConfig)]
    assert [f.name for f in dataclasses.fields(tf.TransformerConfig)] == ref_fields


@pytest.mark.parametrize("name", sorted(CFGS))
def test_init_params_tree_matches_reference(name):
    ref_cfg, cfg = CFGS[name]
    ref_p = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    want = [(n, tuple(p.shape)) for n, p in ref_flatten(ref_p)[0]]
    got = [(n, tuple(p.shape)) for n, p in
           flatten_with_names(tf.init_params(cfg, device="meta"))[0]]
    assert got == want
    p = tf.init_params(cfg, seed=3, device="cpu")
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all()
               for _, t in flatten_with_names(p)[0])


def test_common_numerics_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
           ref_common.rms_norm(jnp.asarray(x), jnp.asarray(s)), "rms_norm")
    for name, fn in common.ACTIVATIONS.items():
        _close(fn(torch.from_numpy(x)), ref_common.ACTIVATIONS[name](jnp.asarray(x)),
               name)
    pos = np.array([0, 3, 7, 100, 4000], np.int32)
    cos, sin = common.rope_angles(torch.from_numpy(pos), 16, 1e6)
    rcos, rsin = ref_common.rope_angles(jnp.asarray(pos), 16, 1e6)
    _close(cos, rcos, "cos")
    _close(sin, rsin, "sin")
    _close(common.apply_rope(torch.from_numpy(x), cos, sin),
           ref_common.apply_rope(jnp.asarray(x), rcos, rsin), "rope (S, D/2)")
    bcos, bsin = common.rope_angles(torch.from_numpy(pos[None, :].repeat(2, 0)), 16, 1e6)
    rbcos, rbsin = ref_common.rope_angles(jnp.asarray(pos[None, :].repeat(2, 0)), 16, 1e6)
    _close(common.apply_rope(torch.from_numpy(x), bcos, bsin),
           ref_common.apply_rope(jnp.asarray(x), rbcos, rbsin), "rope (B, S, D/2)")


def test_apply_rope_bf16_promotes_like_reference():
    """A bf16 x times f32 angles is computed in f32 and rounded once."""
    rng = np.random.default_rng(1)
    jx = jnp.asarray(rng.standard_normal((1, 6, 2, 16)), jnp.bfloat16)
    pos = np.arange(6, dtype=np.int32)
    rcos, rsin = ref_common.rope_angles(jnp.asarray(pos), 16, 1e4)
    cos, sin = common.rope_angles(torch.from_numpy(pos), 16, 1e4)
    got = common.apply_rope(tensor_from_numpy(np.asarray(jx)), cos, sin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref_common.apply_rope(jx, rcos, rsin)),
                               atol=1e-2, rtol=1e-2)


def test_embed_lookup_matches_reference(smoke_mesh, tmp_path):
    emb = np.random.default_rng(2).standard_normal((11, 4)).astype(np.float32)
    ids = np.array([[0, 3, 10, 11, -1]], np.int32)      # two out of range
    want = _jax_run(smoke_mesh, lambda e, i: ref_common.embed_lookup(e, i, 1),
                    jnp.asarray(emb), jnp.asarray(ids))
    got = common.embed_lookup(torch.from_numpy(emb), torch.from_numpy(ids), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # vocab-sharded over a model axis of 2 gloo ranks, the table padded to
    # 12 rows as the reference pads its vocab to a multiple of tp: every
    # rank looks up the full rows (zero outside the vocab)
    padded = np.concatenate([emb, np.zeros((1, 4), np.float32)])
    ranks = run_tp_ops(tmp_path, 2, emb=padded, ids=ids,
                       emb_cot=np.ones(ids.shape + (4,), np.float32))
    for got2 in ranks:
        np.testing.assert_array_equal(got2["embed"], np.asarray(want))


@pytest.mark.parametrize("kw", [
    dict(causal=True, chunk=8),
    dict(causal=True, chunk=5),                       # padded last chunk
    dict(causal=True, window=4, chunk=8),
    dict(causal=False, chunk=16),
    dict(causal=True, q_offset=6, kv_len=9, chunk=4),
])
def test_chunked_attention_matches_reference(kw):
    rng = np.random.default_rng(3)
    Sq = 12 - kw.get("q_offset", 0)
    q = rng.standard_normal((2, Sq, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, 2, 8)).astype(np.float32) for _ in range(2))
    want = ref_attn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = attention.attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_matches_reference(per_row, window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((3, 10, 2, 8)).astype(np.float32) for _ in range(2))
    kv_len = np.array([1, 6, 10], np.int32) if per_row else 7
    want = ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(kv_len), window=window)
    got = attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_len) if per_row else kv_len, window=window)
    _close(got, want)


def test_params_from_numpy_carries_bf16_exactly():
    cfg = dataclasses.replace(CFGS["qwen3-smoke"][0], dtype=jnp.bfloat16)
    params = ref_tf.init_params(jax.random.PRNGKey(5), cfg)
    named = {n: np.asarray(p) for n, p in ref_flatten(params)[0]}
    assert named["embed"].dtype.name == "bfloat16"
    tree = params_from_numpy(named)
    for n, p in flatten_with_names(tree)[0]:
        assert p.dtype == torch.bfloat16, n
        want = np.asarray(dict(ref_flatten(params)[0])[n].astype(jnp.float32))
        np.testing.assert_array_equal(p.float().numpy(), want, err_msg=n)


# -------------------------------------------------------------------- serve
def _ref_prefill(mesh, ref_cfg, params, toks, last_pos=None):
    return _jax_run(mesh, lambda p, t: ref_tf.prefill(p, t, ref_cfg, last_pos=last_pos),
                    params, jnp.asarray(toks))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_prefill_matches_reference(smoke_mesh, name, use_flash):
    ref_cfg, cfg = CFGS[name]
    cfg = dataclasses.replace(cfg, use_flash=use_flash)
    params, tree = _weights(ref_cfg)
    toks = _tokens(2, 24, cfg.vocab)
    want_logits, want_cache = _ref_prefill(smoke_mesh, ref_cfg, params, toks)
    logits, cache = tf.prefill(tree, torch.from_numpy(toks), cfg)
    _close(logits, want_logits, "logits")
    for n in ("k", "v"):
        assert cache[n].shape == want_cache[n].shape
        _close(cache[n], want_cache[n], n)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_prefill_last_pos_matches_reference(smoke_mesh, name):
    ref_cfg, cfg = CFGS[name]
    params, tree = _weights(ref_cfg, seed=1)
    toks = _tokens(1, 16, cfg.vocab, seed=1)
    toks[0, 11:] = 0                              # a right-padded bucket
    want, _ = _ref_prefill(smoke_mesh, ref_cfg, params, toks, last_pos=10)
    got, _ = tf.prefill(tree, torch.from_numpy(toks), cfg, last_pos=10)
    _close(got, want)
    if cfg.moe is None:
        # (MoE: an expert's capacity follows the token count, so the
        # padding's tokens take slots; in the reference too)
        exact, _ = tf.prefill(tree, torch.from_numpy(toks[:, :11]), cfg)
        _close(got, exact, "bucketed prefill == exact-length prefill")


@pytest.mark.parametrize("name", sorted(CFGS))
def test_decode_step_matches_reference(smoke_mesh, name):
    ref_cfg, cfg = CFGS[name]
    params, tree = _weights(ref_cfg, seed=2)
    B, S, max_len = 2, 10, 20
    toks = _tokens(B, S, cfg.vocab, seed=2)
    _, rcache = _ref_prefill(smoke_mesh, ref_cfg, params, toks)
    rcache = jax.tree.map(
        lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, max_len - S), (0, 0), (0, 0))), rcache)
    _, cache = tf.prefill(tree, torch.from_numpy(toks), cfg)
    cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, max_len - S))
             for n, c in cache.items()}
    feed = _tokens(4, B, cfg.vocab, seed=3)
    for step in range(4):
        pos = S + step
        want, rcache = _jax_run(
            smoke_mesh, lambda p, c, t: ref_tf.decode_step(p, c, t, pos, ref_cfg),
            params, rcache, jnp.asarray(feed[step]))
        got, cache2 = tf.decode_step(tree, cache, torch.from_numpy(feed[step]), pos, cfg)
        assert cache2 is cache                    # written in place
        _close(got, want, f"logits, step {step}")
        for n in ("k", "v"):
            _close(cache[n], rcache[n], f"{n}, step {step}")


@pytest.mark.parametrize("name", sorted(CFGS))
def test_decode_step_paged_matches_reference(smoke_mesh, name):
    ref_cfg, cfg = CFGS[name]
    params, tree = _weights(ref_cfg, seed=3)
    rng = np.random.default_rng(5)
    L, nb, bs, W, MB = cfg.n_self, 9, 4, 3, 2
    shape = (L, nb, bs, cfg.kv_heads, cfg.hd)
    pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    tables = np.array([[3, 5], [1, 8], [0, 0]], np.int32)   # slot 2: scratch
    positions = np.array([2, 4, 0], np.int32)
    rk, rv = (jnp.asarray(p) for p in pools)
    pk, pv = (torch.from_numpy(p.copy()) for p in pools)
    for step in range(4):
        toks = rng.integers(1, cfg.vocab, W).astype(np.int32)
        want, rk, rv = _jax_run(
            smoke_mesh,
            lambda p, a, b, tb, t, ps: ref_tf.decode_step_paged(p, a, b, tb, t, ps, ref_cfg),
            params, rk, rv, jnp.asarray(tables), jnp.asarray(toks),
            jnp.asarray(positions))
        got, pk2, pv2 = tf.decode_step_paged(
            tree, pk, pv, torch.from_numpy(tables), torch.from_numpy(toks),
            torch.from_numpy(positions), cfg)
        assert pk2 is pk and pv2 is pv            # written in place
        _close(got, want, f"logits, step {step}")
        _close(pk, rk, f"pool k, step {step}")
        _close(pv, rv, f"pool v, step {step}")
        positions[:2] += 1


@pytest.mark.parametrize("over", [
    dict(moe=MoECfg(num_experts=4, top_k=2, d_expert=16)), dict(cross_attn_every=1),
    dict(fsdp=True), dict(tp=2)])
def test_unported_features_raise(over):
    """The serve functions at tp > 1 need the rank's ``ModelAxis`` and
    raise without one (``models/common.py::_check_axis``; on several
    ranks in tests/test_torch_serve_tp.py); FSDP's storage needs the mesh
    and the rank to keep its dp shards, and on a mesh of one rank serves
    as the tree it is.  The engines refuse a cross-attention config (they
    take no images, as the reference's engines take none) and so does
    paged decode.  An MoE FFN replaces the dense one (f32 router)."""
    from repro_torch.launch.mesh import make_smoke_mesh

    cfg = dataclasses.replace(qwen3_smoke(), **over)
    toks = torch.zeros((1, 5), dtype=torch.long)
    if cfg.tp != 1:
        params = tf.init_params(cfg, device="meta")
        pool = torch.empty((cfg.n_self, 2, 4, cfg.layout.kv_local, cfg.hd), device="meta")
        tables = torch.zeros((1, 2), dtype=torch.int32)
        for call in (lambda: tf.prefill(params, toks, cfg),
                     lambda: tf.decode_step(params, tf.make_cache(cfg, 1, 8, "meta"),
                                            toks[:, 0], 5, cfg),
                     lambda: tf.decode_step_paged(params, pool, pool, tables, toks[:, 0],
                                                  toks[:, 0], cfg)):
            with pytest.raises(ValueError, match="pass the rank's ModelAxis"):
                call()
        return
    if cfg.fsdp:
        with pytest.raises(ValueError, match="pass the mesh"):
            tf.init_params(cfg, device="cpu")
        assert tf.param_rules(cfg).spec("blocks/wq") == (None, "data", "model")
        params = tf.init_params(cfg, device="cpu", mesh=make_smoke_mesh(1, 1), rank=0)
        want = tf.prefill(tf.init_params(qwen3_smoke(), device="cpu"), toks, qwen3_smoke())
        got = tf.prefill(params, toks, cfg)
        assert torch.equal(got[0], want[0])
        return
    if cfg.moe is not None:
        params = tf.init_params(cfg, device="cpu")
        blocks = params["blocks"]
        assert "wg" not in blocks and blocks["router"].dtype == torch.float32
        assert blocks["w_gate"].shape == (2, 4, 64, 16)
        logits, _ = tf.prefill(params, toks, cfg)
        assert logits.shape == (1, cfg.vocab) and torch.isfinite(logits).all()
        return
    from repro_torch.runtime import Server

    params = tf.init_params(cfg, device="cpu")
    assert cfg.n_cross == 1 and params["cross_blocks"]["gate_attn"].shape == (1,)
    with pytest.raises(ValueError, match="the engines take no images"):
        Server(cfg, make_smoke_mesh(1, 1), params, max_len=16)
    img = torch.zeros((1, 3, cfg.d_model))
    logits, _ = tf.prefill(params, toks, cfg, img_embeds=img)
    assert logits.shape == (1, cfg.vocab) and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="paged decode serves decoder-only"):
        tf.decode_step_paged(params, None, None, None, toks[:, 0], toks[:, 0], cfg)


def test_registry_serves_transformer():
    api = family_of(qwen3_smoke())
    assert api.family == "transformer"
    assert api.prefill is tf.prefill and api.decode_paged is tf.decode_step_paged
    assert api.train_forward is tf.train_forward and api.module is tf.Transformer
    cache = api.make_decode_state(qwen3_smoke(), 2, 12, "cpu")
    assert cache["k"].shape == (2, 2, 12, 2, 16)


@pytest.mark.parametrize("hook", ["init_params", "api.init", "make_cache",
                                  "api.make_decode_state", "resnet.init_params"])
def test_hooks_default_to_cuda(hook):
    """Entry points run on CUDA unless the caller asks for the CPU: with
    no card the default raises, it never serves on the CPU unasked."""
    from repro_torch.configs.resnet50_cifar import make_smoke as resnet_smoke
    from repro_torch.models import resnet

    cfg = qwen3_smoke()
    call = {"init_params": lambda: tf.init_params(cfg),
            "api.init": lambda: family_of(cfg).init(cfg),
            "make_cache": lambda: tf.make_cache(cfg, 1, 8),
            "api.make_decode_state": lambda: family_of(cfg).make_decode_state(cfg, 1, 8),
            "resnet.init_params": lambda: resnet.init_params(resnet_smoke())}[hook]
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for _, t in flatten_with_names(call())[0])
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
