"""The port's RWKV-6 against the JAX package's, with the reference's
weights carried over by name (``params_from_numpy``).

The reference initialises the mix coefficients, the LoRA up-projections
and the bonus u to 0 (and w0 to −5), which would leave those terms out
of every block; the tests perturb them first with the port's
``perturb_constant_leaves`` (the same offsets ``chip_smoke.py`` gives the
full-width model) and hand the perturbed weights to both sides.  The JAX
side runs inside ``shard_map`` on the one-device smoke mesh, as its own
serving runtime runs it.  Everything is f32: prefill and decode logits
and states are held to 1e-4, the same math summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.rwkv6_7b import make_config as ref_make_config
from repro.configs.rwkv6_7b import make_smoke as ref_rwkv_smoke
from repro.models import rwkv as ref_rwkv
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.configs import get_arch, param_structs
from repro_torch.configs.rwkv6_7b import make_config, make_smoke
from repro_torch.kernels.rwkv6 import kernel
from repro_torch.models import rwkv
from repro_torch.models.registry import family_of
from repro_torch.utils.convert import params_from_numpy, tensor_from_numpy
from repro_torch.utils.trees import flatten_with_names

TOL = dict(atol=1e-4, rtol=1e-4)
CONSTANT_LEAVES = {"ln1": 1.0, "ln2": 1.0, "mu_x": 0.0, "mu_rkvwg": 0.0,
                   "lora_mix_b": 0.0, "w0": -5.0, "lora_w_b": 0.0, "u": 0.0,
                   "ln_x": 1.0, "mu_ck": 0.0, "mu_cr": 0.0}


def perturbed_pair(ref_cfg, seed=1):
    """The reference's weights with the constant leaves perturbed, as a
    JAX tree and as the port's tree (the same values)."""
    params = ref_rwkv.init_params(jax.random.PRNGKey(0), ref_cfg)
    named, treedef = ref_flatten(params)
    tree = params_from_numpy({n: np.asarray(p) for n, p in named})
    rwkv.perturb_constant_leaves(tree, seed=seed)
    port = dict(flatten_with_names(tree)[0])
    leaves = [jnp.asarray(port[n].numpy()) for n, _ in named]
    return jax.tree_util.tree_unflatten(treedef, leaves), tree


@pytest.fixture(scope="module")
def smoke():
    ref_cfg = ref_rwkv_smoke()
    jparams, params = perturbed_pair(ref_cfg)
    return ref_cfg, make_smoke(), jparams, params


def _jax_run(mesh, fn, *args):
    """``fn(*args)`` inside a jitted one-device ``shard_map``, every input
    and output replicated."""
    f = jax.shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                      out_specs=P(), check_vma=False)
    return jax.jit(f)(*args)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _tokens(B, S, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, (B, S)).astype(np.int32)


# ----------------------------------------------------------------- params
def test_init_params_match_reference_tree(smoke):
    ref_cfg, cfg, _, _ = smoke
    want = ref_flatten(ref_rwkv.init_params(jax.random.PRNGKey(0), ref_cfg))[0]
    got = flatten_with_names(rwkv.init_params(cfg, seed=0, device="cpu"))[0]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, n
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), n
        leaf = n.split("/")[-1]
        if leaf in CONSTANT_LEAVES:
            assert torch.all(g == CONSTANT_LEAVES[leaf]), n
            np.testing.assert_array_equal(np.asarray(w), CONSTANT_LEAVES[leaf])


def test_full_config_matches_reference_shapes():
    """RWKV-6 7B at tp=1: the reference's leaves, 7,576,621,056 params in
    15,153,766,400 bytes (bf16, with w0 and u in f32)."""
    want = ref_flatten(jax.eval_shape(
        lambda: ref_rwkv.init_params(jax.random.PRNGKey(0), ref_make_config(tp=1))))[0]
    got = flatten_with_names(param_structs(make_config()))[0]
    assert [(n, tuple(g.shape)) for n, g in got] == [(n, w.shape) for n, w in want]
    assert sum(g.numel() for _, g in got) == 7_576_621_056
    assert sum(g.numel() * g.element_size() for _, g in got) == 15_153_766_400
    f32 = {n for n, g in got if g.dtype == torch.float32}
    assert f32 == {"blocks/u", "blocks/w0"}


def test_params_from_numpy_keeps_f32_leaves(smoke):
    """bf16 weights convert bit for bit beside the f32 w0 and u."""
    cfg = ref_rwkv_smoke()
    import dataclasses
    params = ref_rwkv.init_params(jax.random.PRNGKey(0),
                                  dataclasses.replace(cfg, dtype=jnp.bfloat16))
    named = {n: np.asarray(p) for n, p in ref_flatten(params)[0]}
    tree = dict(flatten_with_names(params_from_numpy(named))[0])
    for n, a in named.items():
        assert tree[n].dtype == (torch.float32 if n in ("blocks/u", "blocks/w0")
                                 else torch.bfloat16), n
        np.testing.assert_array_equal(tree[n].float().numpy(), a.astype(np.float32))


def test_perturb_constant_leaves_touches_only_constants(smoke):
    _, cfg, _, _ = smoke
    base = rwkv.init_params(cfg, seed=0, device="cpu")
    before = {n: t.clone() for n, t in flatten_with_names(base)[0]}
    rwkv.perturb_constant_leaves(base, seed=1)
    for n, t in flatten_with_names(base)[0]:
        moved = not torch.equal(t, before[n])
        assert moved == (n.split("/")[-1] in rwkv.CONSTANT_LEAF_OFFSETS), n
    again = rwkv.perturb_constant_leaves(rwkv.init_params(cfg, seed=0, device="cpu"),
                                         seed=1)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten_with_names(base)[0], flatten_with_names(again)[0]))


def test_registry_resolves_rwkv():
    api = family_of(make_smoke())
    assert api.family == "rwkv" and get_arch("rwkv6-7b").family == "rwkv"
    assert api.decode_paged is None and api.seq_cache_leaves == ()
    state = api.make_decode_state(make_smoke(), 3, 64, "cpu")
    assert {n: tuple(t.shape) for n, t in state.items()} == {
        "wkv": (2, 3, 4, 16, 16), "tm": (2, 3, 64), "cm": (2, 3, 64)}


def test_tensor_parallel_config_raises():
    """rwkv serves at tp > 1 on the rank's shards with its ``ModelAxis``
    (tests/test_torch_serve_tp.py); without one the serve functions raise,
    and the decode state is the rank's: its heads of the WKV state."""
    cfg = make_config(tp=4)
    params = rwkv.init_params(cfg, device="meta")
    assert params["blocks"]["wr"].shape == (32, 4096, 4096)    # the global tree
    toks = torch.zeros((1, 3), dtype=torch.long)
    with pytest.raises(ValueError, match="tp=4 but the model axis has extent 1"):
        rwkv.prefill(params, toks, cfg)
    state = rwkv.make_state(cfg, 1, "meta")
    assert state["wkv"].shape == (32, 1, 16, 64, 64) and state["tm"].shape == (32, 1, 4096)
    with pytest.raises(ValueError, match="pass the rank's ModelAxis"):
        rwkv.decode_step(params, state, toks[:, 0], 0, cfg)


# ----------------------------------------------------------------- pieces
@pytest.mark.parametrize("S,with_last", [(6, False), (6, True), (1, True)])
def test_token_shift_matches_reference(S, with_last):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, S, 8)).astype(np.float32)
    last = rng.standard_normal((2, 8)).astype(np.float32) if with_last else None
    want = ref_rwkv._token_shift(jnp.asarray(x), None if last is None
                                 else jnp.asarray(last))
    got = rwkv._token_shift(torch.from_numpy(x), None if last is None
                            else torch.from_numpy(last))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ddlerp_and_decay_match_reference(smoke):
    _, _, jparams, params = smoke
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    p = rwkv._layer(params, 0)
    rng = np.random.default_rng(5)
    x, xx = (rng.standard_normal((2, 5, 64)).astype(np.float32) for _ in range(2))
    mixed = rwkv._ddlerp(p, torch.from_numpy(x), torch.from_numpy(xx))
    _close(mixed, ref_rwkv._ddlerp(jp, jnp.asarray(x), jnp.asarray(xx)), atol=1e-5,
           rtol=1e-5)
    # large inputs reach both sides of the clip of w0 + lora
    xw = torch.from_numpy(x[:, :, :] * 40.0)
    _close(rwkv._decay(p, xw), ref_rwkv._decay(jp, jnp.asarray(xw.numpy()),
                                               lambda t: t), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("B,S", [(2, 5), (2, 16), (1, 37)])
def test_prefill_matches_reference(smoke, smoke_mesh, B, S):
    ref_cfg, cfg, jparams, params = smoke
    toks = _tokens(B, S, cfg.vocab, seed=S)
    want_logits, want_state = _jax_run(
        smoke_mesh, lambda p, t: ref_rwkv.prefill(p, t, ref_cfg), jparams,
        jnp.asarray(toks))
    before = kernel.WKV_LAUNCHES
    logits, state = rwkv.prefill(params, torch.from_numpy(toks), cfg)
    assert kernel.WKV_LAUNCHES == before            # CPU: the plain version
    assert logits.shape == (B, cfg.vocab)
    _close(logits, want_logits)
    for n in ("wkv", "tm", "cm"):
        assert tuple(state[n].shape) == want_state[n].shape, n
        _close(state[n], want_state[n])


def test_decode_steps_match_reference(smoke, smoke_mesh):
    """Three decode steps from the reference's prefill state, carried over:
    logits and state after each step."""
    ref_cfg, cfg, jparams, params = smoke
    toks = _tokens(2, 12, cfg.vocab, seed=7)
    _, jstate = _jax_run(smoke_mesh, lambda p, t: ref_rwkv.prefill(p, t, ref_cfg),
                         jparams, jnp.asarray(toks))
    state = {n: tensor_from_numpy(np.asarray(a)) for n, a in jstate.items()}
    rng = np.random.default_rng(8)
    for pos in range(12, 15):
        tok = rng.integers(1, cfg.vocab, (2,)).astype(np.int32)
        want, jstate = _jax_run(
            smoke_mesh, lambda p, s, t: ref_rwkv.decode_step(p, s, t, pos, ref_cfg),
            jparams, jstate, jnp.asarray(tok))
        got, state = rwkv.decode_step(params, state, torch.from_numpy(tok), pos, cfg)
        _close(got, want)
        for n in ("wkv", "tm", "cm"):
            _close(state[n], jstate[n])


def test_decode_after_prefill_matches_longer_prefill(smoke):
    """Prefill of S − 2 tokens and two decode steps give the logits of a
    prefill of all S (``tests/test_serve_families.py``'s check and
    tolerance, 2e-3), here within the port."""
    _, cfg, _, params = smoke
    toks = torch.from_numpy(_tokens(2, 32, cfg.vocab))
    want, _ = rwkv.prefill(params, toks, cfg)
    _, state = rwkv.prefill(params, toks[:, :30], cfg)
    _, state = rwkv.decode_step(params, state, toks[:, 30], 30, cfg)
    got, _ = rwkv.decode_step(params, state, toks[:, 31], 31, cfg)
    _close(got, want, atol=2e-3, rtol=2e-3)
