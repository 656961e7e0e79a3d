"""The port's Mamba-2 / Zamba2 hybrid (``models/ssm.py``) against the JAX
package's, on the CPU, with the reference's weights carried over by name.

At init every SSM head has the same decay and skip (``A_log`` and
``dt_bias`` 0, ``D`` 1) and the norms are 1, so a wrong head shard would
not show: the tests perturb those leaves first with the port's
``perturb_constant_leaves`` and hand the perturbed weights to both sides.
Everything is f32.  Held to the reference:

  - the config (the full model's 2,422,386,848 params, the smoke tree's
    names, shapes, dtypes and constants) and the sharding rules;
  - the causal conv with and without its state, bit for bit;
  - ``ssd_chunked``'s values and gradients against ``jax.grad`` (S a
    multiple of the chunk and not, a nonzero initial state): within 1e-5
    of each input's largest gradient; and the masked exponent: where a
    chunk's decay sum passes 88.7 the reference's gradient is NaN and the
    port's is finite, within 1e-5 of the reference's float64 gradients;
  - ``mamba_block`` (with and without its states) and
    ``shared_attn_block`` (causal, and decode against the ring), and each
    block's gradients;
  - ``train_forward``'s loss and every leaf's gradient against JAX's
    ``value_and_grad`` inside ``shard_map`` on the one-device smoke mesh:
    the smoke config (4 layers, one attention site) and a 7-layer one at
    ``attn_every=2`` (4 groups, the last of one layer): the loss to rtol
    1e-5, the gradients within ``MODEL_GRAD_TOL`` of each leaf's largest
    in the reference's float64 run.

The float64 runs (``reference_in_float64``) are the reference's own code
with its f32 casts taken to f64; they are the oracle where f32 cannot be:
a Mamba block's f32 gradients are ill-conditioned, and a test witnesses
how far the reference's own f32 gradients sit from its float64 ones.
  - prefill, decode steps, the decode-vs-prefill hand-off, the ring
    window (``attn_window`` < S, S % w ≠ 0, decode past the window) and
    the static engine's greedy tokens against the reference ``Server``.

The reference's ``Server._pad_cache`` pads every cache leaf whose dim 2
equals the prompt length: for this family the conv state at prompt
length d_conv − 1 = 3 and the SSM state at prompt length ``heads_local``
(8 in the smoke config).  A test confirms it; the compared prompt lengths
stay off those values.  The multi-rank cases run on the tensor-parallel
spawns of ``tests/test_torch_tp.py``.
"""
import contextlib
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

from repro.configs.zamba2_2_7b import make_config as ref_make_config
from repro.configs.zamba2_2_7b import make_smoke as ref_make_smoke
from repro.data import TokenPipeline as RefTokenPipeline
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import ssm as ref_ssm
from repro.runtime.serve_loop import Server as RefServer
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.configs import get_arch, param_structs
from repro_torch.configs.zamba2_2_7b import make_config, make_smoke
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import ssm
from repro_torch.models.registry import family_of
from repro_torch.parallel.sharding import reduce_axes_tree
from repro_torch.runtime import Server
from repro_torch.utils.convert import params_from_numpy, tensor_from_numpy
from repro_torch.utils.trees import flatten_with_names

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-5
SEQ, BATCH = 40, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSTANT_LEAVES = {"ln": 1.0, "A_log": 0.0, "D": 1.0, "dt_bias": 0.0, "ln_y": 1.0}


def perturbed_pair(ref_cfg, seed=1):
    """The reference's weights with the constant leaves perturbed, as a
    JAX tree and as the port's tree (the same values)."""
    params = ref_ssm.init_params(jax.random.PRNGKey(0), ref_cfg)
    named, treedef = ref_flatten(params)
    tree = ssm.perturb_constant_leaves(
        params_from_numpy({n: np.asarray(p) for n, p in named}), seed=seed)
    port = dict(flatten_with_names(tree)[0])
    leaves = [jnp.asarray(port[n].numpy()) for n, _ in named]
    return jax.tree_util.tree_unflatten(treedef, leaves), tree


@pytest.fixture(scope="module")
def smoke():
    ref_cfg = ref_make_smoke()
    jparams, params = perturbed_pair(ref_cfg)
    return ref_cfg, make_smoke(), jparams, params


def _jax_run(mesh, fn, *args):
    f = jax.shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                      out_specs=P(), check_vma=False)
    return jax.jit(f)(*args)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(np.int32)


def _rel(got, want):
    """max |got − want| over the largest |want|."""
    want = np.asarray(want, np.float64)
    return np.max(np.abs(_np(got).astype(np.float64) - want)) / np.max(np.abs(want))


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def reference_in_float64():
    """The reference in float64: x64 on, and the ``jnp`` of the modules on
    its path (``ssm``, ``common``, ``attention``) read with ``float32`` as
    float64, so that its own f32 casts give f64."""
    mods = (ref_ssm, ref_common, ref_attention)
    saved = [m.jnp for m in mods]
    with jax.enable_x64(True):
        for m in mods:
            m.jnp = _Float64Numpy()
        try:
            yield
        finally:
            for m, j in zip(mods, saved):
                m.jnp = j


def _float64(fn, *args):
    """``fn(*args)`` jitted in ``reference_in_float64``, every float input
    as f64; asserts that no f32 value is left in its trace.  Returns numpy
    trees."""
    with reference_in_float64():
        args = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                            if np.issubdtype(np.asarray(a).dtype, np.floating)
                            else jnp.asarray(a), args)
        assert "f32" not in str(jax.make_jaxpr(fn)(*args))
        return jax.tree.map(np.asarray, jax.jit(fn)(*args))


# ------------------------------------------------------------- config
def test_full_config_param_count_matches_reference():
    """zamba2-2.7b at tp = 1: the reference's leaves and shapes, 2,422,386,848
    params (39,882,992 a Mamba layer, 104,862,720 in the shared block,
    163,840,000 in the embedding and the head)."""
    want = ref_flatten(jax.eval_shape(
        lambda: ref_ssm.init_params(jax.random.PRNGKey(0), ref_make_config(tp=1))))[0]
    got = flatten_with_names(param_structs(make_config()))[0]
    assert [(n, tuple(g.shape)) for n, g in got] == [(n, w.shape) for n, w in want]
    count = {n: g.numel() for n, g in got}
    assert sum(count.values()) == sum(int(np.prod(w.shape)) for _, w in want) == 2_422_386_848
    assert sum(v for n, v in count.items() if n.startswith("blocks/")) == 54 * 39_882_992
    assert sum(v for n, v in count.items() if n.startswith("shared_attn/")) == 104_862_720
    assert count["embed"] + count["lm_head"] == 163_840_000
    assert {n for n, g in got if g.dtype == torch.float32} == {
        "blocks/A_log", "blocks/D", "blocks/dt_bias"}
    assert get_arch("zamba2-2.7b").layer_pair == (6, 12, 6)


def test_init_params_match_reference_tree(smoke):
    ref_cfg, cfg, _, _ = smoke
    want = ref_flatten(ref_ssm.init_params(jax.random.PRNGKey(0), ref_cfg))[0]
    got = flatten_with_names(ssm.init_params(cfg, seed=0, device="cpu"))[0]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, n
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), n
        leaf = n.split("/")[-1]
        if n.startswith("blocks/") and leaf in CONSTANT_LEAVES:
            assert torch.all(g == CONSTANT_LEAVES[leaf]), n
            np.testing.assert_array_equal(np.asarray(w), CONSTANT_LEAVES[leaf])


def test_perturb_constant_leaves_touches_only_constants(smoke):
    _, cfg, _, _ = smoke
    base = ssm.init_params(cfg, seed=0, device="cpu")
    before = {n: t.clone() for n, t in flatten_with_names(base)[0]}
    ssm.perturb_constant_leaves(base, seed=1)
    for n, t in flatten_with_names(base)[0]:
        moved = not torch.equal(t, before[n])
        assert moved == (n.startswith("blocks/") and
                         n.split("/")[-1] in ssm.CONSTANT_LEAF_OFFSETS), n


@pytest.mark.parametrize("tp,kv_heads", [(4, 32), (4, 2), (16, 32), (64, 32)])
def test_rules_match_reference(tp, kv_heads):
    """The specs of every leaf at tp > 1, with the kv heads sharded (kv ≥ tp)
    and sliced from the replicated wk/wv (kv < tp)."""
    ref_cfg = ref_make_config(tp=tp, kv_heads=kv_heads)
    cfg = make_config(tp=tp, kv_heads=kv_heads)
    ref_rules, rules = ref_ssm.param_rules(ref_cfg), ssm.param_rules(cfg)
    names = [n for n, _ in flatten_with_names(ssm.init_params(cfg, device="meta"))[0]]
    for n in names:
        assert rules.spec(n) == tuple(ref_rules.spec(n)), n
    assert ssm.in_scan_param_names(ssm.init_params(cfg, device="meta")) == frozenset(
        n for n in names if n.startswith("blocks/"))


# ------------------------------------------------------------- pieces
@pytest.mark.parametrize("S,with_state", [(9, False), (9, True), (1, True), (2, False)])
def test_causal_conv_matches_reference(S, with_state):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    want, want_st = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                         None if st is None else jnp.asarray(st))
    got, got_st = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                   None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))


def _ssd_inputs(B, S, H, Pd, N, seed, nonzero_state, decay=1.0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xh = rng.standard_normal((B, S, H, Pd)).astype(f32)
    Bi, Ci = (rng.standard_normal((B, S, N)).astype(f32) for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f32)
    loga = (-np.exp(rng.standard_normal((1, 1, H)) * 0.5) * decay * dt).astype(f32)
    state = ((rng.standard_normal((B, H, Pd, N)) * 0.3).astype(f32) if nonzero_state
             else np.zeros((B, H, Pd, N), f32))
    gy = rng.standard_normal((B, S, H, Pd)).astype(f32)
    gs = rng.standard_normal((B, H, Pd, N)).astype(f32)
    return (xh, Bi, Ci, loga, dt, state), gy, gs


@pytest.mark.parametrize("S,chunk", [(32, 8), (37, 8), (5, 16)])
@pytest.mark.parametrize("nonzero_state", [False, True])
def test_ssd_values_and_gradients_match_reference(S, chunk, nonzero_state):
    ins, gy, gs = _ssd_inputs(2, S, 3, 4, 5, seed=S, nonzero_state=nonzero_state)

    def objective(*a):
        y, st = ref_ssm.ssd_chunked(*a, chunk)
        return jnp.sum(y * gy) + jnp.sum(st * gs)

    jins = tuple(map(jnp.asarray, ins))
    want_y, want_st = ref_ssm.ssd_chunked(*jins, chunk)
    want = jax.grad(objective, argnums=tuple(range(6)))(*jins)
    t = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, st = ssm.ssd_chunked(*t, chunk)
    _close(y, want_y, atol=1e-5, rtol=1e-5)
    _close(st, want_st, atol=1e-5, rtol=1e-5)
    ((y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gs)).sum()).backward()
    for name, a, w in zip(("x", "B", "C", "loga", "dt", "state"), t, want):
        w = np.asarray(w)
        assert np.max(np.abs(a.grad.numpy() - w)) <= GRAD_TOL * np.max(np.abs(w)), name


def test_ssd_masked_exponent_keeps_the_gradient_finite():
    """A chunk whose decay sum passes 88.7: above the diagonal the
    reference's exp(Lc_t − Lc_s) overflows to inf, masked to 0 in the
    forward, and its f32 gradient is 0·inf = NaN.  The port masks the
    exponent (−inf, so exp is 0 with a zero gradient): the same values, and
    f32 gradients within 1e-5 of each input's largest in the reference's
    float64 run (where exp(90) does not overflow)."""
    ins, gy, gs = _ssd_inputs(1, 16, 2, 4, 3, seed=5, nonzero_state=True, decay=12.0)
    Lsum = -ins[3][0].sum(axis=0)
    assert Lsum.max() > 88.7                       # exp(88.7) is past f32's largest

    def objective(gy, gs, *a):
        y, st = ref_ssm.ssd_chunked(*a, 16)
        return jnp.sum(y * gy) + jnp.sum(st * gs)

    grad = jax.grad(objective, argnums=tuple(range(2, 8)))
    jins = tuple(map(jnp.asarray, ins))
    ref_grads = grad(jnp.asarray(gy), jnp.asarray(gs), *jins)
    assert np.isnan(np.asarray(ref_grads[3])).any()        # the reference's fault
    want = _float64(grad, gy, gs, *ins)
    assert all(np.isfinite(w).all() for w in want)
    t = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, st = ssm.ssd_chunked(*t, 16)
    want_y, want_st = ref_ssm.ssd_chunked(*jins, 16)
    _close(y, want_y, atol=1e-5, rtol=1e-5)
    _close(st, want_st, atol=1e-5, rtol=1e-5)
    ((y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gs)).sum()).backward()
    for name, a, w in zip(("x", "B", "C", "loga", "dt", "state"), t, want):
        assert torch.isfinite(a.grad).all(), name
        assert _rel(a.grad, w) <= GRAD_TOL, name


@pytest.mark.parametrize("S,with_state", [(20, False), (20, True), (1, True)])
def test_mamba_block_matches_reference(smoke, S, with_state):
    ref_cfg, cfg, jparams, params = smoke
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"])
    p = ssm._layer(params, 1)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    st = cv = None
    if with_state:
        st = (rng.standard_normal((2, 8, 16, 16)) * 0.3).astype(np.float32)
        cv = rng.standard_normal((2, 3, 160)).astype(np.float32)
    want = jax.jit(lambda q, xx, *s: ref_ssm.mamba_block(q, xx, ref_cfg, *s))(
        jp, jnp.asarray(x), *(() if st is None else (jnp.asarray(st), jnp.asarray(cv))))
    got = ssm.mamba_block(p, torch.from_numpy(x), cfg,
                          None if st is None else torch.from_numpy(st),
                          None if cv is None else torch.from_numpy(cv))
    for name, g, w in zip(("x", "ssm state", "conv state"), got, want):
        _close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("block", ["mamba", "shared_attn"])
def test_block_gradients_match_reference(smoke, block):
    """One block's gradients (every parameter and the input) under a random
    cotangent: the port's f32 ones within ``MODEL_GRAD_TOL["block"]`` of
    each one's largest in the reference's float64 run, and the reference's
    own f32 ones too (its f32 is that far from float64 itself)."""
    ref_cfg, cfg, jparams, params = smoke
    rng = np.random.default_rng(6)
    S = 40
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    gy = rng.standard_normal((2, S, 64)).astype(np.float32)
    if block == "mamba":
        jp = jax.tree.map(lambda a: a[1], jparams["blocks"])
        p = {n: t.clone() for n, t in ssm._layer(params, 1).items()}
        ref_fn = lambda q, xx, c: ref_ssm.mamba_block(q, xx, c)[0]
        fn = lambda q, xx: ssm.mamba_block(q, xx, cfg)[0]
    else:
        jp, p = jparams["shared_attn"], {n: t.clone() for n, t in params["shared_attn"].items()}
        rope = ssm.rope_angles(torch.arange(S), cfg.hd, cfg.rope_theta)
        ref_fn = lambda q, xx, c: ref_ssm.shared_attn_block(
            q, xx, c, ref_common.rope_angles(jnp.arange(S), c.hd, c.rope_theta))[0]
        fn = lambda q, xx: ssm.shared_attn_block(q, xx, cfg, rope)[0]

    def grad(c):
        return jax.grad(lambda q, xx, g: jnp.sum(ref_fn(q, xx, c) * g), argnums=(0, 1))

    want32 = jax.jit(grad(ref_cfg))(jp, jnp.asarray(x), jnp.asarray(gy))
    want = _float64(grad(dataclasses.replace(ref_cfg, dtype=jnp.float64)), jp, x, gy)
    for t in p.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    (fn(p, tx) * torch.from_numpy(gy)).sum().backward()
    tol = MODEL_GRAD_TOL["block"]
    for n, g, w32, w in [(n, p[n].grad, want32[0][n], want[0][n]) for n in p] + [
            ("x", tx.grad, want32[1], want[1])]:
        assert _rel(g, w) <= tol and _rel(w32, w) <= tol, n


def test_shared_attn_block_matches_reference(smoke):
    """Causal self-attention over a prompt, then one decode step into a
    ring that has wrapped (pos ≥ Smax)."""
    ref_cfg, cfg, jparams, params = smoke
    rng = np.random.default_rng(3)
    S = 12
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    rope = ref_common.rope_angles(jnp.arange(S), ref_cfg.hd, ref_cfg.rope_theta)
    want, (wk, wv) = ref_ssm.shared_attn_block(jparams["shared_attn"], jnp.asarray(x),
                                               ref_cfg, rope)
    trope = ssm.rope_angles(torch.arange(S), cfg.hd, cfg.rope_theta)
    got, (k, v) = ssm.shared_attn_block(params["shared_attn"], torch.from_numpy(x), cfg,
                                        trope)
    for g, w in ((got, want), (k, wk), (v, wv)):
        _close(g, w, atol=1e-5, rtol=1e-5)
    kc, vc = (rng.standard_normal((2, 7, 4, 16)).astype(np.float32) for _ in range(2))
    x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
    pos = 23
    want, (wkc, wvc) = ref_ssm.shared_attn_block(
        jparams["shared_attn"], jnp.asarray(x1), ref_cfg,
        ref_common.rope_angles(jnp.array([pos]), ref_cfg.hd, ref_cfg.rope_theta),
        kv_cache=(jnp.asarray(kc), jnp.asarray(vc)), pos=pos)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, (gk, gv) = ssm.shared_attn_block(
        params["shared_attn"], torch.from_numpy(x1), cfg,
        ssm.rope_angles(torch.tensor([pos]), cfg.hd, cfg.rope_theta), kv_cache=(tk, tv),
        pos=pos)
    assert gk is tk and gv is tv                  # written in place
    for g, w in ((got, want), (gk, wkc), (gv, wvc)):
        _close(g, w, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- training
TRAIN_CFGS = {"smoke": {}, "7-layer": {"n_layers": 7}}
# A Mamba block's f32 gradients are ill-conditioned: the reference's own
# f32 gradients sit up to 4.3e-5 of a leaf's largest from its float64 run
# at the smoke config, 1.2e-3 at 7 layers and 1.5e-5 for one Mamba block
# (``test_reference_f32_is_this_far_from_float64``, and the block test),
# so GRAD_TOL is out of f32's reach there.  Each tolerance is 1.6 to 2.3
# times the reference's own distance; the port's f32 sits at 3.0e-5, 5.9e-4 and
# 1.3e-5.  ssd_chunked alone holds GRAD_TOL.
MODEL_GRAD_TOL = {"smoke": 1e-4, "7-layer": 2e-3, "block": 3e-5}


@pytest.fixture(scope="module", params=sorted(TRAIN_CFGS))
def reference_step(request, smoke_mesh):
    over = TRAIN_CFGS[request.param]
    tol = MODEL_GRAD_TOL[request.param]
    ref_cfg = dataclasses.replace(ref_make_smoke(), **over)
    jparams, tree = perturbed_pair(ref_cfg)
    batch = RefTokenPipeline(ref_cfg.vocab, SEQ, BATCH).batch_at(1)

    def run(cfg):
        vg = lambda p, b: jax.value_and_grad(lambda q: ref_ssm.train_forward(q, b, cfg))(p)
        specs = jax.tree.map(lambda _: P(), jparams)
        return jax.shard_map(vg, mesh=smoke_mesh, in_specs=(specs, {k: P() for k in batch}),
                             out_specs=(P(), specs), check_vma=False)

    loss32, grads32 = jax.jit(run(ref_cfg))(jparams, batch)
    loss, grads = _float64(run(dataclasses.replace(ref_cfg, dtype=jnp.float64)), jparams, batch)
    arrays = {n: t.numpy() for n, t in flatten_with_names(tree)[0]}
    flat = lambda g: {n: np.asarray(a) for n, a in ref_flatten(g)[0]}
    return over, tol, arrays, (float(loss32), flat(grads32)), (float(loss), flat(grads))


def test_reference_f32_is_this_far_from_float64(reference_step):
    """The witness for ``MODEL_GRAD_TOL``: the reference's own f32 loss and
    gradients against its float64 run.  Every gradient lies within the
    tolerance of its leaf's largest, and the farthest lies past GRAD_TOL
    (1e-5): no f32 implementation can be held to that here."""
    _, tol, _, (loss32, grads32), (loss, grads) = reference_step
    np.testing.assert_allclose(loss32, loss, rtol=1e-5)
    dist = {n: _rel(grads32[n], grads[n]) for n in grads}
    assert max(dist.values()) <= tol, dist
    assert max(dist.values()) > GRAD_TOL, dist


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_loss_and_grads_match_reference(reference_step, remat):
    """The smoke config (groups [2, 2]: one attention site) and 7 layers
    at attn_every 2 (groups [2, 2, 2, 1]: three sites, a remainder of one
    layer): the loss to rtol 1e-5 of the reference's f32 and float64
    runs, every gradient within ``MODEL_GRAD_TOL`` of its leaf's largest
    in the float64 run, under every remat policy."""
    over, tol, arrays, (loss32, _), (want_loss, want_grads) = reference_step
    cfg = dataclasses.replace(make_smoke(), remat=remat, **over)
    model = ssm.SSM(cfg, params_from_numpy(arrays, "cpu"))
    loss = model(TokenPipeline(cfg.vocab, SEQ, BATCH, device="cpu").batch_at(1))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss32, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    got = dict(flatten_with_names(model.params_tree())[0])
    assert list(got) == list(want_grads)
    for n, want in want_grads.items():
        assert np.max(np.abs(want)) > 0, f"{n} has no gradient"
        assert _rel(got[n].grad, want) <= tol, n


def test_registry_layer_sync_and_train_step(tmp_path):
    """The registry's hooks; the in-backward sync's slots at full width (2
    a layer at tp = 1: bf16 and f32; 3 at tp = 4: the replicated bf16
    leaves, the sharded bf16 leaves, the f32 ones); and one step through
    ``make_train_step`` under depcha on one CPU rank (the f32 smoke
    config: one slot a layer), whose gradients are the plain backward's."""
    import torch.distributed as dist

    from repro_torch.core import GradSyncConfig
    from repro_torch.launch.mesh import init_dist
    from repro_torch.optim import sgd
    from repro_torch.runtime import make_train_step

    api = family_of(make_smoke())
    assert api.family == "ssm" and api.module is ssm.SSM and api.decode_paged is None
    assert api.layer_sync is ssm.layer_sync and api.seq_cache_leaves == ("attn_k", "attn_v")
    state = api.make_decode_state(make_smoke(), 3, 64, "cpu")
    assert {n: tuple(t.shape) for n, t in state.items()} == {
        "ssm": (4, 3, 8, 16, 16), "conv": (4, 3, 3, 160), "attn_k": (1, 3, 64, 4, 16),
        "attn_v": (1, 3, 64, 4, 16)}
    assert api.make_decode_state(make_smoke(), 1, 10_000, "meta")["attn_k"].shape[2] == 4096
    init_dist("cpu", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        mesh = make_smoke_mesh(1)
        meta = ssm.init_params(make_config(), device="meta")
        ls = ssm.layer_sync(make_config(depcha_in_scan=True), meta, mesh, "cpu")
        assert sorted((ax, str(dt)) for _, ax, dt in ls.buckets) == [
            (("data",), "torch.bfloat16"), (("data",), "torch.float32")]
        # at tp = 4 (the groups LayerSync makes a slot each, without its
        # communicators, which need four ranks)
        meta4 = ssm.init_params(make_config(tp=4), device="meta")["blocks"]
        axes = reduce_axes_tree(ssm.param_rules(make_config(tp=4)), meta4, "blocks/",
                                ("data", "model"))
        slots = {}
        for (n, w), ax in zip(flatten_with_names(meta4)[0], axes):
            slots.setdefault((tuple(ax), str(w.dtype)), []).append(n)
        assert slots == {(("data", "model"), "torch.bfloat16"): ["conv_w", "ln", "w_in"],
                         (("data",), "torch.float32"): ["A_log", "D", "dt_bias"],
                         (("data",), "torch.bfloat16"): ["ln_y", "w_out"]}
        cfg = dataclasses.replace(make_smoke(), depcha_in_scan=True)
        model = ssm.SSM(cfg, ssm.perturb_constant_leaves(ssm.init_params(cfg, device="cpu")))
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy="depcha"), sgd(0.0),
                             model=model, clip_norm=0.0, device="cpu")
        assert set(ts.layer_sync.names) == api.in_scan_names(model.params_tree())
        batch = TokenPipeline(cfg.vocab, SEQ, BATCH, device="cpu").batch_at(0)
        ts.fn(model, ts.init_opt(), batch, 0)
        assert ts.layer_sync.collectives == cfg.n_layers
        got = {n: p.grad.clone() for n, p in flatten_with_names(model.params_tree())[0]}
        model.zero_grad(set_to_none=True)
        model(batch).backward()
        for n, p in flatten_with_names(model.params_tree())[0]:
            torch.testing.assert_close(got[n], p.grad, rtol=0, atol=0, msg=n)
    finally:
        dist.destroy_process_group()


def test_params_from_numpy_carries_the_ssm_tree():
    """The reference's weights (bf16, with ``A_log``, ``D`` and ``dt_bias``
    in f32, and ``shared_attn/*``) into the port: each leaf's dtype and
    bits at tp = 1; at data 1 × model 2 each rank's blocks put back
    together along the sharded dim are the whole leaf."""
    ref_cfg = dataclasses.replace(ref_make_smoke(), dtype=jnp.bfloat16, vocab=96)
    params = ref_ssm.init_params(jax.random.PRNGKey(3), ref_cfg)
    arrays = {n: np.asarray(p) for n, p in ref_flatten(params)[0]}
    whole = dict(flatten_with_names(params_from_numpy(arrays))[0])
    assert any(n.startswith("shared_attn/") for n in whole)
    for n, a in arrays.items():
        want = (torch.float32 if n.split("/")[-1] in ("A_log", "D", "dt_bias")
                else torch.bfloat16)
        assert whole[n].dtype == want, n
        np.testing.assert_array_equal(whole[n].float().numpy(), a.astype(np.float32),
                                      err_msg=n)
    cfg = dataclasses.replace(make_smoke(), tp=2, vocab=96)
    rules, mesh = ssm.param_rules(cfg), make_smoke_mesh(1, 2)
    ranks = [dict(flatten_with_names(params_from_numpy(arrays, mesh=mesh, rank=r,
                                                       rules=rules))[0]) for r in range(2)]
    for n, w in whole.items():
        spec = rules.spec(n)
        got = (torch.cat([rk[n] for rk in ranks], dim=spec.index("model"))
               if "model" in spec else ranks[1][n])
        assert got.dtype == w.dtype and torch.equal(got, w), n
    assert ranks[0]["blocks/A_log"].shape == (4, 4)
    assert ranks[0]["shared_attn/wk"].shape == (64, 32)


def test_launcher_trains_zamba2_on_cpu():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "zamba2-2.7b", "--smoke",
         "--device", "cpu", "--strategy", "depcha", "--steps", "2", "--seq", "24",
         "--batch", "2"], capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[train] zamba2-2.7b depcha: loss" in out.stdout


# ------------------------------------------------------------- serving
def test_tensor_parallel_serving_raises():
    """zamba2 serves at tp > 1 with the rank's ``ModelAxis``
    (tests/test_torch_serve_tp.py); without one the serve functions raise,
    and the decode state is the rank's: its SSM heads and kv heads, the
    whole conv state."""
    cfg = make_config(tp=4)
    params = ssm.init_params(cfg, device="meta")
    toks = torch.zeros((1, 3), dtype=torch.long)
    with pytest.raises(ValueError, match="tp=4 but the model axis has extent 1"):
        ssm.prefill(params, toks, cfg)
    state = ssm.make_state(cfg, 1, 8, "meta")
    assert state["ssm"].shape == (54, 1, 20, 64, 64)
    assert state["conv"].shape == (54, 1, 3, 5120 + 128)
    assert state["attn_k"].shape == (8, 1, 8, 8, 80)
    with pytest.raises(ValueError, match="pass the rank's ModelAxis"):
        ssm.decode_step(params, state, toks[:, 0], 0, cfg)


def _ref_prefill(mesh, jparams, ref_cfg, toks, window=0):
    return _jax_run(mesh, lambda p, t: ref_ssm.prefill(p, t, ref_cfg, attn_window=window),
                    jparams, jnp.asarray(toks))


def _ref_decoder(mesh, ref_cfg):
    """The reference's ``decode_step`` jitted once, the position traced."""
    f = jax.shard_map(lambda p, s, t, pos: ref_ssm.decode_step(p, s, t, pos, ref_cfg),
                      mesh=mesh, in_specs=(P(), P(), P(), P()), out_specs=P(),
                      check_vma=False)
    return jax.jit(f)


@pytest.mark.parametrize("B,S,window", [(2, 20, 0), (1, 37, 0), (2, 21, 32)])
def test_prefill_and_decode_match_reference(smoke, smoke_mesh, B, S, window):
    """Prefill logits and state, then 4 decode steps from the reference's
    state carried over: logits and state after each step."""
    ref_cfg, cfg, jparams, params = smoke
    toks = _tokens(B, S, cfg.vocab, seed=S)
    want, jstate = _ref_prefill(smoke_mesh, jparams, ref_cfg, toks, window)
    logits, state = ssm.prefill(params, torch.from_numpy(toks), cfg, attn_window=window)
    _close(logits, want)
    assert sorted(state) == sorted(jstate)
    for n in state:
        assert tuple(state[n].shape) == jstate[n].shape, n
        _close(state[n], jstate[n])
    state = {n: tensor_from_numpy(np.asarray(a)) for n, a in jstate.items()}
    rng = np.random.default_rng(8)
    decode = _ref_decoder(smoke_mesh, ref_cfg)
    for pos in range(S, S + 4):
        tok = rng.integers(1, cfg.vocab, (B,)).astype(np.int32)
        want, jstate = decode(jparams, jstate, jnp.asarray(tok), jnp.int32(pos))
        before = {n: t for n, t in state.items()}
        got, state = ssm.decode_step(params, state, torch.from_numpy(tok), pos, cfg)
        assert all(state[n] is before[n] for n in state)      # in place
        _close(got, want)
        for n in state:
            _close(state[n], jstate[n])


def test_ring_window_matches_reference(smoke, smoke_mesh):
    """attn_window 8 < S = 21 (21 % 8 = 5: the prefill's rows ring-aligned),
    then decode steps that wrap the ring twice."""
    ref_cfg, cfg, jparams, params = smoke
    S, w = 21, 8
    toks = _tokens(2, S, cfg.vocab, seed=4)
    want, jstate = _ref_prefill(smoke_mesh, jparams, ref_cfg, toks, w)
    logits, state = ssm.prefill(params, torch.from_numpy(toks), cfg, attn_window=w)
    _close(logits, want)
    for n in state:
        _close(state[n], jstate[n])
    rng = np.random.default_rng(9)
    decode = _ref_decoder(smoke_mesh, ref_cfg)
    for pos in range(S, S + 2 * w):
        tok = rng.integers(1, cfg.vocab, (2,)).astype(np.int32)
        want, jstate = decode(jparams, jstate, jnp.asarray(tok), jnp.int32(pos))
        got, state = ssm.decode_step(params, state, torch.from_numpy(tok), pos, cfg)
        _close(got, want)
    for n in state:
        _close(state[n], jstate[n])


def test_decode_after_prefill_matches_longer_prefill(smoke):
    """Prefill of S − 2 tokens with the ring sized for S, and two decode
    steps, give the logits of a prefill of all S
    (``tests/test_serve_families.py``'s check and tolerance, 2e-3), here
    within the port."""
    _, cfg, _, params = smoke
    S = 32
    toks = torch.from_numpy(_tokens(2, S, cfg.vocab))
    want, _ = ssm.prefill(params, toks, cfg, attn_window=S)
    _, state = ssm.prefill(params, toks[:, :S - 2], cfg, attn_window=S)
    _, state = ssm.decode_step(params, state, toks[:, S - 2], S - 2, cfg)
    got, _ = ssm.decode_step(params, state, toks[:, S - 1], S - 1, cfg)
    _close(got, want, atol=2e-3, rtol=2e-3)


@pytest.fixture(scope="module")
def servers(smoke, smoke_mesh):
    ref_cfg, cfg, jparams, params = smoke
    return (cfg, RefServer(ref_cfg, smoke_mesh, jparams, max_len=64),
            Server(cfg, make_smoke_mesh(1, 1), params, max_len=64))


# Prompt lengths stay off 3 (d_conv − 1) and 8 (heads_local): the
# reference's ``_pad_cache`` pads every leaf whose dim 2 equals them.
def test_static_greedy_matches_reference(servers):
    cfg, ref_srv, srv = servers
    prompts = np.random.default_rng(11).integers(1, cfg.vocab, (3, 23)).astype(np.int32)
    np.testing.assert_array_equal(srv.generate(prompts, 8), ref_srv.generate(prompts, 8))


def test_request_queue_matches_reference(servers):
    from repro.runtime.serve_loop import RequestQueue as RefRequestQueue
    from repro_torch.runtime import RequestQueue

    cfg, ref_srv, srv = servers
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32) for n in (7, 13, 10)]
    outs = []
    for q in (RefRequestQueue(ref_srv, batch=4), RequestQueue(srv, batch=4)):
        handles = [q.submit(p, 6) for p in prompts]
        assert q.serve_once() == 3
        outs.append([h.get(timeout=5) for h in handles])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("S,leaf", [(3, "conv"), (8, "ssm")])
def test_reference_pad_cache_pads_the_recurrent_state(servers, smoke, smoke_mesh, S, leaf):
    """The reference's ``_pad_cache`` pads the conv state at prompt length 3
    and the SSM state at prompt length 8 (their dim 2) to max_len, as if
    they were sequence rows; the port's grows only ``attn_k``/``attn_v``."""
    ref_cfg, cfg, jparams, params = smoke
    _, ref_srv, srv = servers
    toks = _tokens(2, S, cfg.vocab, seed=S)
    _, jstate = _ref_prefill(smoke_mesh, jparams, ref_cfg, toks)
    padded = ref_srv._pad_cache(jstate, S)
    assert jstate[leaf].shape[2] == S and padded[leaf].shape[2] == ref_srv.max_len
    _, state = ssm.prefill(params, torch.from_numpy(toks), cfg)
    mine = srv._pad_cache(state, S)
    assert mine[leaf] is state[leaf]
    assert mine["attn_k"].shape[2] == srv.max_len


def test_launcher_falls_back_to_static_for_zamba2_on_cpu():
    import contextlib
    import io

    from repro_torch.launch import serve as serve_launcher

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_launcher.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                             "--requests", "3", "--max-new", "4"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == ("[serve] zamba2-smoke's family has no paged decode hook; "
                        "falling back to the static batcher")
    reqs = [ln for ln in lines if ln.startswith("req ")]
    assert len(reqs) == 3 and all(len(eval(ln.split(": ", 1)[1])) == 4 for ln in reqs)
