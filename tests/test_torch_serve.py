"""The port's serving runtime against the JAX package's
(``tests/test_serve_runtime.py``): the paged KV-cache allocator, the
static batcher and the continuous-batching engine, on the same weights.

Greedy tokens must be equal: the port's ``Server`` and
``ContinuousScheduler`` give the JAX ``Server.generate``'s tokens (for
granite-moe's smoke config, the MoE FFN, through the static engine).
Sampling at temperature > 0 draws from ``torch.Generator``s, whose bits
differ from ``jax.random``'s, so it is held to distributions and to the
identities top-k 1 ≡ greedy and temperature 0 ≡ greedy, never to JAX's
tokens.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.granite_moe_1b_a400m import make_smoke as ref_granite_smoke
from repro.configs.qwen3_1_7b import make_smoke as ref_qwen3_smoke
from repro.configs.rwkv6_7b import make_smoke as ref_rwkv_smoke
from repro.models import rwkv as ref_rwkv
from repro.models import transformer as ref_tf
from repro.runtime import RequestQueue as RefRequestQueue
from repro.runtime import Server as RefServer
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.configs.granite_moe_1b_a400m import make_smoke as granite_smoke
from repro_torch.configs.qwen3_1_7b import make_smoke as qwen3_smoke
from repro_torch.configs.rwkv6_7b import make_smoke as rwkv_smoke
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import rwkv
from repro_torch.models import transformer as tf
from repro_torch.obs import MetricsRegistry
from repro_torch.runtime import (
    BlockAllocator,
    ContinuousScheduler,
    PagedLayout,
    RequestQueue,
    SamplingParams,
    Server,
    sharded_sample,
)
from repro_torch.runtime.kvcache import SCRATCH_BLOCK, blocks_for
from repro_torch.runtime.serve_loop import draw_generator
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names

MESH = make_smoke_mesh(1, 1)


def _pair(ref_cfg, cfg, ref_mesh, max_len=32):
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    tree = params_from_numpy({n: np.asarray(p) for n, p in ref_flatten(params)[0]})
    return (RefServer(ref_cfg, ref_mesh, params, max_len=max_len),
            Server(cfg, MESH, tree, max_len=max_len))


@pytest.fixture(scope="module")
def setup(smoke_mesh):
    """``tests/test_serve_runtime.py``'s config on both sides."""
    kw = dict(name="serve", n_layers=2, d_model=32, n_heads=4, kv_heads=2,
              d_ff=64, vocab=64, tp=1, attn_chunk=16)
    cfg = tf.TransformerConfig(dtype=torch.float32, **kw)
    ref_srv, srv = _pair(ref_tf.TransformerConfig(dtype=jnp.float32, **kw), cfg,
                         smoke_mesh)
    eng = ContinuousScheduler(srv, slots=4, block_size=8, chunk=4)
    return cfg, ref_srv, srv, eng


@pytest.fixture(scope="module")
def qwen3(smoke_mesh):
    """The qwen3 smoke config, the port's prefill through the flash
    dispatch (the plain version on the CPU)."""
    cfg = dataclasses.replace(qwen3_smoke(), use_flash=True)
    ref_srv, srv = _pair(ref_qwen3_smoke(), cfg, smoke_mesh, max_len=64)
    return cfg, ref_srv, srv


@pytest.fixture(scope="module")
def granite(smoke_mesh):
    """granite-moe's smoke config (8 experts, top 2) on both sides."""
    ref_srv, srv = _pair(ref_granite_smoke(), granite_smoke(), smoke_mesh, max_len=64)
    return granite_smoke(), ref_srv, srv


@pytest.fixture(scope="module")
def rwkv6(smoke_mesh):
    """The rwkv smoke config on both sides, its constant leaves perturbed
    (``models/rwkv.py::perturb_constant_leaves``) before the JAX side gets
    the same values."""
    params = ref_rwkv.init_params(jax.random.PRNGKey(0), ref_rwkv_smoke())
    named, treedef = ref_flatten(params)
    tree = rwkv.perturb_constant_leaves(
        params_from_numpy({n: np.asarray(p) for n, p in named}))
    port = dict(flatten_with_names(tree)[0])
    jparams = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(port[n].numpy()) for n, _ in named])
    cfg = rwkv_smoke()
    return (cfg, RefServer(ref_rwkv_smoke(), smoke_mesh, jparams, max_len=64),
            Server(cfg, MESH, tree, max_len=64))


def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(L)).astype(np.int32)
            for L in rng.integers(3, 20, size=n)]


# ------------------------------------------------------------- kvcache
def test_blocks_for():
    assert blocks_for(1, 8) == 1
    assert blocks_for(8, 8) == 1
    assert blocks_for(9, 8) == 2
    assert blocks_for(0, 8) == 0


def test_paged_layout_capacity():
    lay = PagedLayout.for_requests(32, 8, 4)
    assert lay.max_blocks == 4
    assert lay.seq_capacity == 32
    assert lay.usable_blocks == 4 * 4
    assert lay.num_blocks == 1 + 16


def test_allocator_all_or_nothing_and_reuse():
    lay = PagedLayout.for_requests(32, 8, 2)
    alloc = BlockAllocator(lay)
    a = alloc.alloc(32)
    b = alloc.alloc(32)
    assert len(a) == len(b) == 4
    assert SCRATCH_BLOCK not in a + b
    assert alloc.alloc(1) is None
    assert not alloc.can_fit(1)
    assert alloc.in_use == 8
    assert alloc.utilization == 1.0
    alloc.free(a)
    assert alloc.can_fit(32)
    c = alloc.alloc(9)
    row = alloc.table_row(c)
    assert len(row) == lay.max_blocks
    assert row[:2] == c
    assert all(r == SCRATCH_BLOCK for r in row[2:])
    with pytest.raises(ValueError, match="scratch"):
        alloc.free([SCRATCH_BLOCK])


def test_metrics_registry_refuses_type_shadowing():
    m = MetricsRegistry()
    m.counter("x").inc(2)
    with pytest.raises(TypeError):
        m.gauge("x")
    m.histogram("h").observe(3.0)
    assert m.snapshot() == {"h": m.histogram("h").summary(), "x": 2.0}


# ----------------------------------------------------------- static path
@pytest.mark.parametrize("which", ["serve", "qwen3", "granite"])
def test_static_greedy_matches_reference(which, setup, qwen3, granite):
    cfg, ref_srv, srv = {"serve": setup[:3], "qwen3": qwen3, "granite": granite}[which]
    rng = np.random.default_rng(7)
    prompts = rng.integers(1, cfg.vocab, (3, 11)).astype(np.int32)
    want = ref_srv.generate(prompts, 8)
    got = srv.generate(prompts, 8)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert srv.metrics.counter("serve.tokens_generated").value >= 24


def test_request_queue_matches_reference(setup):
    """Left-padded mixed-length batches give the reference's tokens."""
    cfg, ref_srv, srv, _ = setup
    prompts = _prompts(3, cfg.vocab, seed=8)
    outs = []
    for q in (RefRequestQueue(ref_srv, batch=4), RequestQueue(srv, batch=4)):
        handles = [q.submit(p, 5) for p in prompts]
        assert q.serve_once() == 3
        outs.append([h.get(timeout=5) for h in handles])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


def test_request_queue_delivers_errors(setup):
    _, _, srv, _ = setup

    class Boom(Server):
        def __init__(self):             # reuse srv's state, poison generate
            self.__dict__.update(srv.__dict__)

        def generate(self, prompts, max_new, **kw):
            raise RuntimeError("device lost")

    q = RequestQueue(Boom(), batch=4)
    handles = [q.submit(np.arange(1, 6, dtype=np.int32), 3) for _ in range(3)]
    assert q.serve_once() == 3
    for h in handles:
        assert isinstance(h.get(timeout=5), RuntimeError)


def test_server_refuses_more_than_one_rank(setup):
    """Without a process group the world is one rank: a mesh of more
    ranks, or whose model extent is not the config's tp, is refused (the
    engines on several ranks: tests/test_torch_serve_tp.py)."""
    cfg, _, srv, _ = setup
    with pytest.raises(ValueError, match="does not fit a world of 1"):
        Server(cfg, make_smoke_mesh(2, 1), srv.params)
    with pytest.raises(ValueError, match="tp=1 on a mesh with model extent 2"):
        Server(cfg, make_smoke_mesh(1, 2), srv.params)


# Prompt lengths of the rwkv tests stay off H (4) and d_model (64): the
# reference's ``_pad_cache`` pads every cache leaf whose dim 2 equals the
# prompt length, which at those lengths would be the recurrent state.
def test_rwkv_static_greedy_matches_reference(rwkv6):
    cfg, ref_srv, srv = rwkv6
    prompts = np.random.default_rng(11).integers(1, cfg.vocab, (3, 23)).astype(np.int32)
    np.testing.assert_array_equal(srv.generate(prompts, 8),
                                  ref_srv.generate(prompts, 8))


def test_rwkv_request_queue_matches_reference(rwkv6):
    cfg, ref_srv, srv = rwkv6
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32) for n in (7, 13, 9)]
    outs = []
    for q in (RefRequestQueue(ref_srv, batch=4), RequestQueue(srv, batch=4)):
        handles = [q.submit(p, 6) for p in prompts]
        assert q.serve_once() == 3
        outs.append([h.get(timeout=5) for h in handles])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("S", [4, 64])
def test_rwkv_static_engine_leaves_the_state_unpadded(rwkv6, S):
    """At a prompt length equal to H or to d_model the static engine
    passes the recurrent state through untouched: its tokens are those of
    the port's own prefill and decode loop."""
    cfg, _, srv = rwkv6
    srv = Server(cfg, MESH, srv.params, max_len=128)     # room to pad at S 64
    prompts = np.random.default_rng(S).integers(1, cfg.vocab, (2, S)).astype(np.int32)
    logits, state = rwkv.prefill(srv.params, torch.from_numpy(prompts), cfg)
    assert srv._pad_cache(state, S) == state
    want = [torch.argmax(logits, -1).int()]
    for pos in range(S, S + 5):
        logits, state = rwkv.decode_step(srv.params, state, want[-1], pos, cfg)
        want.append(torch.argmax(logits, -1).int())
    np.testing.assert_array_equal(srv.generate(prompts, 6), torch.stack(want, 1).numpy())


def test_continuous_refuses_rwkv(rwkv6):
    _, _, srv = rwkv6
    with pytest.raises(ValueError, match="no paged decode hook"):
        ContinuousScheduler(srv, slots=2, block_size=16, chunk=4)


# ------------------------------------------- continuous-batching engine
def test_continuous_greedy_matches_static_and_reference(setup):
    cfg, ref_srv, srv, eng = setup
    prompts = _prompts(6, cfg.vocab)
    outs = eng.generate_batch(prompts, 8)
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, srv.generate(p[None], 8)[0])
        np.testing.assert_array_equal(o, ref_srv.generate(p[None], 8)[0])


def test_continuous_qwen3_flash_matches_reference(qwen3):
    cfg, ref_srv, srv = qwen3
    eng = ContinuousScheduler(srv, slots=4, block_size=16, chunk=8)
    prompts = _prompts(5, cfg.vocab, seed=9)
    for p, o in zip(prompts, eng.generate_batch(prompts, 6)):
        np.testing.assert_array_equal(o, ref_srv.generate(p[None], 6)[0])


def test_continuous_oversubscribed_slots_drain(setup):
    cfg, _, _, eng = setup
    outs = eng.generate_batch(_prompts(11, cfg.vocab, seed=1), 5)
    assert len(outs) == 11
    assert all(o.shape == (5,) for o in outs)
    assert eng.idle
    assert eng.allocators[0].in_use == 0


def test_continuous_rejects_oversized_request(setup):
    _, _, _, eng = setup
    out = eng.submit(np.ones(30, np.int32), 10).get(timeout=5)
    assert isinstance(out, ValueError)
    assert eng.idle


def test_continuous_seed_reproducible(setup):
    cfg, _, _, eng = setup
    prompts = _prompts(3, cfg.vocab, seed=2)
    sp = SamplingParams(temperature=0.8, top_k=8, seed=42)
    a = eng.generate_batch(prompts, 8, sp)
    b = eng.generate_batch(prompts, 8, sp)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = eng.generate_batch(prompts, 8,
                           SamplingParams(temperature=0.8, top_k=8, seed=7))
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))


def test_continuous_topk1_equals_greedy(setup):
    cfg, _, _, eng = setup
    prompts = _prompts(3, cfg.vocab, seed=3)
    greedy = eng.generate_batch(prompts, 6)
    k1 = eng.generate_batch(prompts, 6,
                            SamplingParams(temperature=0.9, top_k=1, seed=5))
    for x, y in zip(k1, greedy):
        np.testing.assert_array_equal(x, y)


def test_continuous_temp_zero_equals_greedy(setup):
    cfg, _, _, eng = setup
    prompts = _prompts(2, cfg.vocab, seed=4)
    greedy = eng.generate_batch(prompts, 6)
    t0 = eng.generate_batch(prompts, 6,
                            SamplingParams(temperature=0.0, top_k=4, seed=9))
    for x, y in zip(t0, greedy):
        np.testing.assert_array_equal(x, y)


def test_continuous_eos_stops_early(setup):
    cfg, _, srv, _ = setup
    prompt = _prompts(1, cfg.vocab, seed=5)[0]
    ref = srv.generate(prompt[None], 8)[0]
    eos = int(ref[3])
    eng = ContinuousScheduler(srv, slots=4, block_size=8, chunk=4, eos_id=eos)
    out = eng.generate_batch([prompt], 8)[0]
    stop = int(np.argmax(ref == eos))
    np.testing.assert_array_equal(out, ref[:stop + 1])
    assert eng.allocators[0].in_use == 0


def test_continuous_decode_failure_fails_every_request(setup, monkeypatch):
    cfg, _, srv, _ = setup
    eng = ContinuousScheduler(srv, slots=4, block_size=8, chunk=4)
    dones = [eng.submit(p, 6) for p in _prompts(3, cfg.vocab, seed=6)]

    def boom(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(eng, "_decode_chunk", boom)
    eng.step()
    assert all(isinstance(d.get_nowait(), RuntimeError) for d in dones)
    assert eng.idle and eng.allocators[0].in_use == 0


# ------------------------------------------------------------- sampling
def _sample(logits, temperature, top_k, top_p, seeds):
    B = logits.shape[0]
    gens = [draw_generator(s, 0, "cpu") for s in seeds]
    return sharded_sample(torch.as_tensor(logits), 1, gens,
                          torch.full((B,), temperature),
                          torch.full((B,), top_k, dtype=torch.int32),
                          torch.full((B,), top_p))


def test_sharded_sample_temperature_zero_is_argmax():
    logits = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    logits[1, [5, 9]] = logits[1].max() + 1.0            # a tie: first wins
    for gens in (None, [draw_generator(0, 0, "cpu")] * 4):
        out = sharded_sample(torch.as_tensor(logits), 1, gens, torch.zeros(4),
                             torch.zeros(4, dtype=torch.int32), torch.ones(4))
        np.testing.assert_array_equal(out.numpy(), np.argmax(logits, axis=-1))
    assert out[1] == 5


def test_sharded_sample_respects_topk_and_top_p():
    logits = np.random.default_rng(1).normal(size=(1, 64)).astype(np.float32)
    order = np.argsort(-logits[0], kind="stable")
    draws = {int(_sample(logits, 5.0, 2, 1.0, [s])[0]) for s in range(64)}
    assert draws == set(order[:2].tolist())
    # a nucleus of 1e-6 keeps the head candidate alone
    assert {int(_sample(logits, 5.0, 0, 1e-6, [s])[0]) for s in range(16)} == {order[0]}


def test_sharded_sample_distribution_matches_softmax():
    """4096 draws over 4 candidates: frequencies within 0.03 of the
    tempered softmax (about 3.5 standard deviations)."""
    logits = np.array([[2.0, 1.0, 0.5, 0.0] + [-30.0] * 12], np.float32)
    n = 4096
    out = _sample(np.repeat(logits, n, 0), 1.5, 0, 1.0, range(n)).numpy()
    freq = np.bincount(out, minlength=16)[:4] / n
    p = np.exp(logits[0, :4] / 1.5)
    np.testing.assert_allclose(freq, p / p.sum(), atol=0.03)


def test_draw_generator_depends_on_seed_and_position():
    draws = {(s, pos): torch.rand(4, generator=draw_generator(s, pos, "cpu"))
             for s in (0, 1) for pos in (0, 1)}
    assert torch.equal(draws[0, 0], torch.rand(4, generator=draw_generator(0, 0, "cpu")))
    vals = list(draws.values())
    assert all(not torch.equal(a, b) for i, a in enumerate(vals) for b in vals[i + 1:])


# ------------------------------------------------------------- launcher
@pytest.mark.parametrize("engine", ["continuous", "static"])
def test_launcher_smoke_on_cpu(engine):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_launcher.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                             "--engine", engine, "--requests", "5",
                             "--max-new", "4"])
    lines = buf.getvalue().splitlines()
    reqs = [ln for ln in lines if ln.startswith("req ")]
    assert len(reqs) == 5 and all(len(eval(ln.split(": ", 1)[1])) == 4 for ln in reqs)
    assert lines[-1].startswith(f"[serve] engine={engine} 5 requests")


def test_launcher_falls_back_to_static_for_rwkv_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_launcher.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
                             "--requests", "3", "--max-new", "4"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == ("[serve] rwkv6-smoke's family has no paged decode hook; "
                        "falling back to the static batcher")
    reqs = [ln for ln in lines if ln.startswith("req ")]
    assert len(reqs) == 3 and all(len(eval(ln.split(": ", 1)[1])) == 4 for ln in reqs)
    assert lines[-1].startswith("[serve] engine=static 3 requests")

