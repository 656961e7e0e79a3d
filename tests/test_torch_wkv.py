"""The port's WKV against the JAX package's.

On CPU tensors ``ops.wkv_chunk`` runs the plain version (``ref.py``); it
is held against the Pallas kernel run in interpret mode, as the JAX
package's own tests run it, and against the JAX sequential recurrence
(``repro/kernels/rwkv6/ref.py::wkv_ref``), at the shapes of
``tests/test_kernels.py`` plus a decode chunk (C 1) and a short prompt
(C 7, N 16), with its tolerances (5e-4 in f32, 5e-2 with bf16 inputs).
``ops.wkv_sequence``, a whole layer's WKV (one kernel launch a layer on
the card), runs ``wkv_sequence_ref`` on CPU tensors; it is held against
the JAX model's ``wkv_chunked`` to 1e-4 and against a chunk-by-chunk scan
of the Pallas kernel in interpret mode to 5e-4, with S a multiple of the
chunk, ragged, below it and 1, at the full-width head size, and with bf16
r, k, v (y then in bf16, held within one bf16 rounding: rtol 2^-7).  The
model's chunked WKV is held against the JAX model's to 1e-4 and makes one
``ops.wkv_sequence`` call a layer.  The CUDA kernel is held against the
plain version by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
The plain version gives the same result in every process: fresh
interpreters, run side by side, are held against a float64 numpy
evaluation of the same factored math and against each other.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ops import wkv_chunk as ref_wkv_chunk
from repro.kernels.rwkv6.ref import wkv_ref as ref_wkv_ref
from repro.models.rwkv import wkv_chunked as ref_wkv_chunked
from repro_torch.configs.rwkv6_7b import make_smoke as rwkv_smoke
from repro_torch.kernels.rwkv6 import kernel, ops, ref
from repro_torch.models import rwkv
from repro_torch.utils.convert import tensor_from_numpy

SHAPES = [   # (B, C, H, N, dtype of r/k/v)
    (2, 32, 4, 64, "float32"),     # tests/test_kernels.py
    (1, 64, 2, 64, "float32"),
    (2, 16, 8, 64, "bfloat16"),
    (3, 1, 4, 64, "float32"),      # a decode step
    (2, 7, 4, 16, "float32"),      # a short prompt, the smoke head size
]
TOL = {"float32": 5e-4, "bfloat16": 5e-2}


def _inputs(B, S, H, N, dtype="float32", seed=0):
    """The same values on both sides, as ``tests/test_kernels.py`` draws
    them: r, k, v normal (rounded once by JAX to ``dtype``), log-decay
    −exp(0.5·normal − 2), u and the state 0.1·normal, all carried over
    bit for bit."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    js = dict(r=jnp.asarray(normal(B, S, H, N)).astype(dtype),
              k=jnp.asarray(normal(B, S, H, N)).astype(dtype),
              v=jnp.asarray(normal(B, S, H, N)).astype(dtype),
              logw=jnp.asarray(-np.exp(normal(B, S, H, N) * 0.5 - 2.0)),
              u=jnp.asarray(normal(H, N) * 0.1),
              state=jnp.asarray(normal(B, H, N, N) * 0.1))
    return js, {n: tensor_from_numpy(np.asarray(a)) for n, a in js.items()}


def _rows(t, B, C, H, N):
    """(B, C, H, N) → the kernel's (BH, C, N)."""
    return t.transpose(1, 2).reshape(B * H, C, N)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,C,H,N,dtype", SHAPES)
def test_wkv_chunk_matches_pallas_interpret(B, C, H, N, dtype):
    js, ts = _inputs(B, C, H, N, dtype)
    y_want, s_want = ref_wkv_chunk(*js.values(), interpret=True)
    before = kernel.WKV_LAUNCHES
    y, s1 = ops.wkv_chunk(*ts.values())
    assert kernel.WKV_LAUNCHES == before            # CPU: the plain version
    assert y.dtype == s1.dtype == torch.float32
    assert y.shape == (B, C, H, N) and s1.shape == (B, H, N, N)
    _close(y, y_want, TOL[dtype])
    _close(s1, s_want, TOL[dtype])


@pytest.mark.parametrize("B,C,H,N,dtype", SHAPES)
def test_wkv_chunk_ref_matches_sequential_recurrence(B, C, H, N, dtype):
    """The chunk math against the JAX step-by-step recurrence, on the
    kernel's (BH, C, N) layout with u broadcast to (BH, 1, N)."""
    js, ts = _inputs(B, C, H, N, dtype, seed=1)
    jrows = [js[n].transpose(0, 2, 1, 3).reshape(B * H, C, N)
             for n in ("r", "k", "v", "logw")]
    ju = jnp.broadcast_to(js["u"][None], (B, H, N)).reshape(B * H, 1, N)
    y_want, s_want = ref_wkv_ref(*jrows, ju, js["state"].reshape(B * H, N, N))
    rows = [_rows(ts[n], B, C, H, N) for n in ("r", "k", "v", "logw")]
    u = ts["u"][None].expand(B, H, N).reshape(B * H, 1, N)
    state = ts["state"].reshape(B * H, N, N)
    y, s1 = ref.wkv_chunk_ref(*rows, u, state)
    _close(y, y_want, TOL[dtype])
    _close(s1, s_want, TOL[dtype])
    # the port's own recurrence is the same oracle: the same f32 products
    # as JAX's, summed by another einsum (a last-bit difference per step,
    # 1.2e-5 on values of 5 after 16 steps), so held to 1e-4
    y_seq, s_seq = ref.wkv_ref(*rows, u, state)
    _close(y_seq, y_want, 1e-4)
    _close(s_seq, s_want, 1e-4)


@pytest.mark.parametrize("B,S,H,N,chunk", [
    (2, 40, 4, 16, 16),     # S not a multiple of the chunk (zero-padded)
    (2, 5, 4, 16, 16),      # S below the chunk: one chunk of C = S
    (1, 70, 2, 64, 32),     # three chunks at the full-width head size
    (2, 1, 4, 16, 16),      # a decode step
])
def test_wkv_chunked_matches_reference(B, S, H, N, chunk):
    js, ts = _inputs(B, S, H, N, seed=2)
    y_want, s_want = ref_wkv_chunked(*js.values(), chunk)
    y, s1 = rwkv.wkv_chunked(*ts.values(), chunk)
    assert y.shape == (B, S, H, N) and y.dtype == torch.float32
    _close(y, y_want, 1e-4)
    _close(s1, s_want, 1e-4)


SEQUENCES = [   # (B, S, H, N, chunk, dtype of r/k/v)
    (2, 32, 4, 16, 16, "float32"),     # S a multiple of the chunk
    (2, 40, 4, 16, 16, "float32"),     # ragged: the last chunk zero-padded
    (2, 5, 4, 16, 16, "float32"),      # S below the chunk: one chunk of C = S
    (3, 1, 4, 16, 16, "float32"),      # S 1, a decode step
    (1, 70, 2, 64, 32, "float32"),     # the full-width head size
    (2, 40, 4, 16, 16, "bfloat16"),    # y comes back in bf16
]
BF16_ROUNDING = 2.0 ** -7     # one bf16 rounding, relative


def _close_y(got, want, dtype, tol):
    """y at ``tol``; bf16 y within one bf16 rounding as well, since the
    two sides round f32 values that differ in their last bits."""
    _close_rtol(got, want, tol, BF16_ROUNDING if dtype == "bfloat16" else tol)


def _close_rtol(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("B,S,H,N,chunk,dtype", SEQUENCES)
def test_wkv_sequence_matches_reference(B, S, H, N, chunk, dtype):
    """``ops.wkv_sequence`` on CPU tensors (the plain version) against the
    JAX model's ``wkv_chunked`` (a ``lax.scan`` of the chunk math)."""
    js, ts = _inputs(B, S, H, N, dtype, seed=4)
    y_want, s_want = ref_wkv_chunked(*js.values(), chunk)
    before = kernel.WKV_LAUNCHES
    y, s1 = ops.wkv_sequence(*ts.values(), chunk)
    assert kernel.WKV_LAUNCHES == before
    assert y.shape == (B, S, H, N) and y.dtype == ts["r"].dtype
    assert s1.shape == (B, H, N, N) and s1.dtype == torch.float32
    assert str(np.asarray(y_want).dtype) == dtype
    _close_y(y.float(), np.asarray(y_want, np.float32), dtype, 1e-4)
    _close(s1, s_want, 1e-4)


def _pallas_scan(js, chunk):
    """The TPU kernel's function, scanned: the sequence zero-padded to
    whole chunks of C = min(chunk, S), each chunk through the Pallas
    kernel in interpret mode, the state handed on; y in f32."""
    B, S, H, N = js["r"].shape
    C = min(chunk, S)
    pad = (-S) % C
    seq = [jnp.pad(js[n], ((0, 0), (0, pad), (0, 0), (0, 0)))
           for n in ("r", "k", "v", "logw")]
    state, ys = js["state"], []
    for i in range(0, S + pad, C):
        y, state = ref_wkv_chunk(*(t[:, i:i + C] for t in seq), js["u"], state,
                                 interpret=True)
        ys.append(np.asarray(y))
    return np.concatenate(ys, axis=1)[:, :S], np.asarray(state)


@pytest.mark.parametrize("B,S,H,N,chunk,dtype", SEQUENCES)
def test_wkv_sequence_matches_pallas_chunk_scan(B, S, H, N, chunk, dtype):
    """The one-launch-a-layer function held to the TPU kernel's function,
    scanned over the chunks, at the chunk tests' 5e-4."""
    js, ts = _inputs(B, S, H, N, dtype, seed=5)
    y_want, s_want = _pallas_scan(js, chunk)
    y, s1 = ops.wkv_sequence(*ts.values(), chunk)
    _close_y(y.float(), y_want, dtype, TOL["float32"])
    _close(s1, s_want, TOL["float32"])


def test_wkv_sequence_kernel_takes_cuda_tensors_only():
    _, ts = _inputs(1, 5, 2, 16)
    before = kernel.WKV_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        kernel.wkv_sequence_kernel(*ts.values(), 16)
    assert kernel.WKV_LAUNCHES == before


def test_wkv_sequence_rejects_mixed_devices():
    _, ts = _inputs(1, 4, 2, 16)
    ts["u"] = ts["u"].to("meta")
    with pytest.raises(ValueError, match="devices"):
        ops.wkv_sequence(*ts.values(), 16)


def test_wkv_chunked_is_one_sequence_call_a_layer(monkeypatch):
    """The model's prefill and decode step each call ``ops.wkv_sequence``
    once a layer (on the card: one kernel launch a layer), and nothing
    else of the WKV ops."""
    cfg = rwkv_smoke()
    params = rwkv.perturb_constant_leaves(rwkv.init_params(cfg, seed=0, device="cpu"))
    calls = []

    def count(r, k, v, logw, u, state, chunk, out=None):
        calls.append((tuple(r.shape), chunk, out is not None
                      and out.data_ptr() == state.data_ptr()))
        return ref.wkv_sequence_ref(r, k, v, logw, u, state, chunk, out=out)

    def refuse(*args):
        raise AssertionError("the model called the one-chunk entry")

    monkeypatch.setattr(ops, "wkv_sequence", count)
    monkeypatch.setattr(ops, "wkv_chunk_rows", refuse)
    tokens = torch.as_tensor(np.random.default_rng(6).integers(1, cfg.vocab, (3, 23)))
    _, state = rwkv.prefill(params, tokens, cfg)
    H, N = cfg.n_heads, cfg.head_size
    assert calls == [((3, 23, H, N), cfg.chunk, True)] * cfg.n_layers
    calls.clear()
    rwkv.decode_step(params, state, tokens[:, -1], 23, cfg)
    assert calls == [((3, 1, H, N), cfg.chunk, True)] * cfg.n_layers


@pytest.mark.parametrize("in_place", [False, True])
def test_wkv_sequence_writes_the_state_to_out(in_place):
    """``out=`` takes the final state (in place when it is the input
    state): the same values as a new tensor, and y unchanged."""
    _, ts = _inputs(2, 21, 4, 16, seed=8)
    y_want, s_want = ops.wkv_sequence(*ts.values(), 8)
    state = ts["state"].clone()
    out = state if in_place else torch.full_like(state, float("nan"))
    y, s1 = ops.wkv_sequence(*(t if n != "state" else state for n, t in ts.items()), 8,
                             out=out)
    assert s1 is out
    torch.testing.assert_close(s1, s_want, atol=0, rtol=0)
    torch.testing.assert_close(y, y_want, atol=0, rtol=0)


def test_decode_step_updates_the_state_tensors_in_place():
    """``decode_step`` writes every layer's WKV state into the tensor it was
    given, and gives what a step on a copy of the state gives."""
    cfg = rwkv_smoke()
    params = rwkv.perturb_constant_leaves(rwkv.init_params(cfg, seed=0, device="cpu"))
    tokens = torch.as_tensor(np.random.default_rng(7).integers(1, cfg.vocab, (2, 9)))
    _, state = rwkv.prefill(params, tokens[:, :-1], cfg)
    copy = {n: t.clone() for n, t in state.items()}
    wkv = state["wkv"]
    logits, new = rwkv.decode_step(params, state, tokens[:, -1], 8, cfg)
    assert new["wkv"] is wkv and not torch.equal(wkv, copy["wkv"])
    want, _ = rwkv.prefill(params, tokens, cfg)
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)


def test_wkv_chunked_keeps_the_input_dtype():
    _, ts = _inputs(2, 9, 4, 16, seed=3)
    ts = {n: (t.bfloat16() if n in ("r", "k", "v") else t) for n, t in ts.items()}
    y, s1 = rwkv.wkv_chunked(*ts.values(), 4)
    assert y.dtype == torch.bfloat16 and s1.dtype == torch.float32


def test_wkv_chunk_rejects_mixed_devices():
    _, ts = _inputs(1, 4, 2, 16)
    ts["state"] = ts["state"].to("meta")
    with pytest.raises(ValueError, match="devices"):
        ops.wkv_chunk(*ts.values())


def test_wkv_chunk_rows_rejects_rows_off_the_heads():
    _, ts = _inputs(1, 4, 3, 16)
    rows = [_rows(ts[n], 1, 4, 3, 16) for n in ("r", "k", "v", "logw")]
    with pytest.raises(ValueError, match="heads"):
        ops.wkv_chunk_rows(*rows, ts["u"][:2], ts["state"].reshape(3, 16, 16))


def test_kernel_wrapper_takes_cuda_tensors_only():
    _, ts = _inputs(1, 4, 2, 16)
    rows = [_rows(ts[n], 1, 4, 2, 16) for n in ("r", "k", "v", "logw")]
    before = kernel.WKV_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        kernel.wkv_chunk_kernel(*rows, ts["u"], ts["state"].reshape(2, 16, 16))
    assert kernel.WKV_LAUNCHES == before


SRC = Path(__file__).resolve().parents[1] / "src"
PROBE = Path(__file__).resolve().parent / "_torch_exp_probe.py"


def _wkv_chunk_f64(r, k, v, logw, u, state):
    """The factored chunk math of ``ref.wkv_chunk_ref`` in float64 numpy,
    on the (B, C, H, N) layout."""
    r, k, v, lw, u, s0 = (np.asarray(a, np.float64) for a in (r, k, v, logw, u, state))
    C = r.shape[1]
    L = np.cumsum(lw, axis=1)
    r_dec = r * np.exp(L - lw)
    scores = np.einsum("bthn,bshn->bhts", r_dec, k * np.exp(-L))
    scores *= np.tril(np.ones((C, C)), -1)
    y = (np.einsum("bthn,bhnm->bthm", r_dec, s0)
         + np.einsum("bhts,bshm->bthm", scores, v)
         + (r * u * k).sum(-1, keepdims=True) * v)
    wc = L[:, -1]                                            # (B, H, N)
    s1 = (s0 * np.exp(wc)[..., None]
          + np.einsum("bshn,bshm->bhnm", k * np.exp(wc[:, None] - L), v))
    return y, s1


def test_wkv_chunk_is_the_same_in_every_process(tmp_path):
    """The case of ``SHAPES[0]`` in 8 fresh interpreters at once.  CPU
    ``torch.exp`` is MKL's VML, whose first call in a process can run one
    thread's grain at reduced accuracy; the f32 plain version then moved
    ``att @ v`` by up to 5.4e-3 in about one process in 20
    (``_torch_exp_probe.py``)."""
    js, _ = _inputs(*SHAPES[0])
    y_want, s_want = _wkv_chunk_f64(*(np.asarray(a) for a in js.values()))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    outs = [tmp_path / f"wkv{i}.npz" for i in range(8)]
    # each child runs ops.wkv_chunk on these inputs, loading torch and not JAX
    procs = [subprocess.Popen([sys.executable, str(PROBE), "--child", "wkv", "--out", str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for out in outs]
    for p in procs:
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log.decode()[-3000:]
    got = [np.load(out) for out in outs]
    tol = TOL["float32"]
    for g in got:
        _close(g["y"], y_want, tol)
        _close(g["s1"], s_want, tol)
        _close(g["y"], got[0]["y"], tol)
        _close(g["s1"], got[0]["s1"], tol)


def test_wkv_chunk_hands_contiguous_rows_at_batch_one(monkeypatch):
    """At B 1 the (B, C, H, N) → (BH, C, N) reshape is a strided view; the
    kernel takes contiguous rows only, so ``wkv_chunk`` copies."""
    _, ts = _inputs(1, 7, 4, 16)
    seen = []

    def capture(r, k, v, logw, u, state):
        seen.extend(t.is_contiguous() for t in (r, k, v, logw))
        return ref.wkv_chunk_rows_ref(r, k, v, logw, u, state)

    monkeypatch.setattr(ops, "wkv_chunk_rows", capture)
    ops.wkv_chunk(*ts.values())
    assert seen == [True] * 4
