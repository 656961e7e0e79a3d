"""Serving beyond one rank: tensor-parallel prefill and decode for every
serving family, the vocab-sharded samplers, both engines with their slots
over the data-parallel ranks, and serving from FSDP storage, on 4 gloo
ranks against the JAX package on 4 fake devices.

Two spawns run at once, one a mesh (``tests/_torch_mdworker.py``, modes
``serve-2x2`` and ``serve-1x4``): four port ranks and the reference's
process, from the reference's weights.  The dense model is the
reference's ``mk_serve`` (check 13 of ``tests/_mdworker.py``: 2 layers, d
64, 8 heads, ff 128, vocab 96, f32) with kv 4 (sharded over "model") and,
at model 4, kv 2 (sliced from the replicated wk/wv); the other runs are
the smoke configs of rwkv6-7b, zamba2-2.7b, granite-moe and
llama-3.2-vision at vocab 96.  Held to the reference at the same mesh:

  - every run's static engine: greedy tokens equal, and the logits of
    the rank's rows and vocab shard at the prefill and each decode step
    within ``LOGIT_ATOL`` (compare_tp's 3e-4, on logits of order 1) of the
    reference's ``prefill``/``decode_step`` in ``shard_map``;
  - each rank's decode state after a prefill is its block of the
    reference's global state, cut by the port's ``decode_state_specs``
    (within ``LOGIT_ATOL`` and ``STATE_RTOL``);
  - the dense runs' continuous engine on check 13's prompts (5, 12, 17,
    3, 30, 9), under FSDP too at data 2 × model 2: tokens equal to the
    reference's and to each prompt served alone by the static engine;
  - granite-moe (the experts over "model") and llama-3.2-vision (its
    cross blocks with images) through ``prefill``/``decode_step``;
  - tp > 1 ≡ tp = 1: the static engine's tokens equal the reference's
    engine on one device;
  - every rank returns the same tokens;
  - the samplers at model 4 on check 13's logits: the lowest shard wins
    ties; temperature 0 ≡ argmax; top_k 1 ≡ greedy; a seed reproduces and
    another differs; the candidates are the reference's candidate set
    rebuilt in numpy; an unbounded draw stays among the tp × 16;
  - at data 2 a batch or slots that dp does not divide are refused;
  - the padded vocab: qwen3's smoke vocab 97 pads to 98 at model 2, and
    neither package masks the drawn column 97 (the reference fault).

The prompt lengths stay off the dims at which the reference's
``_pad_cache`` pads a recurrent state (the heads at tp 1, 2 and 4,
zamba2's conv 3, d_model 64).  And the launcher on 2 CPU ranks at model
2 under ``RANK``/``WORLD_SIZE``.
"""
import concurrent.futures
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_mdworker import (SERVE_FN_RUNS, SERVE_MESHES, SERVE_NEW, SERVE_PAD_VOCAB,
                             SERVE_RUNS, WORLD, run_all, serve_config, serve_inputs,
                             serve_prompts)
from repro.models import rwkv as ref_rwkv
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import rwkv, ssm
from repro_torch.models.registry import family_of
from repro_torch.parallel.sharding import shard_leaf
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
LOGIT_ATOL = 3e-4          # compare_tp's tolerance on the loss (tests/_mdworker.py)
# the decode states: LOGIT_ATOL, and rtol 2e-5 for RWKV's WKV state, whose
# entries reach 51 after the prompt (f32 sums of k·v in another order:
# 2.8e-4 apart at most, 5.5e-6 of the largest)
STATE_RTOL = 2e-5
ENGINE_RUNS = [(m, run) for m in SERVE_MESHES for run in SERVE_RUNS[m]]
DENSE_RUNS = [(m, run) for m, run in ENGINE_RUNS if SERVE_RUNS[m][run][0] == "dense"]
FN_RUNS = [(m, run) for m in SERVE_FN_RUNS for run in SERVE_FN_RUNS[m]]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve_tp")
    np.savez(d / "serve_inputs.npz", **serve_inputs())

    def save(name, named):
        np.savez(d / f"serve-{name}_params.npz", **named)

    def ref_named(lib, kind, seed, tp=1, **over):
        params = lib.init_params(jax.random.PRNGKey(seed), serve_config(kind, tp, ref=True,
                                                                         **over))
        return {n: np.asarray(v) for n, v in ref_flatten(params)[0]}

    for kv in (4, 2):
        save(f"kv{kv}", ref_named(ref_tf, "dense", 7, kv_heads=kv))   # check 13's key
    save("granite", ref_named(ref_tf, "granite", 1))
    vision = ref_named(ref_tf, "vision", 1)
    vision["cross_blocks/gate_attn"] = np.full_like(vision["cross_blocks/gate_attn"], 0.7)
    save("vision", vision)
    # RWKV's and Zamba2's constant leaves perturbed, as their tests do
    for kind, ref_lib, lib in (("rwkv", ref_rwkv, rwkv), ("zamba2", ref_ssm, ssm)):
        tree = lib.perturb_constant_leaves(params_from_numpy(ref_named(ref_lib, kind, 1)), seed=1)
        save(kind, {n: t.numpy() for n, t in flatten_with_names(tree)[0]})
    save("qwen3-pad", ref_named(ref_tf, "qwen3-pad", 0, tp=2))
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(run_all, d, f"serve-{m}", timeout=400, reference_too=True)
                  for m in SERVE_MESHES]:
            f.result()
    return d


def _load(d, mesh_name):
    got = [dict(np.load(d / f"serve-{mesh_name}_rank{r}.npz")) for r in range(WORLD)]
    return got, dict(np.load(d / f"serve-{mesh_name}_jax.npz"))


def _block(rank, mesh_name, rows, cols):
    """The rows and vocab columns of the global logits rank ``rank``
    holds."""
    mesh = make_smoke_mesh(*SERVE_MESHES[mesh_name])
    c = mesh.coords(rank)
    r, v = rows // mesh.shape["data"], cols // mesh.shape["model"]
    return (slice(c["data"] * r, (c["data"] + 1) * r),
            slice(c["model"] * v, (c["model"] + 1) * v))


@pytest.mark.parametrize("mesh_name,run", ENGINE_RUNS)
def test_static_engine_matches_reference(workdir, mesh_name, run):
    """Tokens equal the reference's engine; each rank's logits (its rows,
    its vocab shard) at the prefill and every decode step within
    LOGIT_ATOL of the reference's prefill and decode_step."""
    got, want = _load(workdir, mesh_name)
    np.testing.assert_array_equal(want[f"{run}/loop"], want[f"{run}/static"][:, :-1])
    steps = sorted(int(k.rsplit("/", 1)[1]) for k in want if k.startswith(f"{run}/logits/"))
    assert steps == list(range(SERVE_NEW))
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g[f"{run}/static"], want[f"{run}/static"])
        for t in steps:
            full = want[f"{run}/logits/{t}"]
            rows, cols = _block(r, mesh_name, *full.shape)
            np.testing.assert_allclose(g[f"{run}/logits/{t}"], full[rows, cols], rtol=0,
                                       atol=LOGIT_ATOL, err_msg=f"rank {r}, step {t}")


@pytest.mark.parametrize("mesh_name,run", ENGINE_RUNS)
def test_decode_state_is_the_rank_block_of_the_reference(workdir, mesh_name, run):
    """The port's ``decode_state_specs`` cut the reference's global decode
    state (after a prefill of the run's batch) into each rank's block: the
    kv heads, the WKV or SSM heads over "model", the token shifts and the
    conv state whole, the rows over "data"."""
    got, want = _load(workdir, mesh_name)
    kind, _, over = SERVE_RUNS[mesh_name][run]
    mesh = make_smoke_mesh(*SERVE_MESHES[mesh_name])
    cfg = serve_config(kind, mesh.shape["model"], dp_axes=("data",), **over)
    specs = family_of(cfg).decode_state_specs(cfg, "data")
    leaves = sorted(k.rsplit("/", 1)[1] for k in want if k.startswith(f"{run}/state/"))
    assert leaves == sorted(specs)
    for r, g in enumerate(got):
        for n in leaves:
            block = shard_leaf(torch.from_numpy(want[f"{run}/state/{n}"]), specs[n], mesh,
                               mesh.coords(r))
            np.testing.assert_allclose(g[f"{run}/state/{n}"], block.numpy(), rtol=STATE_RTOL,
                                       atol=LOGIT_ATOL, err_msg=f"{n}, rank {r}")


@pytest.mark.parametrize("mesh_name,run", DENSE_RUNS)
def test_continuous_engine_matches_reference_and_static(workdir, mesh_name, run):
    """Check 13's serve-paged-greedy-bitexact-vs-static at this mesh: the
    paged engine's greedy tokens equal the reference's engine and each
    prompt served alone by the static engine (block 16 divides max_len)."""
    got, want = _load(workdir, mesh_name)
    for i in range(len(serve_prompts())):
        for g in got:
            np.testing.assert_array_equal(g[f"{run}/cont/{i}"], want[f"{run}/cont/{i}"])
            np.testing.assert_array_equal(g[f"{run}/cont/{i}"], g[f"{run}/alone/{i}"])


@pytest.mark.parametrize("mesh_name,run", ENGINE_RUNS)
def test_tp_equals_tp1(workdir, mesh_name, run):
    """The static engine at tp > 1 (and under FSDP) gives the tokens of
    the reference's engine at tp = 1 on one device, from the same tree."""
    got, _ = _load(workdir, mesh_name)
    _, ref14 = _load(workdir, "1x4")
    tp1 = ref14[f"tp1/{run.removesuffix('-fsdp')}/static"]
    for g in got:
        np.testing.assert_array_equal(g[f"{run}/static"], tp1)


@pytest.mark.parametrize("mesh_name,run", FN_RUNS)
def test_model_functions_match_reference(workdir, mesh_name, run):
    """granite-moe (experts over "model") and llama-3.2-vision (the cross
    blocks with images) through prefill and decode_step: tokens equal, the
    rank's logits within LOGIT_ATOL."""
    got, want = _load(workdir, mesh_name)
    mesh = make_smoke_mesh(*SERVE_MESHES[mesh_name])
    for r, g in enumerate(got):
        rows, _ = _block(r, mesh_name, *want[f"{run}/logits/0"].shape)
        np.testing.assert_array_equal(g[f"{run}/tokens"], want[f"{run}/tokens"][rows])
        for t in range(len([k for k in want if k.startswith(f"{run}/logits/")])):
            full = want[f"{run}/logits/{t}"]
            rows, cols = _block(r, mesh_name, *full.shape)
            np.testing.assert_allclose(g[f"{run}/logits/{t}"], full[rows, cols], rtol=0,
                                       atol=LOGIT_ATOL, err_msg=f"rank {r}, step {t}")
    assert mesh.shape["model"] > 1


@pytest.mark.parametrize("mesh_name", SERVE_MESHES)
def test_every_rank_returns_the_same_tokens(workdir, mesh_name):
    got, _ = _load(workdir, mesh_name)
    keys = [k for k in got[0] if "/logits/" not in k and "/state/" not in k
            and not k.startswith("sample/")
            and not k.endswith("/tokens") and "/refused/" not in k and k != "pad/logit_k"]
    assert len(keys) > 20
    for k in keys:
        for r in range(1, WORLD):
            np.testing.assert_array_equal(got[r][k], got[0][k], err_msg=f"{k}, rank {r}")
    for r in range(1, WORLD):           # and the samplers' draws at model 4
        for k in (k for k in got[0] if k.startswith("sample/")):
            np.testing.assert_array_equal(got[r][k], got[0][k], err_msg=f"{k}, rank {r}")


@pytest.mark.parametrize("mesh_name", SERVE_MESHES)
def test_engine_sampling_contracts(workdir, mesh_name):
    """Check 13's sampling runs through the continuous engine: a seed
    reproduces, another seed differs, top_k 1 is greedy."""
    got, _ = _load(workdir, mesh_name)
    g = got[0]
    n = 3
    assert all(np.array_equal(g[f"kv4/s42a/{i}"], g[f"kv4/s42b/{i}"]) for i in range(n))
    assert any(not np.array_equal(g[f"kv4/s42a/{i}"], g[f"kv4/s9/{i}"]) for i in range(n))
    assert all(np.array_equal(g[f"kv4/k1/{i}"], g[f"kv4/cont/{i}"]) for i in range(n))


def _candidates(logits, tp=4, k=16):
    """The reference's candidate set, in numpy from the global logits: each
    shard's top k by (value desc, index asc), shard-major, then a stable
    sort by value, descending."""
    B, V = logits.shape
    v = V // tp
    vals, ids = [], []
    for s in range(tp):
        shard = logits[:, s * v:(s + 1) * v]
        order = np.argsort(-shard, axis=-1, kind="stable")[:, :k]
        vals.append(np.take_along_axis(shard, order, -1))
        ids.append(order + s * v)
    vals, ids = np.concatenate(vals, -1), np.concatenate(ids, -1)
    order = np.argsort(-vals, axis=-1, kind="stable")
    return np.take_along_axis(vals, order, -1), np.take_along_axis(ids, order, -1)


@pytest.mark.parametrize("contract", ["tie", "argmax", "temp0", "topk1", "seeds",
                                      "candidates", "unbounded"])
def test_samplers_keep_the_reference_contracts(workdir, contract):
    """At model 4, on check 13's logits (``serve_inputs``)."""
    got, want = _load(workdir, "1x4")
    inp = serve_inputs()
    g = got[0]
    argmax = want["sample/argmax_rand"]
    if contract == "tie":            # the lowest shard wins, then the lowest index
        np.testing.assert_array_equal(want["sample/argmax_tie"], [27, 27])
        np.testing.assert_array_equal(g["sample/argmax_tie"], [27, 27])
    elif contract == "argmax":
        np.testing.assert_array_equal(argmax, np.argmax(inp["rand"], -1))
        np.testing.assert_array_equal(g["sample/argmax_rand"], argmax)
    elif contract == "temp0":
        np.testing.assert_array_equal(want["sample/temp0"], argmax)
        np.testing.assert_array_equal(g["sample/temp0"], argmax)
    elif contract == "topk1":
        np.testing.assert_array_equal(g["sample/topk1"], np.tile(argmax, (8, 1)))
    elif contract == "seeds":
        np.testing.assert_array_equal(g["sample/s42a"], g["sample/s42b"])
        assert (g["sample/s42a"] != g["sample/s9"]).any()
        assert (g["sample/s42a"] != argmax).any()
    elif contract == "candidates":
        vals, ids = _candidates(inp["rand"])
        np.testing.assert_array_equal(g["sample/cand_vals"], vals)
        np.testing.assert_array_equal(g["sample/cand_ids"], ids)
    else:                            # truncated to the tp × 16 candidates, not to 16
        draws = g["sample/unbounded"]
        ids = g["sample/cand_ids"]
        rank = np.array([[list(ids[b]).index(t) for b, t in enumerate(row)] for row in draws])
        assert (rank >= 16).any() and rank.max() < 64


def test_refusals_at_data_2(workdir):
    """A batch or a slot count that dp does not divide is refused, as the
    reference's shard_map refuses it."""
    got, _ = _load(workdir, "2x2")
    for g in got:
        for what in ("batch", "slots"):
            assert "not divisible by dp=2" in str(g[f"kv4/refused/{what}"]), what


def test_padded_vocab_reference_fault(workdir):
    """qwen3's smoke vocab 97 pads to 98 at model 2.  The reference draws
    lm_head's padded column and neither its engine nor sharded_argmax
    masks it: with column k*'s weights doubled into it (k* row 0's pick
    among the 97 real ids, whose logit is positive) the engine emits id 97,
    outside the vocabulary.  The port keeps the reference's behaviour."""
    named = dict(np.load(workdir / "serve-qwen3-pad_params.npz"))
    assert named["lm_head"].shape[1] == SERVE_PAD_VOCAB + 1
    assert np.abs(named["lm_head"][:, SERVE_PAD_VOCAB]).max() > 0
    got, want = _load(workdir, "2x2")
    assert float(want["pad/logit_k"]) > 0
    assert want["pad/tokens"][0, 0] == SERVE_PAD_VOCAB
    for g in got:
        assert int(g["pad/k"]) == int(want["pad/k"])
        np.testing.assert_array_equal(g["pad/tokens"], want["pad/tokens"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_on_two_ranks():
    """``launch/serve.py --smoke --device cpu --model 2`` as two processes
    under RANK/WORLD_SIZE: both print the same tokens for the 8 requests."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b", "--smoke",
           "--device", "cpu", "--model", "2"]
    procs = [subprocess.Popen(cmd, env={**env, "RANK": str(r)}, cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    reqs = [[l for l in out.splitlines() if l.startswith("req ")] for out, _ in outs]
    assert len(reqs[0]) == 8 and reqs[0] == reqs[1]
    assert "[serve] engine=continuous" in outs[0][0]
    assert "[serve]" not in outs[1][0]
