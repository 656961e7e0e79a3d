"""The port's ZeRO-1 step on 4 gloo ranks (spawned processes) against the
JAX package's on 4 fake devices (``tests/_torch_mdworker.py`` mode
``zero1``).

The model is the reference's ZeRO-1 parity model (2 layers, d 32, f32),
SGD with momentum, 3 steps through ``Trainer``; runs: the flat allreduce,
scheduled zero1 under concom × flat, concom × ring and rsag × ring,
deferred, monolithic, scheduled at clip 0.05, and deferred at clip 0.05
with 2 microbatches.  Checks: params bit-identical across the ranks;
every run's losses and final params within rtol 1e-5 / atol 1e-6 of the
reference's (a deferred run, flushed by ``finalize``, against the
reference's scheduled one); scheduled ≡ monolithic ≡ deferred bit for
bit; ``mem.state_bytes`` of the optimizer state a rank = the flat run's
÷ 4 plus each bucket's padding.

And the reference's double sum: under zero1 with depcha's in-backward
sum (``depcha_in_scan``) the JAX package sums the stacked leaves in the
backward and again in the zero1 reduce-scatter, so their update is 4×
concom's on 4 devices while the other leaves' is 1× — the port refuses
that combination at dp > 1.
"""
import jax
import numpy as np
import pytest

from repro.models import transformer as ref_tf
from repro.utils.trees import flatten_with_names as ref_flatten

from _torch_mdworker import WORLD, ZERO1_CFG, ZERO1_RUNS, ZERO1_STEPS, run_all


@pytest.fixture(scope="module")
def zero1_dir(tmp_path_factory):
    import jax.numpy as jnp

    d = tmp_path_factory.mktemp("zero1")
    cfg = ref_tf.TransformerConfig(**ZERO1_CFG, dtype=jnp.float32)
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg)
    np.savez(d / "zero1_params.npz", **{n: np.asarray(p) for n, p in ref_flatten(params)[0]})
    run_all(d, "zero1", reference_too=True)
    return d


def _load(d, run, rank):
    return dict(np.load(d / f"zero1-{run}_rank{rank}.npz"))


@pytest.mark.parametrize("run", sorted(ZERO1_RUNS))
def test_zero1_runs_match_the_reference(zero1_dir, run):
    ref = dict(np.load(zero1_dir / "zero1_jax.npz"))
    for rank in range(WORLD):
        got = _load(zero1_dir, run, rank)
        for k in range(ZERO1_STEPS):
            np.testing.assert_allclose(got[f"loss/{k}"], ref[f"{run}/loss/{k}"], rtol=1e-5,
                                       err_msg=f"rank {rank} step {k}")
        params = [k for k in got if k.startswith("param/")]
        assert params
        for k in params:
            np.testing.assert_allclose(got[k], ref[f"{run}/{k}"], rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("run", sorted(ZERO1_RUNS))
def test_params_are_bit_identical_across_ranks(zero1_dir, run):
    first = _load(zero1_dir, run, 0)
    for rank in range(1, WORLD):
        got = _load(zero1_dir, run, rank)
        for k, v in first.items():
            if k.startswith("param/") or k.startswith("loss/"):
                np.testing.assert_array_equal(got[k], v, err_msg=f"rank {rank} {k}")


def test_scheduled_monolithic_and_deferred_are_bit_identical(zero1_dir):
    for rank in range(WORLD):
        sched = _load(zero1_dir, "scheduled", rank)
        for other in ("monolithic", "deferred"):
            got = _load(zero1_dir, other, rank)
            for k, v in sched.items():
                if k.startswith("param/") or k.startswith("loss/"):
                    np.testing.assert_array_equal(got[k], v, err_msg=f"{other} {k}")
    # the clip bound, and the schedule and transport change no bit
    assert float(_load(zero1_dir, "scheduled-clip", 0)["grad_norm"]) > 0.05
    for rank in range(WORLD):
        a = _load(zero1_dir, "scheduled", rank)
        for other in ("scheduled-ring", "rsag-ring"):
            b = _load(zero1_dir, other, rank)
            for k in a:
                if k.startswith("param/"):
                    np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("run", sorted(r for r, v in ZERO1_RUNS.items() if v[0]))
def test_optimizer_state_is_a_quarter_a_rank(zero1_dir, run):
    flat = _load(zero1_dir, "flat", 0)
    n = flat["param_bytes"] // 4                    # f32 params
    flat_opt = int(flat["state_bytes"] - flat["param_bytes"])
    assert flat_opt == 4 * n                       # SGD's momentum
    for rank in range(WORLD):
        got = _load(zero1_dir, run, rank)
        opt = int(got["state_bytes"] - got["param_bytes"])
        if run.startswith("monolithic"):
            shards = -(-n // WORLD)
            buckets = 1
        else:
            sizes = got["bucket_sizes"]
            assert int(sizes.sum()) == n
            shards = int(sum(-(-int(s) // WORLD) for s in sizes))
            buckets = len(sizes)
        # momentum, and for a deferred run the carried update shards
        per = 2 if ZERO1_RUNS[run][0] == "deferred" else 1
        assert opt == per * 4 * shards
        assert 0 <= shards * WORLD - n < WORLD * buckets   # the padding
        assert opt <= per * (flat_opt // WORLD + 4 * buckets)


def test_the_reference_sums_in_scan_leaves_twice_under_zero1(zero1_dir):
    ref = dict(np.load(zero1_dir / "zero1_jax.npz"))
    ratios = {k.removeprefix("in_scan_ratio/"): float(v) for k, v in ref.items()
              if k.startswith("in_scan_ratio/")}
    assert ratios
    for name, r in ratios.items():
        want = WORLD if name.startswith("blocks/") else 1.0
        assert r == pytest.approx(want, rel=1e-4), name
    for rank in range(WORLD):
        refused = str(np.load(zero1_dir / f"zero1-in-scan_rank{rank}.npz")["refused"])
        assert "twice" in refused and "dp=4" in refused
