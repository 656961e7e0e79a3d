"""The port's optimizers and LR schedules against the JAX package's, on
the same numpy-seeded params and gradients over a few steps.  Tolerance
rtol 1e-6 / atol 1e-7: the same f32 elementwise arithmetic; only the
global-norm sum and the schedules' scalar math (f64 in the port, f32 in
the reference) differ in the last bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch import optim

SHAPES = {"a": (3, 4), "b": (7,), "c/0/w": (2, 2, 3)}
RTOL, ATOL = 1e-6, 1e-7


def _draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _run(make_ref, make_port, clip=0.0, steps=4):
    p0 = _draw(0)
    ref_opt, opt = make_ref(), make_port()
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    for step in range(steps):
        g = _draw(step + 1, scale=3.0)
        ref_g = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        if clip:
            ref_g, ref_n = ref_optim.clip_by_global_norm(ref_g, clip)
            tg, n = optim.clip_by_global_norm(tg, clip)
            np.testing.assert_allclose(n.item(), float(ref_n), rtol=RTOL)
        ref_u, ref_s = ref_opt.update(ref_g, ref_s, ref_p, jnp.int32(step))
        u, s = opt.update(tg, s, p, step)
        ref_p = ref_optim.apply_updates(ref_p, ref_u)
        optim.apply_updates(p, u)
    for k in SHAPES:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(ref_p[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_sgd_matches_reference(nesterov, clip):
    _run(lambda: ref_optim.sgd(0.1, momentum=0.9, nesterov=nesterov),
         lambda: optim.sgd(0.1, momentum=0.9, nesterov=nesterov), clip=clip)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference(weight_decay):
    _run(lambda: ref_optim.adamw(1e-2, weight_decay=weight_decay),
         lambda: optim.adamw(1e-2, weight_decay=weight_decay), clip=1.0)


def test_schedules_match_reference():
    ref_fn = ref_optim.cosine_warmup(0.3, 10, 50, floor=0.01)
    fn = optim.cosine_warmup(0.3, 10, 50, floor=0.01)
    for step in (0, 3, 9, 10, 11, 30, 49, 50, 70):
        np.testing.assert_allclose(fn(step), float(ref_fn(jnp.int32(step))),
                                   rtol=1e-6)
    assert optim.linear_scaling_rule(0.1, 256, 256) == \
        ref_optim.linear_scaling_rule(0.1, 256, 256)
