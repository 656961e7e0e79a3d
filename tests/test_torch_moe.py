"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's ``moe_ffn`` at tp = 1, on seeded numpy inputs: the output, the
load-balance aux loss and the gradients of ``sum(out · cot) + aux`` with
respect to the tokens and every weight, f32, rtol 1e-5 / atol 1e-6 (the
same math; each token's K contributions summed in the reference's order,
the rest in another).  Capacity factors low enough that slots drop are
among the cases, and the test shows that a drop happened and that the
router's top-K had no ties (where ``jax.lax.top_k`` and ``torch.topk``
could order them apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch.models import moe

RTOL, ATOL = 1e-5, 1e-6
T, D = 40, 16
# (experts, top k, d_expert, shared experts, capacity factor)
CASES = {
    "granite-like": (8, 2, 12, 0, 2.0),
    "granite-like-drops": (8, 2, 12, 0, 0.5),
    "kimi-like-drops": (8, 2, 12, 1, 0.75),
    "top4-drops": (6, 4, 8, 0, 0.6),
}


def _inputs(E, K, F, shared, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = {"router": rng.standard_normal((D, E)).astype(f32),
         "w_gate": (rng.standard_normal((E, D, F)) / 4).astype(f32),
         "w_up": (rng.standard_normal((E, D, F)) / 4).astype(f32),
         "w_down": (rng.standard_normal((E, F, D)) / 3).astype(f32)}
    if shared:
        p.update(ws_g=(rng.standard_normal((D, F * shared)) / 4).astype(f32),
                 ws_u=(rng.standard_normal((D, F * shared)) / 4).astype(f32),
                 ws_down=(rng.standard_normal((F * shared, D)) / 3).astype(f32))
    return p, rng.standard_normal((T, D)).astype(f32), rng.standard_normal((T, D)).astype(f32)


@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_matches_reference(case):
    E, K, F, shared, cf = CASES[case]
    ref_cfg = ref_moe.MoECfg(num_experts=E, top_k=K, d_expert=F, shared_experts=shared,
                             capacity_factor=cf)
    cfg = moe.MoECfg(num_experts=E, top_k=K, d_expert=F, shared_experts=shared,
                     capacity_factor=cf)
    assert moe.capacity(T, cfg) == ref_moe.capacity(T, ref_cfg)
    p, x, cot = _inputs(E, K, F, shared)

    def ref_obj(params, xx):
        out, aux = ref_moe.moe_ffn(params, xx, ref_cfg, tp=1)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (want_out, want_aux)), want_g = jax.jit(jax.value_and_grad(
        ref_obj, argnums=(0, 1), has_aux=True))({k: jnp.asarray(v) for k, v in p.items()},
                                                jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_ffn(tp, tx, cfg)
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g[1]), rtol=RTOL, atol=ATOL)
    for k, g in tp.items():
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(want_g[0][k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)

    # the router's top K has no ties at this seed; slots drop in the "-drops" cases only
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(p["router"]), -1)
    top = torch.sort(probs, dim=-1, descending=True).values[:, :K + 1]
    assert (top[:, :-1] > top[:, 1:]).all()
    counts = torch.bincount(torch.topk(probs, K).indices.reshape(-1), minlength=E)
    dropped = int((counts - moe.capacity(T, cfg)).clamp(min=0).sum())
    assert (dropped > 0) == case.endswith("drops"), (case, counts.tolist())
