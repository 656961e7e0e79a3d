"""The port's transformer LM training path against the JAX package's, in
one process on the CPU.

``train_forward``'s loss and every leaf's gradient against JAX's
``value_and_grad(train_forward)`` (run inside ``shard_map`` on the
reference's one-device smoke mesh), rtol 1e-5 / atol 1e-6, on the smoke
configs of the seven archs the port trains: qwen3 (qk-norm), starcoder2
(gelu), minitron (relu2, 257-token vocab), h2o-danube (a sliding window
of 16 over 48 tokens), musicgen (``frame_embeds``), and the MoE archs
granite-moe (8 experts, top 2) and kimi-k2 (with a shared expert), with
the reference's weights carried over and the reference's batches.
Also the pieces under it: ``TokenPipeline`` draws, rank slices and extra
inputs; the sharding rules and the in-backward reduce axes, with and
without FSDP; the
cross-entropy at tp=1; the configs the registry resolves; the in-place
AdamW, bit for bit against the formula it replaced; the flash op's
refusal of autograd inputs; and the launcher on the CPU.
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
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro.parallel import sharding as ref_sharding
from repro.utils.trees import flatten_with_names as ref_flatten
from _torch_mdworker import run_tp_ops
from repro_torch.configs import get_arch, param_structs
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import common, transformer
from repro_torch.models.registry import family_of
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names

ARCHS = ("qwen3-1.7b", "starcoder2-3b", "minitron-8b", "h2o-danube-1.8b", "musicgen-large",
         "granite-moe-1b-a400m", "kimi-k2-1t-a32b")
SEQ, BATCH = 48, 2
RTOL, ATOL = 1e-5, 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _extras(arch, cfg, seq):
    return {name: (tuple(fn(cfg, seq)), np.float32) for name, fn, _ in arch.extra_inputs}


def _reference(arch_id):
    arch = ref_get_arch(arch_id)
    cfg = arch.make_smoke()
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg)
    batch = RefTokenPipeline(cfg.vocab, SEQ, BATCH, extra_specs=_extras(arch, cfg, SEQ)
                             ).batch_at(3)

    def vg(p, b):
        return jax.value_and_grad(lambda q: ref_tf.train_forward(q, b, cfg))(p)

    specs = jax.tree.map(lambda _: P(), params)
    run = jax.jit(jax.shard_map(vg, mesh=ref_smoke_mesh(1, 1),
                                in_specs=(specs, {k: P() for k in batch}),
                                out_specs=(P(), specs), check_vma=False))
    loss, grads = run(params, batch)
    return ({n: np.asarray(p) for n, p in ref_flatten(params)[0]}, float(loss),
            {n: np.asarray(g) for n, g in ref_flatten(grads)[0]})


@pytest.mark.parametrize("arch_id", ARCHS)
def test_loss_and_grads_match_reference(arch_id):
    named, want_loss, want_grads = _reference(arch_id)
    arch = get_arch(arch_id)
    cfg = arch.make_smoke()
    model = transformer.Transformer(cfg, params_from_numpy(named, "cpu"))
    batch = TokenPipeline(cfg.vocab, SEQ, BATCH, extra_specs=_extras(arch, cfg, SEQ),
                          device="cpu").batch_at(3)
    loss = model(batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=RTOL)
    got = dict(flatten_with_names(model.params_tree())[0])
    assert list(got) == list(want_grads)
    for n, want in want_grads.items():
        np.testing.assert_allclose(got[n].grad.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{arch_id} {n}")


def test_frame_embeds_change_the_loss():
    """musicgen's conditioning input reaches the loss (else the parity
    above would not show that it is read)."""
    arch = get_arch("musicgen-large")
    cfg = arch.make_smoke()
    model = transformer.Transformer(cfg, transformer.init_params(cfg, device="cpu"))
    batch = TokenPipeline(cfg.vocab, SEQ, BATCH, extra_specs=_extras(arch, cfg, SEQ),
                          device="cpu").batch_at(0)
    with torch.no_grad():
        with_frames = model(batch).item()
        without = model({k: v for k, v in batch.items() if k != "frame_embeds"}).item()
    assert with_frames != without


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 4), (3, 4)])
def test_token_pipeline_matches_reference(rank, world):
    extra = {"frame_embeds": ((16, 8), np.float32)}
    ref = RefTokenPipeline(97, 16, 8, seed=5, extra_specs=extra).batch_at(2)
    got = TokenPipeline(97, 16, 8, seed=5, mesh=make_smoke_mesh(world), rank=rank,
                        extra_specs=extra, device="cpu").batch_at(2)
    rows = slice(rank * 8 // world, (rank + 1) * 8 // world)
    for k in ("tokens", "labels", "frame_embeds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k])[rows], err_msg=k)
    assert got["tokens"].dtype == torch.int32
    assert got["global_tokens"].dim() == 0
    assert got["global_tokens"].item() == float(ref["global_tokens"]) == 8 * 16


def _spec_tuple(spec):
    return tuple(spec)


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("dp_axes", [("data",), ("pod", "data")])
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_rules_and_reduce_axes_match_reference(arch_id, dp_axes, fsdp):
    ref_cfg = ref_get_arch(arch_id).make_config(tp=1, dp_axes=dp_axes,
                                                depcha_in_scan=True, fsdp=fsdp)
    cfg = get_arch(arch_id).make_config(dp_axes=dp_axes, depcha_in_scan=True, fsdp=fsdp)
    ref_params = jax.eval_shape(lambda: ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg))
    params = param_structs(cfg)
    ref_specs = ref_flatten(ref_tf.param_rules(ref_cfg).tree_specs(ref_params))[0]
    specs = flatten_with_names(transformer.param_specs(params, cfg))[0]
    assert [(n, s) for n, s in specs] == [(n, _spec_tuple(s)) for n, s in ref_specs]
    want = ref_tf._depcha_axes(ref_cfg, ref_params["blocks"], "blocks/")
    assert transformer._depcha_axes(cfg, params["blocks"], "blocks/") == \
        [tuple(a) for a in want]
    rules = transformer.param_rules(cfg)
    for n, _ in specs:
        assert sharding.spec_for_param(rules, n) == _spec_tuple(
            ref_sharding.spec_for_param(ref_tf.param_rules(ref_cfg), n))


def test_fsdp_rules_match_reference():
    ref_cfg = ref_get_arch("qwen3-1.7b").make_config(tp=1, dp_axes=("pod", "data"),
                                                     fsdp=True)
    cfg = get_arch("qwen3-1.7b").make_config(dp_axes=("pod", "data"), fsdp=True)
    for name in ("blocks/wq", "blocks/wdown", "blocks/ln1", "embed", "blocks/wk"):
        assert transformer.param_rules(cfg).spec(name) == _spec_tuple(
            ref_tf.param_rules(ref_cfg).spec(name)), name


def test_xent_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 33)) * 4).astype(np.float32)
    labels = rng.integers(-2, 36, (2, 5)).astype(np.int32)    # some out of range

    def ref_fn(x):
        return ref_common.sharded_softmax_xent(x, jnp.asarray(labels), 1)

    specs = P()
    run = jax.jit(jax.shard_map(lambda x: (ref_fn(x), jax.grad(lambda y: ref_fn(y).sum())(x)),
                                mesh=ref_smoke_mesh(1, 1), in_specs=(specs,),
                                out_specs=(specs, specs), check_vma=False))
    want, want_grad = run(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = common.sharded_softmax_xent(x, torch.from_numpy(labels), 1)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)
    # vocab-sharded over a model axis of 3 gloo ranks (33 = 3 x 11): every
    # rank's loss is the full one, its logits' gradient 3 x its shard's
    # (psum's transpose is psum, as in the reference's shard_map)
    ranks = run_tp_ops(tmp_path, 3, logits=logits, labels=labels)
    for r, got3 in enumerate(ranks):
        np.testing.assert_allclose(got3["xent"], np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got3["xent_grad"] / 3,
                                   np.asarray(want_grad)[..., r * 11:(r + 1) * 11],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_configs_match_reference(arch_id):
    """Every field but the dtypes and the default tp (the port's is 1);
    the full configs' parameter counts on the meta device."""
    ref_arch, arch = ref_get_arch(arch_id), get_arch(arch_id)
    ref_cfg, cfg = ref_arch.make_config(tp=1), arch.make_config()
    def field(c, name):         # a MoECfg of either package as its fields
        v = getattr(c, name)
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v

    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert field(cfg, f.name) == field(ref_cfg, f.name), f.name
    smoke, ref_smoke = arch.make_smoke(), ref_arch.make_smoke()
    for f in dataclasses.fields(smoke):
        if f.name != "dtype":
            assert field(smoke, f.name) == field(ref_smoke, f.name), f.name
    assert smoke.dtype == torch.float32 and cfg.dtype == torch.bfloat16
    assert [n for n, _, _ in arch.extra_inputs] == [n for n, _, _ in ref_arch.extra_inputs]
    ref_params = jax.eval_shape(lambda: ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg))
    count = sum(p.numel() for _, p in flatten_with_names(param_structs(cfg))[0])
    assert count == sum(int(np.prod(p.shape)) for _, p in ref_flatten(ref_params)[0])
    assert family_of(cfg).train_forward is transformer.train_forward


def test_qwen3_full_width_size():
    cfg = get_arch("qwen3-1.7b").make_config()
    params = param_structs(cfg)
    assert sum(p.numel() for _, p in flatten_with_names(params)[0]) == 2_031_739_904
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab, cfg.qk_norm) == (28, 2048, 16, 8, 128, 6144, 151_936, True)


def _adamw_out_of_place(grads, state, params, step, lr, b1=0.9, b2=0.95, eps=1e-8,
                        weight_decay=0.0):
    """The formula ``optim.adamw`` computed before it wrote m and v in place."""
    t = step + 1.0
    m, v, updates = {}, {}, {}
    for k, g in grads.items():
        g32 = g.to(torch.float32)
        m[k] = b1 * state["m"][k] + (1 - b1) * g32
        v[k] = b2 * state["v"][k] + (1 - b2) * g32 * g32
        mh = m[k] / (1 - b1 ** t)
        vh = v[k] / (1 - b2 ** t)
        updates[k] = -lr * (mh / (torch.sqrt(vh) + eps)
                            + weight_decay * params[k].to(torch.float32))
    return updates, {"m": m, "v": v}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_in_place_is_bit_equal_to_the_old_formula(dtype, weight_decay):
    gen = torch.Generator().manual_seed(0)
    shapes = {"a": (33, 7), "b": (1000,), "c": (3, 4, 5)}
    params = {k: torch.randn(s, generator=gen).to(dtype) for k, s in shapes.items()}
    opt = adamw(3e-3, weight_decay=weight_decay)
    state = opt.init(params)
    old = {"m": {k: t.clone() for k, t in state["m"].items()},
           "v": {k: t.clone() for k, t in state["v"].items()}}
    m_objs = {k: t for k, t in state["m"].items()}
    for step in range(4):
        grads = {k: (torch.randn(s, generator=gen) * 10 ** (step - 2)).to(dtype)
                 for k, s in shapes.items()}
        want, old = _adamw_out_of_place(grads, old, params, step, 3e-3,
                                        weight_decay=weight_decay)
        got, new_state = opt.update(grads, state, params, step)
        assert new_state is state
        for k in shapes:
            assert state["m"][k] is m_objs[k]
            for a, b in ((got[k], want[k]), (state["m"][k], old["m"][k]),
                         (state["v"][k], old["v"][k])):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (step, k)


def test_flash_refuses_autograd_inputs():
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.attention import attention

    q = torch.randn(1, 8, 4, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16)
    v = torch.randn(1, 8, 2, 16)
    before = kernel.FLASH_LAUNCHES
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="no backward"):
        attention(q, k, v, use_flash=True)
    assert kernel.FLASH_LAUNCHES == before
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape
    assert flash_attention(q.detach(), k, v).grad_fn is None


def test_launcher_trains_lm_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b",
         "--smoke", "--device", "cpu", "--strategy", "depcha", "--steps", "2",
         "--seq", "32", "--batch", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "[train] qwen3-1.7b depcha: loss" in res.stdout
