"""The port's Inception-BN against the JAX package's: leaf names, bucket
plans and schedules (exact: pure functions of the shapes and knobs), and
the loss and every gradient of ``inception_train_forward`` against
``jax.value_and_grad`` with the reference's weights carried over by
``utils/convert.py``.  Tolerance rtol 1e-4 / atol 1e-5 in f32, as
``tests/test_torch_resnet.py``: convolutions and BatchNorm sums are taken
in another order.  The reference's net has six mixed blocks and no depth
knob, so the full-width case cuts the input to 32x32 and the batch to 2.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import inception_bn_imagenet as ref_configs
from repro.core import get_strategy as ref_get_strategy
from repro.core import make_bucket_plan as ref_make_bucket_plan
from repro.data import ImagePipeline as RefImagePipeline
from repro.launch.mesh import make_smoke_mesh as ref_smoke_mesh
from repro.models import resnet as ref_resnet
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.configs import get_arch
from repro_torch.configs import inception_bn_imagenet as configs
from repro_torch.core import get_strategy, make_bucket_plan
from repro_torch.data import ImagePipeline
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import resnet
from repro_torch.models.registry import family_of
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names
from test_torch_plan import STRATEGIES, _op_fields, _plan_fields

RTOL, ATOL = 1e-4, 1e-5
CONFIGS = ("smoke", "full")


def _configs(which):
    if which == "smoke":
        return ref_configs.make_smoke(), configs.make_smoke()
    return ref_configs.make_config(), configs.make_config()


def _ref_params(cfg):
    return jax.eval_shape(lambda: ref_resnet.init_inception(jax.random.PRNGKey(0), cfg))


def _ref_plan(cfg, **kw):
    params = _ref_params(cfg)
    specs = ref_resnet.param_rules(cfg).tree_specs(params)
    return ref_make_bucket_plan(params, specs, ref_smoke_mesh(1, 1), **kw)


def _plan(cfg, **kw):
    params = resnet.init_inception(cfg, device="meta")
    return make_bucket_plan(params, resnet.param_specs(params),
                            make_smoke_mesh(1), **kw)


@pytest.mark.parametrize("which", CONFIGS)
def test_leaf_names_and_order_match_reference(which):
    ref_cfg, cfg = _configs(which)
    ref_named, _ = ref_flatten(_ref_params(ref_cfg))
    named, _ = flatten_with_names(resnet.init_inception(cfg, device="meta"))
    assert [n for n, _ in named] == [n for n, _ in ref_named]
    assert [tuple(p.shape) for _, p in named] == [tuple(p.shape) for _, p in ref_named]
    names = [n for n, _ in named]
    assert names[:2] == ["head", "mix0/b1"] and names[-3:] == [
        "stem", "stem_bn_b", "stem_bn_s"]


def test_full_width_sizes():
    """58 leaves and 1,314,880 params (5.26 MB in f32) at width 1.0."""
    named, _ = flatten_with_names(resnet.init_inception(configs.make_config(),
                                                        device="meta"))
    assert len(named) == 58
    assert sum(p.numel() for _, p in named) == 1_314_880


@pytest.mark.parametrize("num_channels", [1, 4])
@pytest.mark.parametrize("bucket_bytes", [0, 64 * 1024, 4 * 1024 * 1024])
@pytest.mark.parametrize("which", CONFIGS)
def test_bucket_plan_matches_reference(which, bucket_bytes, num_channels):
    ref_cfg, cfg = _configs(which)
    kw = dict(bucket_bytes=bucket_bytes, num_channels=num_channels)
    assert _plan_fields(_plan(cfg, **kw)) == _plan_fields(_ref_plan(ref_cfg, **kw))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("which", CONFIGS)
def test_schedule_matches_reference_op_for_op(which, strategy):
    ref_cfg, cfg = _configs(which)
    got = get_strategy(strategy).plan(_plan(cfg, num_channels=4))
    want = ref_get_strategy(strategy).plan(_ref_plan(ref_cfg, num_channels=4))
    assert _op_fields(got) == _op_fields(want)
    assert got.stats() == want.stats()


def _loss_and_grads(ref_cfg, cfg, batch, seed=0):
    ref_params = ref_resnet.init_inception(jax.random.PRNGKey(seed), ref_cfg)
    named = {n: np.asarray(p) for n, p in ref_flatten(ref_params)[0]}
    ref_batch = RefImagePipeline(ref_cfg.img_size, ref_cfg.num_classes,
                                 batch).batch_at(0)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: ref_resnet.inception_train_forward(p, ref_batch, ref_cfg)))(ref_params)

    tree = params_from_numpy(named, "cpu")
    leaves = flatten_with_names(tree)[0]
    for _, p in leaves:
        p.requires_grad_(True)
    tbatch = ImagePipeline(cfg.img_size, cfg.num_classes, batch,
                           device="cpu").batch_at(0)
    np.testing.assert_array_equal(tbatch["images"].numpy(),
                                  np.asarray(ref_batch["images"]))
    loss = resnet.inception_train_forward(tree, tbatch, cfg)
    loss.backward()
    return loss, leaves, float(loss_ref), dict(ref_flatten(grads_ref)[0])


@pytest.mark.parametrize("which,batch", [("smoke", 8), ("smoke", 3), ("full32", 2)])
def test_loss_and_grads_match_reference(which, batch):
    ref_cfg, cfg = _configs("smoke" if which == "smoke" else "full")
    if which == "full32":
        ref_cfg = dataclasses.replace(ref_cfg, img_size=32)
        cfg = dataclasses.replace(cfg, img_size=32)
    loss, leaves, loss_ref, ref_g = _loss_and_grads(ref_cfg, cfg, batch)
    np.testing.assert_allclose(loss.item(), loss_ref, rtol=RTOL, atol=ATOL)
    assert [n for n, _ in leaves] == list(ref_g)
    for n, p in leaves:
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_g[n]),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def test_module_forward_is_the_functional_forward():
    cfg = configs.make_smoke()
    model = resnet.Inception(cfg, resnet.init_inception(cfg, seed=3, device="cpu"))
    images = torch.randn(4, cfg.img_size, cfg.img_size, 3,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(model(images),
                       resnet.inception_forward(model.params_tree(), images, cfg))
    names = [n for n, _ in flatten_with_names(model.params_tree())[0]]
    assert len(names) == len(list(model.parameters())) == 58
    assert family_of(cfg).module is resnet.Inception
    assert get_arch("inception-bn-imagenet").family == "inception"


def test_convert_carries_the_reference_tree_into_the_module():
    """``utils/convert.py`` needs nothing new for Inception: its names
    nest into the module's tree, leaf for leaf and bit for bit."""
    ref_cfg, cfg = _configs("smoke")
    params = ref_resnet.init_inception(jax.random.PRNGKey(1), ref_cfg)
    named = {n: np.asarray(p) for n, p in ref_flatten(params)[0]}
    tree = params_from_numpy(named, "cpu")
    assert sorted(tree) == sorted(params) and sorted(tree["mix3"]) == sorted(params["mix3"])
    model = resnet.Inception(cfg, tree)
    got = flatten_with_names(model.params_tree())[0]
    assert [n for n, _ in got] == list(named)
    for n, p in got:
        np.testing.assert_array_equal(p.detach().numpy(), named[n], err_msg=n)


def test_init_is_seeded():
    cfg = configs.make_smoke()
    a = flatten_with_names(resnet.init_inception(cfg, seed=1, device="cpu"))[0]
    b = flatten_with_names(resnet.init_inception(cfg, seed=1, device="cpu"))[0]
    c = flatten_with_names(resnet.init_inception(cfg, seed=2, device="cpu"))[0]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert not torch.equal(dict(a)["head"], dict(c)["head"])


def test_launcher_takes_the_image_pipeline(monkeypatch, capsys):
    """``--arch inception-bn-imagenet --smoke --device cpu`` trains with
    SGD over ``ImagePipeline``; building a ``TokenPipeline`` fails it."""
    made = []

    class Spy(ImagePipeline):
        def __init__(self, *a, **kw):
            made.append(a)
            super().__init__(*a, **kw)

    def no_tokens(*_a, **_kw):
        raise AssertionError("an image arch built a TokenPipeline")

    monkeypatch.setattr(launcher, "ImagePipeline", Spy)
    monkeypatch.setattr(launcher, "TokenPipeline", no_tokens)
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    launcher.main(["--arch", "inception-bn-imagenet", "--smoke", "--device", "cpu",
                   "--steps", "2", "--strategy", "concom"])
    smoke = configs.make_smoke()
    assert made == [(smoke.img_size, smoke.num_classes, 8)]
    out = capsys.readouterr().out
    assert "[train] inception-bn-imagenet concom: loss" in out
