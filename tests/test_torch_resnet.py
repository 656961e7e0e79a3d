"""The port's ResNet against the JAX package's, on the smoke config with
the reference's weights carried over: the loss and every gradient match
``jax.value_and_grad(train_forward)``.  Tolerance rtol 1e-4 / atol 1e-5
in f32: convolutions and BatchNorm sums are taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet50_cifar import make_smoke as ref_make_smoke
from repro.data import ImagePipeline as RefImagePipeline
from repro.models import resnet as ref_resnet
from repro.utils.trees import flatten_with_names as ref_flatten
from repro_torch.configs.resnet50_cifar import make_smoke
from repro_torch.data import ImagePipeline
from repro_torch.models import resnet
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import flatten_with_names

RTOL, ATOL = 1e-4, 1e-5


def _ref_named(cfg, seed=0):
    params = ref_resnet.init_params(jax.random.PRNGKey(seed), cfg)
    return params, {n: np.asarray(p) for n, p in ref_flatten(params)[0]}


@pytest.mark.parametrize("batch", [8, 3])
def test_loss_and_grads_match_reference(batch):
    ref_cfg, cfg = ref_make_smoke(), make_smoke()
    ref_params, named = _ref_named(ref_cfg)
    ref_batch = RefImagePipeline(ref_cfg.img_size, ref_cfg.num_classes,
                                 batch).batch_at(0)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: ref_resnet.train_forward(p, ref_batch, ref_cfg)))(ref_params)

    tree = params_from_numpy(named, "cpu")
    leaves = flatten_with_names(tree)[0]
    for _, p in leaves:
        p.requires_grad_(True)
    tbatch = ImagePipeline(cfg.img_size, cfg.num_classes, batch,
                           device="cpu").batch_at(0)
    np.testing.assert_array_equal(tbatch["images"].numpy(),
                                  np.asarray(ref_batch["images"]))
    loss = resnet.train_forward(tree, tbatch, cfg)
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=RTOL, atol=ATOL)
    ref_g = dict(ref_flatten(grads_ref)[0])
    assert [n for n, _ in leaves] == list(ref_g)
    for n, p in leaves:
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_g[n]),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def test_module_forward_is_the_functional_forward():
    cfg = make_smoke()
    model = resnet.ResNet(cfg, resnet.init_params(cfg, seed=3, device="cpu"))
    images = torch.randn(4, cfg.img_size, cfg.img_size, 3,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(model(images),
                       resnet.forward(model.params_tree(), images, cfg))
    names = [n for n, _ in flatten_with_names(model.params_tree())[0]]
    assert len(names) == len(list(model.parameters()))


@pytest.mark.parametrize("size", [8, 7])
def test_stride2_conv_pads_like_same(size):
    """XLA's "SAME" for a 3x3 stride-2 conv on an even input pads (0, 1):
    symmetric padding=1 would shift every output window."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    want = np.asarray(ref_resnet._conv2d(jnp.asarray(x), jnp.asarray(w), 2))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resnet.conv2d_same(xt, torch.from_numpy(w), 2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if size % 2 == 0:
        sym = torch.nn.functional.conv2d(
            xt, torch.from_numpy(w).permute(3, 2, 0, 1), stride=2, padding=1)
        assert not np.allclose(sym.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)
