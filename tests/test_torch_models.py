"""The port's Block3d, NestedResUNet, weight bridge and SegModel against the
JAX package's, at the same weights (converted from the flax tree) and on the
same numpy inputs, in eval mode with non-trivial BatchNorm statistics."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_pipeline_tpu.models import Block3d as JBlock3d
from segmentation_pipeline_tpu.models import NestedResUNet as JNestedResUNet
from segmentation_pipeline_tpu.training.model import SegModel as JSegModel
from segmentation_pipeline_torch.models import (Block3d, NestedResUNet,
                                                flax_to_state_dict, state_dict_to_flax)
from segmentation_pipeline_torch.training.model import SegModel

torch.set_num_threads(2)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def _perturb(tree, rng):
    """Move BatchNorm statistics and affine parameters off their init values
    (positive variances, not all 1) so eval-mode BN is not the identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k in ("mean", "scale", "bias"):
            out[k] = (v + rng.normal(0.0, 0.2, v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def _flax_variables(module, x, seed=0):
    init = jax.jit(functools.partial(module.init, train=False))
    variables = init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))
    return _perturb(_numpy_tree(variables), np.random.default_rng(seed + 100))


def _input(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, size=shape).astype(np.float32)


@pytest.mark.parametrize("residual", [True, False])
def test_block3d_matches_jax(residual):
    x = _input((2, 6, 5, 4, 5), 0)
    jblock = JBlock3d(features=8, residual=residual, dropout_p=0.2)
    variables = _flax_variables(jblock, x)
    ref = np.asarray(jblock.apply(variables, jnp.asarray(x), train=False))
    block = Block3d(5, 8, residual=residual, dropout_p=0.2).eval()
    block.load_state_dict(flax_to_state_dict(variables))
    with torch.inference_mode():
        out = block(torch.from_numpy(x)).numpy()
    # f32 convs of 27*8 terms and BN in another order: a few ulps of O(1)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def unet_and_variables():
    x = _input((2, 16, 16, 8, 3), 1)
    jnet = JNestedResUNet(input_channels=3, output_channels=2, filters=8, dropout_p=0.2)
    return jnet, _flax_variables(jnet, x, seed=1), x


def test_nested_res_unet_matches_jax(unet_and_variables):
    jnet, variables, x = unet_and_variables
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x), train=False))
    net = NestedResUNet(3, 2, filters=8, dropout_p=0.2).eval()
    net.load_state_dict(flax_to_state_dict(variables))
    with torch.inference_mode():
        out = net(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 16, 16, 8, 2)
    # softmax probabilities after 25 f32 convs: rounding only
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_nested_res_unet_bf16_matches_jax(unet_and_variables):
    """bf16 activations and weights on both sides, f32 BN statistics. The
    two frameworks round to bf16 at different places (XLA keeps bf16 sums in
    the upsample matmuls, torch sums in f32), and each rounding is 2**-8
    relative, compounded over 10 blocks: probabilities agree to 2e-2."""
    jnet, variables, x = unet_and_variables
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x, dtype=jnp.bfloat16),
                                train=False).astype(jnp.float32))
    net = NestedResUNet(3, 2, filters=8).eval()
    net.load_state_dict(flax_to_state_dict(variables))
    with torch.inference_mode():
        out = net(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2)


def test_bridge_round_trip_is_exact(unet_and_variables):
    _, variables, _ = unet_and_variables
    state = flax_to_state_dict(variables)
    back = state_dict_to_flax(state)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    net = NestedResUNet(3, 2, filters=8)
    net.load_state_dict(state)
    again = flax_to_state_dict(state_dict_to_flax(net.state_dict()))
    assert again.keys() == net.state_dict().keys()
    for key, value in net.state_dict().items():
        assert torch.equal(again[key], value), key


def test_bridge_maps_kernels_and_batchnorm(unet_and_variables):
    _, variables, _ = unet_and_variables
    state = flax_to_state_dict(variables)
    kernel = variables["params"]["conv0_1"]["Conv3d_0"]["kernel"]
    assert kernel.shape == (3, 3, 3, 16, 8)
    np.testing.assert_array_equal(state["conv0_1.Conv3d_0.weight"].numpy(),
                                  kernel.transpose(4, 3, 0, 1, 2))
    bn = variables["batch_stats"]["conv1_0"]["BatchNorm_1"]
    np.testing.assert_array_equal(state["conv1_0.BatchNorm_1.running_var"].numpy(),
                                  bn["var"])
    np.testing.assert_array_equal(state["conv1_0.BatchNorm_1.weight"].numpy(),
                                  variables["params"]["conv1_0"]["BatchNorm_1"]["scale"])
    with pytest.raises(KeyError):
        flax_to_state_dict({"params": {"conv": {"weights": np.zeros(2)}}})


def test_segmodel_channel_first_matches_jax(unet_and_variables):
    jnet, variables, x = unet_and_variables
    x_cf = np.ascontiguousarray(np.moveaxis(x, -1, 1))
    jmodel = JSegModel(jnet, seed=0)
    jmodel.load_state_dict(variables)
    ref = np.asarray(jmodel(x_cf))
    model = SegModel(NestedResUNet(3, 2, filters=8, dropout_p=0.2), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    out = model(x_cf)
    assert out.shape == (2, 2, 16, 16, 8) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    assert model.num_params == jmodel.num_params


def test_segmodel_bf16_casts_back_to_f32(unet_and_variables):
    _, variables, x = unet_and_variables
    x_cf = np.moveaxis(x, -1, 1)
    f32 = SegModel(NestedResUNet(3, 2, filters=8), device="cpu")
    f32.load_state_dict(flax_to_state_dict(variables))
    bf16 = SegModel(NestedResUNet(3, 2, filters=8), device="cpu", compute_dtype="bfloat16")
    bf16.load_state_dict(flax_to_state_dict(variables))
    out = bf16(x_cf)
    assert out.dtype == torch.float32
    # bf16 against f32 on the same weights: see the bf16 parity test
    np.testing.assert_allclose(out.numpy(), f32(x_cf).numpy(), atol=2e-2)


def test_segmodel_lazy_init_from_seed():
    def make(seed):
        return SegModel(NestedResUNet(3, 2, filters=4), seed=seed, device="cpu")

    a, b, c = make(3), make(3), make(4)
    assert a.state_dict() == {} and a.num_params == 0
    x = _input((1, 3, 8, 8, 8), 2)
    a(x)
    b.ensure_initialized()
    c.ensure_initialized()
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key
    assert not torch.equal(a.state_dict()["out_conv.weight"],
                           c.state_dict()["out_conv.weight"])
    weight = a.state_dict()["conv0_1.Conv3d_0.weight"]  # fan_in = 8 * 27
    assert weight.abs().max() <= 1 / np.sqrt(8 * 27)
    assert torch.equal(a.state_dict()["conv0_0.BatchNorm_0.running_var"], torch.ones(4))
    jmodel = JSegModel(JNestedResUNet(3, 2, filters=4), seed=0)
    jmodel.ensure_initialized(x)
    assert a.num_params == jmodel.num_params
