"""The port's conv_transpose3d, WSConv3d, BlurConv3d, BlurConvTranspose3d and
ModularUNet against the JAX package's, at the same weights (converted from
the flax tree) and on the same numpy inputs; the weight bridge's round trip
and SegModel's init of the blurred convs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_pipeline_tpu.models import components as jcomp
from segmentation_pipeline_tpu.models import ModularUNet as JModularUNet
from segmentation_pipeline_tpu.ops import convolution as jconv
from segmentation_pipeline_torch.models import (AvgPoolDown, BlurConv3d, BlurConvTranspose3d,
                                                ModularUNet, TrilinearUp, WSConv3d,
                                                flax_to_state_dict, state_dict_to_flax)
from segmentation_pipeline_torch.ops import convolution as tconv
from segmentation_pipeline_torch.training.model import SegModel

torch.set_num_threads(2)


def _input(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, size=shape).astype(np.float32)


def _random_tree(shapes, rng):
    """Values for a flax variables tree of these shapes: kernels at torch's
    init scale, BatchNorm statistics and affine parameters off their init
    values (positive variances, not all 1), nonzero biases."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _random_tree(v, rng)
        elif k == "kernel":
            bound = 1 / np.sqrt(np.prod(v.shape[:4]))
            out[k] = rng.uniform(-bound, bound, v.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        else:
            out[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
    return out


def _flax_variables(module, x, seed):
    """Random variables in the flax tree that ``module.init`` makes (its
    shapes only: no init compile)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    return _random_tree(jax.tree_util.tree_map(lambda s: s, shapes), np.random.default_rng(seed))


def _assert_close(out, ref, rel):
    """Within ``rel`` of the reference's range."""
    np.testing.assert_allclose(out, ref, atol=rel * float(np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("stride,padding,output_padding", [
    (2, 1, 0), (2, 1, 1), ((2, 1, 2), (1, 0, 1), (1, 0, 0)), ((1, 2, 3), 1, (0, 1, 2))])
def test_conv_transpose3d_matches_jax(stride, padding, output_padding):
    x = _input((2, 5, 4, 3, 3), 0)
    k = _input((4, 4, 4, 3, 5), 1) / 8
    ref = np.asarray(jconv.conv_transpose3d(jnp.asarray(x), jnp.asarray(k), stride=stride,
                                            padding=padding, output_padding=output_padding))
    out = tconv.conv_transpose3d(torch.from_numpy(x), torch.from_numpy(k), stride=stride,
                                 padding=padding, output_padding=output_padding).numpy()
    assert out.shape == ref.shape
    _assert_close(out, ref, 1e-5)


def test_library_convs_run_with_tf32_off(monkeypatch):
    """Every F.conv3d / F.conv_transpose3d the port issues sees cuDNN's TF32
    off, and the caller's setting is back after it."""
    seen = []
    for name in ("conv3d", "conv_transpose3d"):
        real = getattr(tconv.F, name)
        monkeypatch.setattr(tconv.F, name, lambda *a, real=real, **k: (
            seen.append(torch.backends.cudnn.allow_tf32), real(*a, **k))[1])
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x, k = torch.ones(1, 4, 4, 4, 2), torch.ones(4, 4, 4, 2, 2)
        tconv.conv3d(x, k, stride=2, padding=1)
        tconv.conv_transpose3d(x, k, stride=2, padding=1)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = previous
    assert seen == [False, False]


@pytest.mark.parametrize("kind,stride,padding,output_padding", [
    ("conv3d", 2, 1, 0), ("conv3d", (2, 1, 2), (1, 0, 1), 0),
    ("conv_transpose3d", 2, 1, 1), ("conv_transpose3d", (2, 1, 2), (1, 0, 1), (1, 0, 0))])
def test_library_conv_gradients_match_jax(kind, stride, padding, output_padding):
    """dX and dW of the strided and transposed library convs, whose backward
    runs under the same TF32-off scope as their forward, against jax.vjp."""
    x = _input((2, 6, 5, 4, 3), 2)
    k = _input((4, 4, 4, 3, 5), 3) / 8
    extra = {"output_padding": output_padding} if kind == "conv_transpose3d" else {}

    def jfn(x, k):
        return getattr(jconv, kind)(x, k, stride=stride, padding=padding, **extra)

    ref, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(k))
    g = _input(ref.shape, 4)
    ref_dx, ref_dk = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tx, tk = (torch.from_numpy(a).requires_grad_() for a in (x, k))
    out = getattr(tconv, kind)(tx, tk, stride=stride, padding=padding, **extra)
    out.backward(torch.from_numpy(g))
    _assert_close(out.detach().numpy(), np.asarray(ref), 1e-5)
    _assert_close(tx.grad.numpy(), ref_dx, 1e-5)
    _assert_close(tk.grad.numpy(), ref_dk, 1e-5)


@pytest.mark.parametrize("kind", ["ws", "blur", "blur_ws", "blur_t", "blur_t_ws", "blur_t_op"])
def test_standardized_and_blurred_convs_match_jax(kind):
    x = _input((2, 8, 6, 4, 3), 2)
    cases = {
        "ws": (jcomp.WSConv3d(features=5, kernel_size=3, padding=1),
               lambda: WSConv3d(3, 5, kernel_size=3, padding=1)),
        "blur": (jcomp.BlurConv3d(features=5),
                 lambda: BlurConv3d(3, 5)),
        "blur_ws": (jcomp.BlurConv3d(features=5, stride=(2, 1, 2), weight_standardization=True),
                    lambda: BlurConv3d(3, 5, stride=(2, 1, 2), weight_standardization=True)),
        "blur_t": (jcomp.BlurConvTranspose3d(features=5),
                   lambda: BlurConvTranspose3d(3, 5)),
        "blur_t_ws": (jcomp.BlurConvTranspose3d(features=5, weight_standardization=True),
                      lambda: BlurConvTranspose3d(3, 5, weight_standardization=True)),
        "blur_t_op": (jcomp.BlurConvTranspose3d(features=5, padding=1, output_padding=1,
                                                use_bias=False),
                      lambda: BlurConvTranspose3d(3, 5, padding=1, output_padding=1,
                                                  use_bias=False)),
    }
    jmodule, make = cases[kind]
    variables = _flax_variables(jmodule, x, 3)
    ref = np.asarray(jmodule.apply(variables, jnp.asarray(x)))
    module = make()
    module.load_state_dict(flax_to_state_dict(variables))
    with torch.inference_mode():
        out = module(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    _assert_close(out, ref, 1e-5)


def _unet_pair(blur: bool, residual: bool):
    jkw, kw = {}, {}
    if blur:
        down = {"kernel_size": 3, "stride": 2, "padding": 1}
        up = {"kernel_size": 3, "stride": 2, "padding": 1, "output_padding": 0}
        jkw = dict(downsample_class=jcomp.BlurConv3d, downsample_params=down,
                   upsample_class=jcomp.BlurConvTranspose3d, upsample_params=up)
        kw = dict(downsample_class=BlurConv3d, downsample_params=down,
                  upsample_class=BlurConvTranspose3d, upsample_params=up)
    jnet = JModularUNet(in_channels=2, out_channels=2, filters=[4, 4, 8], depth=3,
                        block_params={"residual": residual}, remat=True, **jkw)
    net = ModularUNet(2, 2, filters=[4, 4, 8], depth=3, block_params={"residual": residual},
                      remat=True, **kw)
    return jnet, net


@pytest.mark.parametrize("blur", [True, False], ids=["blur", "avgpool_trilinear"])
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "plain"])
def test_modular_unet_matches_jax(blur, residual):
    x = _input((2, 16, 16, 16, 2), 4)
    jnet, net = _unet_pair(blur, residual)
    variables = _flax_variables(jnet, x, 5)
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x), train=False))
    state = flax_to_state_dict(variables)
    assert set(state) == set(net.state_dict())
    net.load_state_dict(state)
    net.eval()
    with torch.inference_mode():
        out = net(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 16, 2)
    # softmax probabilities after the network
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    # the weight bridge is exact both ways
    back = state_dict_to_flax(net.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)


def test_modular_unet_names_samplers_and_widths():
    net = ModularUNet(2, 2, filters=[4, 6, 8], depth=3, block_params={"residual": True},
                      downsample_class=BlurConv3d, upsample_class=BlurConvTranspose3d)
    widths = {name: tuple(m.weight.shape[:2]) for name, m in net.named_children()
              if hasattr(m, "weight")}
    assert widths == {"down_0": (4, 4), "down_1": (6, 6), "up_0": (6, 6), "up_1": (8, 8),
                      "out_conv": (2, 4)}
    assert net.up_block_0.Conv3d_0.weight.shape[:2] == (4, 10)
    assert net.up_block_1.Conv3d_0.weight.shape[:2] == (6, 14)
    assert net.down_block_2.Conv3d_0.weight.shape[:2] == (8, 6)
    plain = ModularUNet(1, 3, filters=5, depth=2)
    assert isinstance(plain.down_0, AvgPoolDown) and isinstance(plain.up_0, TrilinearUp)
    assert plain.up_block_0.Conv3d_0.weight.shape[:2] == (5, 10)
    with pytest.raises(ValueError, match="does not match depth"):
        ModularUNet(2, 2, filters=[4, 8], depth=3)
    plain.train()
    plain(torch.zeros(1, 4, 4, 4, 1))
    remat = ModularUNet(1, 3, filters=5, depth=2, remat=True)
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(_input((1, 4, 4, 4, 1), 3))
    out = remat(x)
    out.sum().backward()
    assert torch.equal(out, plain(x)) and torch.isfinite(out).all()
    assert all(p.grad is not None for p in remat.parameters())


def test_segmodel_initializes_every_blurred_conv():
    def make(seed):
        net = ModularUNet(2, 2, filters=[4, 4, 8], depth=3, block_params={"residual": True},
                          downsample_class=BlurConv3d, upsample_class=BlurConvTranspose3d)
        with torch.no_grad():
            for p in net.parameters():
                p.fill_(float("nan"))
        model = SegModel(net, seed=seed, device="cpu")
        model.ensure_initialized()
        return net

    net, again, other = make(3), make(3), make(4)
    blurred = [m for m in net.modules() if isinstance(m, (BlurConv3d, BlurConvTranspose3d))]
    assert len(blurred) == 4
    for m in blurred:
        bound = 1 / np.sqrt(np.prod(m.weight.shape[1:]))
        assert torch.isfinite(m.weight).all() and m.weight.abs().max() <= bound
        assert m.weight.std() > bound / 4
        assert torch.equal(m.bias, torch.zeros_like(m.bias))
    assert all(torch.isfinite(p).all() for p in net.parameters())
    for (name, a), b, c in zip(net.state_dict().items(), again.state_dict().values(),
                               other.state_dict().values()):
        assert torch.equal(a, b), name
        if name.endswith("weight") and a.dim() == 5:
            assert not torch.equal(a, c), name
