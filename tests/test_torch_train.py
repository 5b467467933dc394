"""The parts of the port's train step against the JAX package's: the 3x3x3
conv's gradients (the Pallas kernel's custom VJP, in interpret mode), the
hybrid loss, the optimizers, Block3d in train mode and channel dropout.

Inputs are made with numpy from a seed and go through both packages. On the
CPU the port's conv Function runs its plain versions; the CUDA kernels are
held against those in test_torch_kernels.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segmentation_pipeline_tpu.criterions import HybridLogisticDiceLoss as JLoss
from segmentation_pipeline_tpu.models import Block3d as JBlock3d
from segmentation_pipeline_tpu.ops.pallas_conv import pallas_conv3d_3x3_s1p1
from segmentation_pipeline_tpu.training import optimizers as joptim
from segmentation_pipeline_torch import HybridLogisticDiceLoss
from segmentation_pipeline_torch.models import Block3d, channel_dropout, flax_to_state_dict
from segmentation_pipeline_torch.ops import conv3x3 as tconv3x3
from segmentation_pipeline_torch.ops.conv3x3 import Conv3x3S1P1
from segmentation_pipeline_torch.training import optimizers as toptim

torch.set_num_threads(2)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# (N, W, H, D, Cin, Cout): the input convs' Cin 3, Cin 2, the out conv's
# Cout 2, and Cout > Cin
GRAD_SHAPES = [(2, 4, 5, 3, 3, 2), (1, 3, 4, 5, 2, 6), (2, 4, 3, 4, 5, 2)]


@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_conv_gradients_match_pallas_vjp(shape):
    """dX and dW of the port's Function on the CPU against jax.vjp of the
    Pallas kernel's custom VJP (interpret mode), for the same cotangent."""
    n, w, h, d, cin, cout = shape
    x, k = _normal((n, w, h, d, cin), 0), _normal((3, 3, 3, cin, cout), 1)
    g = _normal((n, w, h, d, cout), 2)
    with pltpu.force_tpu_interpret_mode():
        out_ref, vjp = jax.vjp(pallas_conv3d_3x3_s1p1, jnp.asarray(x), jnp.asarray(k))
        dx_ref, dk_ref = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    out = Conv3x3S1P1.apply(xt, kt)
    out.backward(torch.from_numpy(g))
    # f32 sums of up to 27*Cout (dX) and N*W*H*D = 120 (dW) products of
    # N(0,1) values in another order than XLA's: a few ulps of the sums
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), dx_ref, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(kt.grad.numpy(), dk_ref, atol=1e-4, rtol=1e-5)


# (N, W, H, D, Cin, Cout): the input convs' Cin 3, Cin 16 -> Cout 24 (two
# and three channel groups of 8), the out conv's Cout 2
BF16_DW_SHAPES = [(2, 4, 5, 3, 3, 8), (1, 4, 6, 5, 16, 24), (2, 5, 3, 4, 8, 2)]


@pytest.mark.parametrize("shape", BF16_DW_SHAPES)
def test_conv_weight_gradient_bf16_matches_pallas_vjp(shape):
    """The port's dW on bf16 CPU tensors (the plain version that the bf16
    tensor-core kernel is held to on the card) against the dW of jax.vjp of
    the Pallas kernel (interpret mode) on the same bf16 inputs: bf16 x bf16
    products summed in f32, rounded once to bf16."""
    n, w, h, d, cin, cout = shape
    x, k = _normal((n, w, h, d, cin), 20), _normal((3, 3, 3, cin, cout), 21)
    g = _normal((n, w, h, d, cout), 22)
    xb, kb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, k, g))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(pallas_conv3d_3x3_s1p1, xb, kb)
        dk_ref = np.asarray(vjp(gb)[1].astype(jnp.float32))
        # the same bf16 values in f32: JAX's f32 sums before the rounding
        _, vjp32 = jax.vjp(pallas_conv3d_3x3_s1p1, xb.astype(jnp.float32),
                           kb.astype(jnp.float32))
        dk_sum = np.asarray(vjp32(gb.astype(jnp.float32))[1])
    dk = tconv3x3.conv3x3_s1p1_dw(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16())
    assert dk.dtype == torch.bfloat16 and dk.shape == (3, 3, 3, cin, cout)
    dk = dk.float().numpy()
    # one rounding of the f32 sum to bf16 (unit roundoff 2**-8), plus f32
    # sums of at most 120 products of N(0,1) values in another order (atol)
    np.testing.assert_allclose(dk, dk_sum, rtol=2 ** -8, atol=1e-4)
    # against JAX's bf16 result: each side rounds its own f32 sum once, so
    # the two may land on neighbouring bf16 values, 2 * 2**-8 apart
    np.testing.assert_allclose(dk, dk_ref, rtol=2 ** -7, atol=1e-4)


def test_conv_input_gradient_only_where_needed(monkeypatch):
    """The convs that read the network's input run no dX."""
    calls = []
    dx = tconv3x3.conv3x3_s1p1_dx
    monkeypatch.setattr(tconv3x3, "conv3x3_s1p1_dx", lambda *a: calls.append(1) or dx(*a))
    x = torch.from_numpy(_normal((1, 3, 3, 3, 3), 3))
    k = torch.from_numpy(_normal((3, 3, 3, 3, 4), 4)).requires_grad_()
    Conv3x3S1P1.apply(x, k).sum().backward()
    assert calls == [] and x.grad is None and k.grad is not None
    Conv3x3S1P1.apply(x.clone().requires_grad_(), k).sum().backward()
    assert calls == [1]


def test_conv_adds_no_graph_in_inference_mode():
    x = torch.from_numpy(_normal((1, 3, 3, 3, 2), 5))
    k = torch.nn.Parameter(torch.from_numpy(_normal((3, 3, 3, 2, 2), 6)))
    with torch.inference_mode():
        out = Conv3x3S1P1.apply(x, k)
        ref = tconv3x3.conv3x3_s1p1(x, k)
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, ref)


def _prediction_and_target(seed, classes=3):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(2, 4, 5, 3, classes)).astype(np.float32)
    pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    target = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, size=(2, 4, 5, 3))]
    return pred.astype(np.float32), target


@pytest.mark.parametrize("kwargs", [{}, {"dice_weight": 0.3,
                                         "logistic_class_weights": [1.0, 2.0, 0.5]},
                                    {"square_dice": False}],
                         ids=["default", "class_weights", "linear_dice"])
def test_loss_and_its_gradient_match_jax(kwargs):
    pred, target = _prediction_and_target(7)
    jloss = JLoss(**kwargs)
    ref = {k: float(v) for k, v in jloss(jnp.asarray(pred), jnp.asarray(target)).items()}
    ref_grad = np.asarray(jax.grad(lambda p: jloss(p, jnp.asarray(target))["loss"])(
        jnp.asarray(pred)))
    p = torch.from_numpy(pred).requires_grad_()
    out = HybridLogisticDiceLoss(**kwargs)(p, torch.from_numpy(target))
    out["loss"].backward()
    # f32 sums over 60 voxels in another order
    for key, value in ref.items():
        np.testing.assert_allclose(out[key].item(), value, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p.grad.numpy(), ref_grad, rtol=1e-5, atol=1e-8)


OPTIMIZERS = [
    ("Adam", {"lr": 1e-2}),
    ("Adam", {"lr": 1e-2, "weight_decay": 0.1}),
    ("Adam", {"lr": 1e-2, "weight_decay": 0.1, "decoupled": True}),
    ("SGD", {"lr": 0.1, "momentum": 0.9}),
    ("SGD", {"lr": 0.1, "momentum": 0.9, "nesterov": True, "weight_decay": 0.05}),
]


@pytest.mark.parametrize("name,kwargs", OPTIMIZERS,
                         ids=["adam", "adam_l2", "adamw", "sgd_momentum", "sgd_nesterov"])
def test_optimizer_matches_optax(name, kwargs):
    """The same 5-step gradient sequence through the optax transformation
    and the torch optimizer the port's factory makes."""
    params0 = _normal((6, 5), 8)
    grads = [_normal((6, 5), 9 + i) for i in range(5)]
    tx = getattr(joptim, name)(**kwargs)
    params, state = jnp.asarray(params0), None
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(params0.copy()))
    opt = getattr(toptim, name)(**kwargs).init([p])
    for grad in grads:
        updates, state = tx.update(jnp.asarray(grad), state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(grad)
        opt.step()
    # the same arithmetic in another order: f32 rounding of O(1) values
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), atol=1e-6, rtol=1e-6)


def test_optimizer_factory_rejects_accumulation():
    with pytest.raises(NotImplementedError):
        toptim.Adam(lr=1e-3, accumulate_steps=4)
    with pytest.raises(NotImplementedError):
        toptim.SGD(accumulate_steps=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block3d_train_mode_matches_flax(dtype):
    """Three train-mode steps on different inputs: outputs and the running
    statistics, which flax updates with the *biased* batch variance (torch's
    BatchNorm3d uses the unbiased one, 0.4% larger over these 240 voxels)."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xs = [np.random.default_rng(10 + i).uniform(-1, 1, (2, 6, 5, 4, 5)).astype(np.float32)
          for i in range(3)]
    jblock = JBlock3d(features=8, residual=True)
    variables = jax.jit(functools.partial(jblock.init, train=False))(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(xs[0]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    block = Block3d(5, 8, residual=True).train()
    block.load_state_dict(flax_to_state_dict(variables))
    apply = jax.jit(functools.partial(jblock.apply, train=True, mutable=["batch_stats"]))
    for x in xs:
        ref, new = apply(variables, jnp.asarray(x, dtype=jdtype))
        variables = {"params": variables["params"], "batch_stats": new["batch_stats"]}
        out = block(torch.from_numpy(x).to(dtype))
        assert out.dtype == dtype
        # f32: rounding of convs and statistics in another order; bf16: the
        # two frameworks round activations to 8 bits at other places
        tol = 1e-5 if dtype == torch.float32 else 3e-2
        np.testing.assert_allclose(out.detach().float().numpy(),
                                   np.asarray(ref, dtype=np.float32), atol=tol, rtol=tol)
    for name, stats in variables["batch_stats"].items():
        bn = getattr(block, name)
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], atol=1e-6,
                                   rtol=1e-5 if dtype == torch.float32 else 2e-2)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], atol=1e-6,
                                   rtol=1e-5 if dtype == torch.float32 else 2e-2)
        assert bn.num_batches_tracked.item() == 3


def test_channel_dropout_masks_whole_channels():
    p = 0.2
    x = torch.ones(4, 3, 2, 2, 1000)
    out = channel_dropout(x, p, torch.Generator().manual_seed(0))
    # one draw per (sample, channel), broadcast over (W, H, D)
    assert torch.equal(out, out[:, :1, :1, :1].expand_as(out))
    kept = out[:, 0, 0, 0] != 0
    torch.testing.assert_close(out[:, 0, 0, 0][kept], torch.full((int(kept.sum()),),
                                                                1 / (1 - p)))
    assert (out[:, 0, 0, 0][~kept] == 0).all()
    # 4000 draws: the keep share is within 0.02 (about 4 standard errors) of 0.8
    assert abs(kept.float().mean().item() - (1 - p)) < 0.02
    again = channel_dropout(x, p, torch.Generator().manual_seed(0))
    other = channel_dropout(x, p, torch.Generator().manual_seed(1))
    assert torch.equal(out, again) and not torch.equal(out, other)


def test_block3d_dropout_needs_a_generator_in_train_mode_only():
    block = Block3d(2, 16, dropout_p=0.2)
    x = torch.from_numpy(_normal((2, 4, 4, 4, 2), 11))
    with pytest.raises(ValueError, match="Generator"):
        block.train()(x)
    out = block(x, torch.Generator().manual_seed(3))
    channels = out.detach().abs().sum(dim=(1, 2, 3))
    assert (channels == 0).any() and (channels > 0).any()
    block.eval()
    with torch.inference_mode():
        assert torch.equal(block(x), block(x, torch.Generator().manual_seed(4)))
