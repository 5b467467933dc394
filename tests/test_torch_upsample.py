"""The hand-written 2x trilinear upsample kernels' wrappers (forward and
input gradient), their autograd Function and their plain versions.

This file imports neither JAX nor the JAX package, so that the tests marked
``cuda`` also run on a machine with a GPU and only the port installed:

    python -m pytest --noconftest -m cuda tests/test_torch_upsample.py

Without a GPU they skip; the rest run on the CPU.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import segmentation_pipeline_torch as tsp
from segmentation_pipeline_torch.ops import convolution
from segmentation_pipeline_torch.ops.upsample import (WRAPPERS, UpsampleTrilinear2x,
                                                      reset_launch_counts,
                                                      upsample_trilinear2x,
                                                      upsample_trilinear2x_dx,
                                                      upsample_trilinear2x_dx_plain,
                                                      upsample_trilinear2x_plain)
from segmentation_pipeline_torch.utils import timer

torch.set_num_threads(2)

# one rounding of an f32 blend of 8 values in another order than ATen's,
# relative to the largest input
F32_BLEND = 2.0 ** -20
# bf16 keeps 8 significant bits: one rounding moves a value by at most
# 2**-8 of itself
BF16_ROUNDING = 2.0 ** -8


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _interpolate(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate's align-corners 2x upsample of channels-last x, with
    its autograd."""
    _, w, h, d, _ = x.shape
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=(2 * w, 2 * h, 2 * d),
                      mode="trilinear", align_corners=True)
    return y.permute(0, 2, 3, 4, 1)


def _assert_upsample_close(out: torch.Tensor, x: torch.Tensor) -> None:
    """out within one rounding of its type of F.interpolate's f32 result on
    x's values."""
    ref = _interpolate(x.float())
    err = (out.float() - ref).abs()
    tol = F32_BLEND * x.float().abs().max().item()
    tol = tol + (BF16_ROUNDING * ref.abs() if out.dtype == torch.bfloat16 else 0)
    assert bool((err <= tol).all()), err.max().item()


def _assert_gradient_close(dx: torch.Tensor, g: torch.Tensor) -> None:
    """dx against F.interpolate's autograd in f32 on g's values: up to 125
    products of weights summing to at most 8, added in another order, then
    one rounding of dx's type."""
    x = torch.zeros(dx.shape, device=g.device, requires_grad=True)
    ref, = torch.autograd.grad(_interpolate(x), x, g.float())
    err = (dx.float() - ref).abs()
    tol = 125 * 8 * 2.0 ** -24 * g.float().abs().max().item()
    tol = tol + (BF16_ROUNDING * ref.abs() if dx.dtype == torch.bfloat16 else 0)
    assert bool((err <= tol).all()), err.max().item()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (1, 2, 2, 2, 3, 1)])
def test_wrapper_rejects_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        upsample_trilinear2x(torch.zeros(shape))


@pytest.mark.parametrize("g_shape,input_shape", [((1, 4, 4, 4, 3), (1, 2, 2, 2, 2)),
                                                 ((1, 4, 4, 3, 3), (1, 2, 2, 2, 3)),
                                                 ((4, 4, 4, 3), (2, 2, 2, 3))])
def test_dx_wrapper_rejects_what_the_kernel_does_not_take(g_shape, input_shape):
    with pytest.raises(ValueError):
        upsample_trilinear2x_dx(torch.zeros(g_shape), input_shape)


def test_wrapper_rejects_devices_other_than_cuda_and_cpu():
    x = torch.zeros((1, 2, 2, 2, 3), device="meta")
    with pytest.raises(ValueError):
        upsample_trilinear2x(x)


def test_cpu_calls_run_the_plain_versions_and_count_no_launches():
    timer.reset()
    before = [w.launches for w in WRAPPERS]
    x = torch.from_numpy(_normal((2, 3, 4, 2, 5), 1))
    g = torch.from_numpy(_normal((2, 6, 8, 4, 5), 2))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = upsample_trilinear2x(x)
        dx = upsample_trilinear2x_dx(g, x.shape)
    assert [w.launches for w in WRAPPERS] == before
    assert "upsample" not in timer.recorded()["counters"]
    assert torch.equal(out, upsample_trilinear2x_plain(x))
    assert torch.equal(dx, upsample_trilinear2x_dx_plain(g, x.shape))


@pytest.mark.parametrize("shape", [(2, 3, 4, 2, 5), (1, 1, 5, 1, 2), (1, 6, 11, 3, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_on_cpu_matches_interpolate_and_its_gradient(shape, dtype):
    """The Function's CPU forward and gradient are F.interpolate's and its
    autograd's, bit for bit."""
    x = torch.from_numpy(_normal(shape, 3)).to(dtype)
    n, w, h, d, c = shape
    g = torch.from_numpy(_normal((n, 2 * w, 2 * h, 2 * d, c), 4)).to(dtype)
    ours = x.clone().requires_grad_()
    out = UpsampleTrilinear2x.apply(ours)
    out.backward(g)
    ref_x = x.clone().requires_grad_()
    ref = _interpolate(ref_x)
    ref.backward(g)
    assert torch.equal(out, ref)
    assert torch.equal(ours.grad, ref_x.grad)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_align_corners_false_raises_on_every_device(device):
    x = torch.zeros((1, 3, 4, 2, 2), device=device)
    with pytest.raises(ValueError):
        convolution.upsample_trilinear2x(x, align_corners=False)


def test_network_upsamples_through_the_function(monkeypatch):
    """The NestedResUNet's 6 upsamples a forward go through the Function."""
    module = tsp.NestedResUNet(3, 2, filters=4, dropout_p=0.0)
    x = torch.from_numpy(_normal((1, 16, 16, 8, 3), 6))
    calls = []
    original = UpsampleTrilinear2x.forward

    def spy(ctx, t):
        calls.append(tuple(t.shape))
        return original(ctx, t)

    monkeypatch.setattr(UpsampleTrilinear2x, "forward", staticmethod(spy))
    module(x).sum().backward()
    assert calls == [(1, 8, 8, 4, 4), (1, 4, 4, 2, 4), (1, 8, 8, 4, 4), (1, 2, 2, 1, 4),
                     (1, 4, 4, 2, 4), (1, 8, 8, 4, 4)]


# the NestedResUNet's three level classes of the TTA batch's half-volumes
# (48x88x24 at level 0) at a small N, the odd deepest grid, a size-1 axis,
# and channel counts 16 bytes do not divide
SHAPES = [(2, 24, 44, 12, 40), (2, 12, 22, 6, 40), (2, 6, 11, 3, 40), (1, 6, 11, 3, 80),
          (1, 5, 1, 3, 8), (2, 3, 4, 5, 2), (2, 3, 4, 5, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_interpolate_on_card(cuda_device, dtype, shape):
    """Within one rounding of the output type of F.interpolate's f32 result
    on the same values."""
    x = torch.from_numpy(_normal(shape, 10)).to(cuda_device, dtype)
    before = upsample_trilinear2x.launches
    out = upsample_trilinear2x(x)
    torch.cuda.synchronize()
    assert upsample_trilinear2x.launches == before + 1
    assert out.dtype == dtype and out.is_contiguous()
    _assert_upsample_close(out, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_matches_interpolate_autograd_on_card(cuda_device, dtype, shape):
    """Against F.interpolate's autograd in f32 on the same cotangent
    values."""
    n, w, h, d, c = shape
    g = torch.from_numpy(_normal((n, 2 * w, 2 * h, 2 * d, c), 11)).to(cuda_device, dtype)
    before = upsample_trilinear2x_dx.launches
    dx = upsample_trilinear2x_dx(g, shape)
    torch.cuda.synchronize()
    assert upsample_trilinear2x_dx.launches == before + 1 and dx.dtype == dtype
    _assert_gradient_close(dx, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradient_is_bitwise_repeatable_on_card(cuda_device, dtype):
    shape = (4, 24, 44, 12, 40)
    n, w, h, d, c = shape
    g = torch.from_numpy(_normal((n, 2 * w, 2 * h, 2 * d, c), 12)).to(cuda_device, dtype)
    first = upsample_trilinear2x_dx(g, shape)
    second = upsample_trilinear2x_dx(g, shape)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_addresses_take_the_scalar_path_on_card(cuda_device, dtype):
    """Tensors 16 bytes do not align go one channel a thread, held to the
    same limits."""
    shape = (2, 6, 11, 3, 40)
    x = torch.from_numpy(_normal(shape, 14)).to(cuda_device, dtype)
    n, w, h, d, c = shape
    g = torch.from_numpy(_normal((n, 2 * w, 2 * h, 2 * d, c), 15)).to(cuda_device, dtype)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=dtype, device=cuda_device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    _assert_upsample_close(upsample_trilinear2x(shifted(x)), x)
    _assert_gradient_close(upsample_trilinear2x_dx(shifted(g), shape), g)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take_on_card(cuda_device):
    x = torch.zeros((1, 2, 2, 2, 4), device=cuda_device)
    with pytest.raises(TypeError):
        upsample_trilinear2x(x.half())
    with pytest.raises(ValueError):
        upsample_trilinear2x(x.transpose(1, 2))
    with pytest.raises(ValueError):
        upsample_trilinear2x(torch.zeros((1, 0, 2, 2, 4), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_network_launches_six_of_each_direction_on_card(cuda_device, dtype):
    """6 forward launches per NestedResUNet forward and 6 gradient launches
    per backward, on the launch counts and on the profiler's counter."""
    module = tsp.NestedResUNet(3, 2, filters=8, dropout_p=0.0).to(cuda_device)
    x = torch.from_numpy(_normal((2, 16, 16, 8, 3), 13)).to(cuda_device, dtype)
    reset_launch_counts()
    timer.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        module(x).float().sum().backward()
    torch.cuda.synchronize()
    assert [w.launches for w in WRAPPERS] == [6, 6]
    counted = timer.recorded()["counters"]["upsample"]
    timer.reset()
    assert sum(v for k, v in counted.items() if k[0] == "forward") == 6
    assert sum(v for k, v in counted.items() if k[0] == "backward") == 6
    assert {k[1] for k in counted} == {str(dtype).replace("torch.", "")}
