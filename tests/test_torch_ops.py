"""The port's conv, pooling and upsampling ops against the JAX package's.

Inputs are made with numpy from a seed and go through both packages. On the
CPU the port's 3x3x3 conv runs its plain PyTorch version; the hand-written
CUDA kernel itself is held against that plain version on the card in
test_torch_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segmentation_pipeline_tpu.ops import convolution as jconv
from segmentation_pipeline_tpu.ops.pallas_conv import pallas_conv3d_3x3_s1p1
from segmentation_pipeline_torch.ops import convolution as tconv
from segmentation_pipeline_torch.ops.conv3x3 import conv3x3_s1p1

torch.set_num_threads(2)

# f32 sums of up to 27*Cin products of N(0,1) values, taken in another order
# than XLA's: a few ulps of the sum's magnitude (~20 here).
CONV_ATOL, CONV_RTOL = 1e-4, 1e-5


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# (N, W, H, D, Cin, Cout): the first block's Cin=3, the out conv's Cout=2,
# odd and non-power-of-two sizes, and a size of 1.
CONV_SHAPES = [(2, 6, 5, 7, 3, 2), (1, 5, 9, 3, 8, 5), (2, 4, 4, 4, 12, 8),
               (1, 3, 1, 6, 5, 3)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_matches_jax_xla(shape):
    n, w, h, d, cin, cout = shape
    x = _normal((n, w, h, d, cin), 0)
    k = _normal((3, 3, 3, cin, cout), 1)
    ref = np.asarray(jconv.conv3d(jnp.asarray(x), jnp.asarray(k), stride=1, padding=1))
    out = tconv.conv3d(torch.from_numpy(x), torch.from_numpy(k), stride=1, padding=1)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=CONV_ATOL, rtol=CONV_RTOL)


@pytest.mark.parametrize("shape", [(2, 5, 6, 3, 3, 2), (1, 4, 3, 5, 6, 4)])
def test_conv_matches_pallas_interpret(shape):
    n, w, h, d, cin, cout = shape
    x = _normal((n, w, h, d, cin), 2)
    k = _normal((3, 3, 3, cin, cout), 3)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_conv3d_3x3_s1p1(jnp.asarray(x), jnp.asarray(k)))
    out = conv3x3_s1p1(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(out.numpy(), ref, atol=CONV_ATOL, rtol=CONV_RTOL)


@pytest.mark.parametrize("ksize,stride,padding", [(3, 2, 1), (1, 1, 0), (3, 1, 0),
                                                  (2, 2, 0)])
def test_conv_other_shapes_match_jax(ksize, stride, padding):
    """Shapes outside the kernel's class go to F.conv3d, as JAX sends them
    to XLA; the kernel's launch count does not move."""
    x = _normal((2, 7, 6, 5, 4), 4)
    k = _normal((ksize, ksize, ksize, 4, 3), 5)
    ref = np.asarray(jconv.conv3d(jnp.asarray(x), jnp.asarray(k), stride=stride,
                                  padding=padding))
    before = conv3x3_s1p1.launches
    out = tconv.conv3d(torch.from_numpy(x), torch.from_numpy(k), stride=stride,
                       padding=padding)
    assert conv3x3_s1p1.launches == before
    np.testing.assert_allclose(out.numpy(), ref, atol=CONV_ATOL, rtol=CONV_RTOL)


@pytest.mark.parametrize("ksize,stride,padding,output_padding",
                         [(3, 2, 1, 0), (3, 2, 1, 1), (2, 2, 0, 0), (3, 3, 1, 2), (1, 2, 0, 1)])
def test_transposed_conv_by_phases_matches_jax(ksize, stride, padding, output_padding,
                                               monkeypatch):
    """Without a gradient (serving) the float32 transposed conv runs as one
    forward conv by output phase under cuDNN's deterministic flag: equal to
    JAX's conv_transpose3d and to the path that records a gradient
    (F.conv_transpose3d), and the same bits again on a second call; the
    bfloat16 one runs F.conv_transpose3d under the flag."""
    x = _normal((2, 5, 6, 4, 4), 6)
    k = _normal((ksize, ksize, ksize, 4, 3), 7)
    conv = dict(stride=stride, padding=padding, output_padding=output_padding)
    ref = np.asarray(jconv.conv_transpose3d(jnp.asarray(x), jnp.asarray(k), **conv))
    flags = []
    conv3d = torch.nn.functional.conv3d

    def recording(*args, **kwargs):
        flags.append(torch.backends.cudnn.deterministic)
        return conv3d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv3d", recording)
    with torch.no_grad():
        served = tconv.conv_transpose3d(torch.from_numpy(x), torch.from_numpy(k), **conv)
    assert flags == [True]
    assert not torch.backends.cudnn.deterministic
    trained = tconv.conv_transpose3d(torch.from_numpy(x), torch.from_numpy(k), **conv)
    assert served.shape == trained.shape == ref.shape
    np.testing.assert_allclose(served.numpy(), ref, atol=CONV_ATOL, rtol=CONV_RTOL)
    np.testing.assert_allclose(served.numpy(), trained.detach().numpy(), atol=1e-5, rtol=1e-6)
    with torch.no_grad():
        again = tconv.conv_transpose3d(torch.from_numpy(x), torch.from_numpy(k), **conv)
    assert torch.equal(again, served)
    # bfloat16 serving stays on the library's transposed conv, deterministic
    transposed = torch.nn.functional.conv_transpose3d

    def recording_transposed(*args, **kwargs):
        flags.append(torch.backends.cudnn.deterministic)
        return transposed(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv_transpose3d", recording_transposed)
    flags.clear()
    with torch.no_grad():
        served = tconv.conv_transpose3d(torch.from_numpy(x).bfloat16(),
                                        torch.from_numpy(k).bfloat16(), **conv)
    assert flags == [True] and served.dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(2, 6, 4, 2, 3), (1, 5, 7, 3, 2), (1, 2, 2, 2, 1)])
def test_avg_pool3d_matches_jax(shape):
    x = _normal(shape, 8)
    ref = np.asarray(jconv.avg_pool3d(jnp.asarray(x), 2, 2))
    out = tconv.avg_pool3d(torch.from_numpy(x), 2)
    assert out.shape == ref.shape
    # a sum of 8 values over 8, in another order: f32 rounding only
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", [(1, 2, 2, 1, 3), (2, 3, 4, 2, 2), (1, 1, 5, 1, 4)])
def test_upsample_trilinear2x_matches_jax(shape):
    """Includes axes of size 1 (the deepest level of a 16x16x8 input)."""
    x = _normal(shape, 9)
    ref = np.asarray(jconv.upsample_trilinear2x(jnp.asarray(x), align_corners=True))
    out = tconv.upsample_trilinear2x(torch.from_numpy(x), align_corners=True)
    assert out.shape == ref.shape
    # XLA applies the interpolation as three matmuls, torch as one gather:
    # the same weights, summed in another order
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-5)
