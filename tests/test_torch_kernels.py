"""The hand-written 3x3x3 conv kernel's wrapper and its plain version.

This file imports neither JAX nor the JAX package, so that the tests marked
``cuda`` also run on a machine with a GPU and only the port installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Without a GPU they skip; the rest run on the CPU.
"""
import numpy as np
import pytest
import torch

from segmentation_pipeline_torch.ops.conv3x3 import conv3x3_s1p1, conv3x3_s1p1_plain

torch.set_num_threads(2)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def test_plain_bf16_rounds_only_the_output():
    """bf16 in, bf16 out, f32 sums: equal to the f32 result on the same
    bf16 values up to one bf16 rounding (2**-8 relative)."""
    x = torch.from_numpy(_normal((1, 4, 5, 6, 7), 6)).bfloat16()
    k = torch.from_numpy(_normal((3, 3, 3, 7, 3), 7)).bfloat16()
    out = conv3x3_s1p1(x, k)
    ref = conv3x3_s1p1_plain(x.float(), k.float())
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, atol=1e-6, rtol=2 ** -8)


def test_cpu_calls_do_not_count_launches():
    before = conv3x3_s1p1.launches
    conv3x3_s1p1(torch.zeros(1, 2, 2, 2, 3), torch.zeros(3, 3, 3, 3, 2))
    assert conv3x3_s1p1.launches == before


@pytest.mark.parametrize("x_shape,k_shape", [((1, 2, 2, 2, 3), (3, 3, 3, 4, 2)),
                                             ((2, 2, 2, 3), (3, 3, 3, 3, 2)),
                                             ((1, 2, 2, 2, 3), (3, 3, 1, 3, 2))])
def test_wrapper_rejects_what_the_kernel_does_not_take(x_shape, k_shape):
    with pytest.raises(ValueError):
        conv3x3_s1p1(torch.zeros(x_shape), torch.zeros(k_shape))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 5, 7, 3, 2), (2, 12, 22, 6, 120, 40),
                                   (1, 9, 17, 11, 80, 70)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    n, w, h, d, cin, cout = shape
    x = torch.from_numpy(_normal((n, w, h, d, cin), 10)).to(cuda_device, dtype)
    k = torch.from_numpy(_normal((3, 3, 3, cin, cout), 11)).to(cuda_device, dtype)
    before = conv3x3_s1p1.launches
    out = conv3x3_s1p1(x, k)
    torch.cuda.synchronize()
    assert conv3x3_s1p1.launches == before + 1 and out.dtype == dtype
    ref = conv3x3_s1p1_plain(x.float(), k.float())
    # f32: sums of up to 27*120 products in another order; bf16: one rounding
    # of the output to 8 bits of mantissa
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = (out.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item()
