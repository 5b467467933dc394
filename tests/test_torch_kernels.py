"""The hand-written 3x3x3 conv kernels' wrappers (forward, input gradient
dX, weight gradient dW), their autograd Function and their plain versions.

This file imports neither JAX nor the JAX package, so that the tests marked
``cuda`` also run on a machine with a GPU and only the port installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Without a GPU they skip; the rest run on the CPU.
"""
import numpy as np
import pytest
import torch

from segmentation_pipeline_torch.ops.conv3x3 import (WRAPPERS, Conv3x3S1P1, conv3x3_s1p1,
                                                     conv3x3_s1p1_dw, conv3x3_s1p1_dw_plain,
                                                     conv3x3_s1p1_dx, conv3x3_s1p1_dx_plain,
                                                     conv3x3_s1p1_plain)

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


def test_function_on_cpu_runs_plain_versions_and_counts_no_launches():
    before = [w.launches for w in WRAPPERS]
    x = torch.from_numpy(_normal((1, 3, 4, 2, 3), 1)).requires_grad_()
    k = torch.from_numpy(_normal((3, 3, 3, 3, 2), 2)).requires_grad_()
    g = torch.from_numpy(_normal((1, 3, 4, 2, 2), 3))
    Conv3x3S1P1.apply(x, k).backward(g)
    assert [w.launches for w in WRAPPERS] == before
    assert torch.equal(x.grad, conv3x3_s1p1_dx_plain(g, k.detach()))
    assert torch.equal(k.grad, conv3x3_s1p1_dw_plain(x.detach(), g))


@pytest.mark.parametrize("g_shape,k_shape", [((1, 2, 2, 2, 3), (3, 3, 3, 4, 2)),
                                             ((2, 2, 2, 3), (3, 3, 3, 3, 3)),
                                             ((1, 2, 2, 2, 3), (3, 3, 1, 3, 3))])
def test_dx_wrapper_rejects_what_the_kernel_does_not_take(g_shape, k_shape):
    with pytest.raises(ValueError):
        conv3x3_s1p1_dx(torch.zeros(g_shape), torch.zeros(k_shape))


@pytest.mark.parametrize("x_shape,g_shape", [((1, 2, 2, 2, 3), (1, 2, 2, 3, 2)),
                                             ((2, 2, 2, 3), (2, 2, 2, 3)),
                                             ((1, 2, 2, 2, 3), (2, 2, 2, 2, 3))])
def test_dw_wrapper_rejects_what_the_kernel_does_not_take(x_shape, g_shape):
    with pytest.raises(ValueError):
        conv3x3_s1p1_dw(torch.zeros(x_shape), torch.zeros(g_shape))


def test_dw_plain_is_the_definition():
    """dk[tap, ci, co] = sum over voxels of x shifted by the tap times g, x
    zero outside the volume: a loop over voxels in float64."""
    x = _normal((1, 3, 2, 4, 2), 4).astype(np.float64)
    g = _normal((1, 3, 2, 4, 3), 5).astype(np.float64)
    ref = np.zeros((3, 3, 3, 2, 3))
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    for dw, dh, dd, w, h, d in np.ndindex(3, 3, 3, 3, 2, 4):
        ref[dw, dh, dd] += np.outer(xp[0, w + dw, h + dh, d + dd], g[0, w, h, d])
    out = conv3x3_s1p1_dw_plain(torch.from_numpy(x).float(), torch.from_numpy(g).float())
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("x_shape,k_shape", [((1, 2, 2, 2, 3), (3, 3, 3, 4, 2)),
                                             ((2, 2, 2, 3), (3, 3, 3, 3, 2)),
                                             ((1, 2, 2, 2, 3), (3, 3, 1, 3, 2))])
def test_wrapper_rejects_what_the_kernel_does_not_take(x_shape, k_shape):
    with pytest.raises(ValueError):
        conv3x3_s1p1(torch.zeros(x_shape), torch.zeros(k_shape))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 5, 7, 3, 2), (2, 12, 22, 6, 120, 40),
                                   (1, 9, 17, 11, 80, 70), (1, 7, 13, 10, 40, 120)])
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


# dX and dW classes: Cin 3 (the input convs), Cout 2 (the out conv), Cout
# above 64 (two Cout blocks), and sizes that leave partial 4x8x8 tiles; Cin
# 120 puts eight 16-channel chunks and every pairing of taps in an m16 tile
# of the bf16 dW kernel in play, Cin 8 -> Cout 8 one channel group each way
GRAD_SHAPES = [(2, 6, 5, 7, 3, 2), (2, 12, 22, 6, 40, 120), (1, 9, 17, 11, 80, 70),
               (2, 6, 11, 3, 40, 40), (1, 7, 13, 10, 120, 40), (2, 5, 9, 6, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_gradient_kernels_match_plain_on_card(cuda_device, dtype, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    n, w, h, d, cin, cout = shape
    x = torch.from_numpy(_normal((n, w, h, d, cin), 12)).to(cuda_device, dtype)
    k = torch.from_numpy(_normal((3, 3, 3, cin, cout), 13)).to(cuda_device, dtype)
    g = torch.from_numpy(_normal((n, w, h, d, cout), 14)).to(cuda_device, dtype)
    before = (conv3x3_s1p1_dx.launches, conv3x3_s1p1_dw.launches)
    dx = conv3x3_s1p1_dx(g, k)
    dk = conv3x3_s1p1_dw(x, g)
    dk_again = conv3x3_s1p1_dw(x, g)
    torch.cuda.synchronize()
    assert (conv3x3_s1p1_dx.launches, conv3x3_s1p1_dw.launches) == (before[0] + 1,
                                                                    before[1] + 2)
    assert dx.dtype == dtype and dk.dtype == dtype and dk.shape == (3, 3, 3, cin, cout)
    # split-K partial sums reduced in a fixed order, no atomics
    assert torch.equal(dk, dk_again)
    # f32: sums of up to 27*120 (dX) and N*W*H*D (dW, 3,366 here) products
    # in another order; bf16: one rounding of the output to 8 bits
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for out, ref in ((dx, conv3x3_s1p1_dx_plain(g.float(), k.float())),
                     (dk, conv3x3_s1p1_dw_plain(x.float(), g.float()))):
        err = (out.float() - ref).abs().max().item()
        assert err <= tol * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 5, 7, 3, 2), (2, 9, 17, 11, 40, 40),
                                   (1, 7, 13, 10, 120, 40), (2, 5, 9, 6, 8, 8),
                                   (1, 9, 17, 11, 80, 70)])
def test_dw_bf16_exact_on_small_integers(cuda_device, dtype, shape):
    """x and g small integers (|v| <= 4, exact in bf16, and in TF32 with
    lo = 0 in float32): every product and every f32 partial sum (at most
    3,366 voxels * 16 < 2**24) is exact, so the tensor-core kernels (bf16,
    and 3xTF32 in float32) must equal the plain version bit for bit,
    whatever the order of their sums. An indexing slip shows here as a wrong
    integer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, w, h, d, cin, cout = shape
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.integers(-4, 5, (n, w, h, d, cin)).astype(np.float32))
    g = torch.from_numpy(rng.integers(-4, 5, (n, w, h, d, cout)).astype(np.float32))
    x, g = x.to(cuda_device, dtype), g.to(cuda_device, dtype)
    dk = conv3x3_s1p1_dw(x, g)
    torch.cuda.synchronize()
    assert dk.dtype == dtype
    assert torch.equal(dk, conv3x3_s1p1_dw_plain(x, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 5, 7, 3, 2), (1, 9, 17, 11, 2, 40),
                                   (1, 9, 17, 11, 40, 80), (1, 7, 13, 10, 40, 120),
                                   (1, 7, 13, 10, 120, 40), (2, 5, 9, 6, 8, 8)])
def test_fwd_dx_exact_on_small_integers(cuda_device, dtype, shape):
    """x, k and g small integers (|v| <= 4, exact in bf16, and in TF32 with
    lo = 0 in float32): every product and every f32 partial sum (at most
    27 * 120 * 16 < 2**24) is exact, so the tensor-core kernels (bf16, and
    3xTF32 in float32) must equal the plain version bit for bit, forward
    (Cin -> Cout) and dX (Cout -> Cin), whatever the order of their sums; in
    bf16 both round the same f32 sum once. An indexing slip shows here as a
    wrong integer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, w, h, d, cin, cout = shape
    rng = np.random.default_rng(19)
    x, k, g = (torch.from_numpy(rng.integers(-4, 5, s).astype(np.float32)).to(cuda_device, dtype)
               for s in ((n, w, h, d, cin), (3, 3, 3, cin, cout), (n, w, h, d, cout)))
    before = (conv3x3_s1p1.launches, conv3x3_s1p1_dx.launches)
    out, dx = conv3x3_s1p1(x, k), conv3x3_s1p1_dx(g, k)
    torch.cuda.synchronize()
    assert (conv3x3_s1p1.launches, conv3x3_s1p1_dx.launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and dx.dtype == dtype
    assert torch.equal(out, conv3x3_s1p1_plain(x, k))
    assert torch.equal(dx, conv3x3_s1p1_dx_plain(g, k))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 6, 5, 7, 3, 2), (1, 9, 17, 11, 2, 40),
                                   (1, 9, 17, 11, 80, 40), (1, 9, 17, 11, 40, 80),
                                   (1, 7, 13, 10, 120, 40), (1, 7, 13, 10, 40, 120),
                                   (2, 6, 11, 3, 40, 40), (2, 5, 9, 6, 12, 6)])
def test_fwd_dx_f32_within_1e5_of_plain_on_card(cuda_device, shape):
    """The float32 forward and dX (3xTF32 on the tensor cores) against the
    plain float32 version on random inputs, at 1e-5 of max|ref|: each
    product within about 2**-21 of the f32 one, sums in another order. One
    TF32 product alone misses this by an order of magnitude. Cout 80 and
    120 forward, and dX 40 -> 80 and 40 -> 120 (the shapes 80 -> 40 and
    120 -> 40), take two and three Cout chunks; Cin 12 a half-empty second
    chunk staged by cp.async, Cout 6 single stores of a padded n8 tile."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, w, h, d, cin, cout = shape
    x = torch.from_numpy(_normal((n, w, h, d, cin), 20)).to(cuda_device)
    k = torch.from_numpy(_normal((3, 3, 3, cin, cout), 21) / np.float32(np.sqrt(27 * cin)))
    k = k.to(cuda_device)
    g = torch.from_numpy(_normal((n, w, h, d, cout), 22)).to(cuda_device)
    for out, ref in ((conv3x3_s1p1(x, k), conv3x3_s1p1_plain(x, k)),
                     (conv3x3_s1p1_dx(g, k), conv3x3_s1p1_dx_plain(g, k))):
        torch.cuda.synchronize()
        assert out.shape == ref.shape and out.dtype == torch.float32
        err = (out - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), err / ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("signs", ["mixed", "nonnegative"])
@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_dw_f32_within_1e5_of_plain_on_card(cuda_device, shape, signs):
    """The float32 weight gradient (3xTF32 on the tensor cores) against the
    plain float32 version on random inputs, at 1e-5 of max|ref|: each
    product within about 2**-21 of the f32 one, each K step's three products
    added to the running sum rounded to nearest, sums in another order. Two
    runs stay bitwise equal. Nonnegative inputs make every product and
    partial sum positive, where a truncating accumulation would drift most."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, w, h, d, cin, cout = shape
    x, g = _normal((n, w, h, d, cin), 23), _normal((n, w, h, d, cout), 24)
    if signs == "nonnegative":
        x, g = np.abs(x), np.abs(g)
    x, g = torch.from_numpy(x).to(cuda_device), torch.from_numpy(g).to(cuda_device)
    dk, dk_again = conv3x3_s1p1_dw(x, g), conv3x3_s1p1_dw(x, g)
    ref = conv3x3_s1p1_dw_plain(x, g)
    torch.cuda.synchronize()
    assert dk.shape == ref.shape and dk.dtype == torch.float32
    assert torch.equal(dk, dk_again)
    err = (dk - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err / ref.abs().max().item()


@pytest.mark.cuda
def test_function_on_card_gives_the_kernels_gradients(cuda_device):
    x = torch.from_numpy(_normal((2, 8, 9, 5, 6), 15)).to(cuda_device).requires_grad_()
    k = torch.from_numpy(_normal((3, 3, 3, 6, 4), 16)).to(cuda_device).requires_grad_()
    g = torch.from_numpy(_normal((2, 8, 9, 5, 4), 17)).to(cuda_device)
    before = [w.launches for w in WRAPPERS]
    Conv3x3S1P1.apply(x, k).backward(g)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(WRAPPERS, before)] == [1, 1, 1]
    assert k.grad.abs().max() > 0
    ref_dk = conv3x3_s1p1_dw_plain(x.detach(), g)
    assert (k.grad - ref_dk).abs().max() <= 1e-4 * ref_dk.abs().max()
    ref_dx = conv3x3_s1p1_dx_plain(g, k.detach())
    assert (x.grad - ref_dx).abs().max() <= 1e-4 * ref_dx.abs().max()
