"""The float32 forward and input gradient of the 3x3x3 conv as the CUDA
kernel computes them, three TF32 products per multiply-add ("3xTF32"),
against the JAX package's Pallas kernel and its custom VJP.

The CUDA kernel runs only on the card, where test_torch_kernels.py holds it
against the plain version. Here its arithmetic is emulated with the port's
plain version: each operand v is split into hi = v rounded to TF32 (10
mantissa bits, to nearest, ties away from zero, as ``cvt.rna.tf32.f32``
rounds) and lo = v - hi, itself rounded to TF32; the result is
plain(x_lo, k_hi) + plain(x_hi, k_lo) + plain(x_hi, k_hi) in float32, with
lo * lo dropped. The Pallas kernel runs in interpret mode, as the JAX
package's own tests run it on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segmentation_pipeline_tpu.ops.pallas_conv import pallas_conv3d_3x3_s1p1
from segmentation_pipeline_torch.ops.conv3x3 import conv3x3_s1p1_plain, flip_kernel

torch.set_num_threads(2)

# What the card's 3xTF32 kernel is held to, relative to max|ref|: each
# product within about 2**-21 of the f32 one, sums in another order.
TOL = 1e-5


def tf32(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32: add half a unit of the 10th mantissa
    bit to the magnitude bits and clear the 13 bits below it."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(np.float32)


def split(a: np.ndarray):
    hi = tf32(a)
    return hi, tf32(a - hi)


def conv3x3_tf32x3(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The forward as the kernel computes it, small terms first."""
    (x_hi, x_lo), (k_hi, k_lo) = split(x), split(k)
    plain = lambda a, b: conv3x3_s1p1_plain(torch.from_numpy(a), torch.from_numpy(b))
    return (plain(x_lo, k_hi) + plain(x_hi, k_lo) + plain(x_hi, k_hi)).numpy()


def _inputs(cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 6, 5, 7, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    return x, k


def _pallas(x, k):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pallas_conv3d_3x3_s1p1(jnp.asarray(x), jnp.asarray(k)))


def _pallas_dx(x, k, g):
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(pallas_conv3d_3x3_s1p1, jnp.asarray(x), jnp.asarray(k))
        return np.asarray(vjp(jnp.asarray(g))[0])


def _rel_err(out, ref):
    return np.abs(out - ref).max() / np.abs(ref).max()


def test_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    cases = {1 + one_ulp / 2: 1 + one_ulp, 1 + one_ulp / 2 - 2.0 ** -23: 1.0,
             -(1 + one_ulp / 2): -(1 + one_ulp), 1 + 1.5 * one_ulp: 1 + 2 * one_ulp,
             2 - one_ulp / 2: 2.0, 3.0: 3.0}
    got = tf32(np.array(list(cases), dtype=np.float32))
    np.testing.assert_array_equal(got, np.array(list(cases.values()), dtype=np.float32))
    a = np.random.default_rng(0).normal(size=10_000).astype(np.float32)
    hi, lo = split(a)
    assert not (hi.view(np.int32) & 0x1FFF).any() and not (lo.view(np.int32) & 0x1FFF).any()
    assert (np.abs(a - hi) <= 2.0 ** -11 * np.abs(a)).all()
    # lo carries what hi drops, to about 2**-22 of a
    assert (np.abs(a.astype(np.float64) - hi - lo) <= 2.0 ** -22 * np.abs(a)).all()


# (Cin, Cout, what runs it) of every conv of NestedResUNet(3 -> 2,
# filters=40): the forward's classes, and the convs that only the input
# gradient dX runs (the forward's Cout -> Cin: 2 -> 40, 40 -> 80, 40 -> 120)
PAIRS = [(3, 40, "fwd"), (40, 40, "fwd"), (80, 40, "fwd"), (40, 2, "fwd"), (120, 40, "fwd"),
         (2, 40, "dx"), (40, 80, "dx"), (40, 120, "dx")]


@pytest.mark.parametrize("cin,cout,kind", PAIRS,
                         ids=[f"{kind}_{cin}_{cout}" for cin, cout, kind in PAIRS])
def test_tf32x3_matches_pallas(cin, cout, kind):
    if kind == "fwd":
        x, k = _inputs(cin, cout, 30 + cin + cout)
        ref, out = _pallas(x, k), conv3x3_tf32x3(x, k)
    else:
        # dX of the forward cout -> cin: the conv of g with the flipped kernel
        x, k = _inputs(cout, cin, 30 + cin + cout)
        g = np.random.default_rng(31).normal(size=(*x.shape[:4], cin)).astype(np.float32)
        ref = _pallas_dx(x, k, g)
        out = conv3x3_tf32x3(g, flip_kernel(torch.from_numpy(k)).numpy())
    assert out.shape == ref.shape
    assert _rel_err(out, ref) <= TOL


def test_one_tf32_product_misses_the_tolerance():
    """hi * hi alone, one TF32 product per multiply-add, is about 2**-11
    off per product: the tolerance above tells it from 3xTF32."""
    x, k = _inputs(120, 40, 30 + 160)
    ref = _pallas(x, k)
    one = conv3x3_s1p1_plain(torch.from_numpy(tf32(x)), torch.from_numpy(tf32(k))).numpy()
    assert _rel_err(one, ref) > 10 * TOL
    assert _rel_err(conv3x3_tf32x3(x, k), ref) <= TOL
