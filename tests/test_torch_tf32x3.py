"""The float32 forward, input gradient and weight gradient of the 3x3x3
conv as the CUDA kernels compute them, three TF32 products per
multiply-add ("3xTF32"), against the JAX package's Pallas kernel and its
custom VJP.

The CUDA kernels run only on the card, where test_torch_kernels.py holds
them against the plain versions. Here their arithmetic is emulated with the
port's plain versions: each operand v is split into hi = v rounded to TF32
(10 mantissa bits, to nearest, ties away from zero, as ``cvt.rna.tf32.f32``
rounds) and lo = v - hi, itself rounded to TF32; the result is
plain(a_lo, b_hi) + plain(a_hi, b_lo) + plain(a_hi, b_hi) in float32, with
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
from segmentation_pipeline_torch.ops.conv3x3 import (conv3x3_s1p1_dw_plain, conv3x3_s1p1_plain,
                                                     flip_kernel)

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


def tf32x3(plain, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """plain(a, b), bilinear, as the kernels compute it: small terms first."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    run = lambda u, v: plain(torch.from_numpy(u), torch.from_numpy(v))
    return (run(a_lo, b_hi) + run(a_hi, b_lo) + run(a_hi, b_hi)).numpy()


def conv3x3_tf32x3(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The forward as the kernel computes it."""
    return tf32x3(conv3x3_s1p1_plain, x, k)


def dw_tf32x3(x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """The weight gradient as its kernel computes it."""
    return tf32x3(conv3x3_s1p1_dw_plain, x, g)


def _inputs(cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 6, 5, 7, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    return x, k


def _pallas(x, k):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pallas_conv3d_3x3_s1p1(jnp.asarray(x), jnp.asarray(k)))


def _pallas_vjp(x, k, g):
    """(dX, dW) of the Pallas kernel's custom VJP."""
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(pallas_conv3d_3x3_s1p1, jnp.asarray(x), jnp.asarray(k))
        return tuple(np.asarray(d) for d in vjp(jnp.asarray(g)))


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
        ref = _pallas_vjp(x, k, g)[0]
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


# (Cin, Cout) of the forward's classes: dW runs for every conv
DW_PAIRS = [(cin, cout) for cin, cout, kind in PAIRS if kind == "fwd"]


def _dw_inputs(cin, cout):
    x, k = _inputs(cin, cout, 40 + cin + cout)
    g = np.random.default_rng(41).normal(size=(*x.shape[:4], cout)).astype(np.float32)
    return x, k, g


@pytest.mark.parametrize("cin,cout", DW_PAIRS, ids=[f"dw_{cin}_{cout}" for cin, cout in DW_PAIRS])
def test_dw_tf32x3_matches_pallas_vjp(cin, cout):
    """The weight gradient: the sum over voxels of x's tap window times g,
    against the Pallas kernel's custom VJP (its dW, pallas_conv.py:128-142)."""
    x, k, g = _dw_inputs(cin, cout)
    ref = _pallas_vjp(x, k, g)[1]
    out = dw_tf32x3(x, g)
    assert out.shape == ref.shape == (3, 3, 3, cin, cout)
    assert _rel_err(out, ref) <= TOL


def test_dw_one_tf32_product_misses_the_tolerance():
    """hi * hi alone misses 1e-5 for the weight gradient too."""
    x, k, g = _dw_inputs(120, 40)
    ref = _pallas_vjp(x, k, g)[1]
    one = conv3x3_s1p1_dw_plain(torch.from_numpy(tf32(x)), torch.from_numpy(tf32(g))).numpy()
    assert _rel_err(one, ref) > 10 * TOL
    assert _rel_err(dw_tf32x3(x, g), ref) <= TOL
