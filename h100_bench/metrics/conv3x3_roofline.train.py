"""The hand kernels' share of their roofline in the traced stretch of a
training window, in percent: the summed bound of every counted launch of
the forward, input-gradient and weight-gradient kernels (max of FLOPs over
the dtype's peak and bytes over 3.35 TB/s, h100_bench/roofline.py) over
the device time of the kernels those launches ran (the names in HAND)."""
import re

from h100_bench.roofline import bound_and_flops
from h100_bench.trace import device_seconds

# the forward (also run for dX on the flipped kernel) and dW kernels of
# csrc/conv3x3_s1p1.cu and csrc/conv3x3_s1p1_dw.cu
HAND = re.compile(r"conv3x3_s1p1_(mma|tf32x3)_kernel|dw_partial_(mma|tf32x3)_kernel|dw_reduce_kernel")


def read(ctx):
    s = ctx["summary"]
    seconds = device_seconds(s, HAND)
    bound, _ = bound_and_flops(s["counts"], ("fwd", "dx", "dw"))
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
