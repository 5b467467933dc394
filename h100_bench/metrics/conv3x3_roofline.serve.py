"""The hand forward kernel's share of its roofline in the traced stretch
of a serving window, in percent: the summed bound of every counted
forward launch (h100_bench/roofline.py) over the device time of the
forward kernels (FORWARD)."""
import re

from h100_bench.roofline import bound_and_flops
from h100_bench.trace import device_seconds

# the forward kernels of csrc/conv3x3_s1p1.cu
FORWARD = re.compile(r"conv3x3_s1p1_(mma|tf32x3)_kernel")


def read(ctx):
    s = ctx["summary"]
    seconds = device_seconds(s, FORWARD)
    bound, _ = bound_and_flops(s["counts"], ("fwd",))
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
