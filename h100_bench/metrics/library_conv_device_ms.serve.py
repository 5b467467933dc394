"""Device milliseconds per served subject of the convolution kernels that
are not the port's hand kernels (cuDNN's, for the blurred strided and
transposed convs and any other shape) in the traced stretch."""
import re

from h100_bench.trace import device_seconds

# library convolutions (cuDNN's conv kernels and its layout transforms, not
# its BatchNorm kernels), and the hand kernels they exclude
LIBRARY_CONV = re.compile(r"xmma|implicit|convolve|fprop|dgrad|wgrad|cutlass|conv|"
                          r"nchwToNhwc|nhwcToNchw", re.IGNORECASE)
HAND = re.compile(r"conv3x3_s1p1_(mma|tf32x3)_kernel|dw_partial_(mma|tf32x3)_kernel|dw_reduce_kernel")


def read(ctx):
    seconds = device_seconds(ctx["summary"], LIBRARY_CONV, HAND)
    subjects = ctx["work"].get("subjects")
    if not seconds or not subjects:
        return None
    return 1e3 * seconds / subjects
