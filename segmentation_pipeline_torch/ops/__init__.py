from .conv3x3 import conv3x3_s1p1, conv3x3_s1p1_plain
from .convolution import avg_pool3d, conv3d, upsample_trilinear2x

__all__ = ["conv3x3_s1p1", "conv3x3_s1p1_plain", "avg_pool3d", "conv3d",
           "upsample_trilinear2x"]
