from .conv3x3 import (Conv3x3S1P1, conv3x3_s1p1, conv3x3_s1p1_dw, conv3x3_s1p1_dw_plain,
                      conv3x3_s1p1_dx, conv3x3_s1p1_dx_plain, conv3x3_s1p1_plain)
from .convolution import avg_pool3d, conv3d, upsample_trilinear2x

__all__ = ["Conv3x3S1P1", "conv3x3_s1p1", "conv3x3_s1p1_plain", "conv3x3_s1p1_dx",
           "conv3x3_s1p1_dx_plain", "conv3x3_s1p1_dw", "conv3x3_s1p1_dw_plain",
           "avg_pool3d", "conv3d", "upsample_trilinear2x"]
