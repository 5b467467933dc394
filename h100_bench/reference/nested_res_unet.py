"""NestedResUNet (UNet++ nested skip grid), the dmri_hippo network, in plain
PyTorch on (N, C, W, H, D): the published blocks and their concatenation
order (efirdc/Segmentation-Pipeline ``models/nested_residual_unet.py``),
2^3 average pooling down, trilinear (align_corners) doubling up, a 3^3 out
conv and the channel softmax. State-dict names are the published model's
(``conv0_0`` ... ``conv0_3``, ``out_conv``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Block3d, Conv3d, softmax

BLOCKS = (("conv0_0", 0, True), ("conv1_0", 1, False), ("conv0_1", 2, True),
          ("conv2_0", 1, False), ("conv1_1", 3, False), ("conv0_2", 2, True),
          ("conv3_0", 1, False), ("conv2_1", 3, False), ("conv1_2", 3, False),
          ("conv0_3", 2, True))


class NestedResUNet(nn.Module):
    def __init__(self, input_channels: int, output_channels: int, filters: int,
                 dropout_p: float = 0.0):
        super().__init__()
        for name, width, residual in BLOCKS:
            cin = input_channels if width == 0 else width * filters
            self.add_module(name, Block3d(cin, filters, residual, dropout_p))
        self.out_conv = Conv3d(filters, output_channels)

    def forward(self, x, generator=None):
        def down(t):
            return F.avg_pool3d(t, 2)

        def up(t):
            return F.interpolate(t, scale_factor=2, mode="trilinear", align_corners=True)

        def cat(*ts):
            return torch.cat(ts, dim=1)

        def block(name, t):
            return getattr(self, name)(t, generator)

        x00 = block("conv0_0", x)
        x10 = block("conv1_0", down(x00))
        x01 = block("conv0_1", cat(x00, up(x10)))
        x20 = block("conv2_0", down(x10))
        x11 = block("conv1_1", cat(x10, up(x20), down(x01)))
        x02 = block("conv0_2", cat(x01, up(x11)))
        x30 = block("conv3_0", down(x20))
        x21 = block("conv2_1", cat(x20, up(x30), down(x11)))
        x12 = block("conv1_2", cat(x11, up(x21), down(x02)))
        x03 = block("conv0_3", cat(x02, up(x12)))
        return softmax(self.out_conv(x03))


def build(config: dict) -> NestedResUNet:
    return NestedResUNet(config["input_channels"], config["output_channels"],
                         config["filters"], config.get("dropout_p", 0.0))
