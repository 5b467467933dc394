"""NestedResUNet — UNet++-style nested skip grid, channels-last.

Ported from segmentation_pipeline_tpu/models/nested_unet.py with the same
submodule names (conv0_0 ... conv3_0, out_conv) and the same concatenation
order, which the 2f- and 3f-channel block weights depend on. Spatial dims
must be divisible by 8 (three pooling levels).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.convolution import avg_pool3d, upsample_trilinear2x
from .components import Block3d, Conv3d, Softmax

# (name, input width in units of filters (0: the network's input), residual)
_BLOCKS = (
    ("conv0_0", 0, True), ("conv1_0", 1, False), ("conv0_1", 2, True),
    ("conv2_0", 1, False), ("conv1_1", 3, False), ("conv0_2", 2, True),
    ("conv3_0", 1, False), ("conv2_1", 3, False), ("conv1_2", 3, False),
    ("conv0_3", 2, True),
)


class NestedResUNet(nn.Module):
    """x: (N, W, H, D, input_channels) -> channel softmax
    (N, W, H, D, output_channels). In train mode every block draws its
    channel dropout from the generator given to ``forward``."""

    def __init__(self, input_channels: int, output_channels: int, filters: int = 40,
                 dropout_p: float = 0.0):
        super().__init__()
        f = filters
        for name, width, residual in _BLOCKS:
            cin = input_channels if width == 0 else width * f
            self.add_module(name, Block3d(cin, f, residual=residual, dropout_p=dropout_p))
        self.out_conv = Conv3d(f, output_channels, kernel_size=3, padding=1)
        self.hypothesis = Softmax()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        down = lambda t: avg_pool3d(t, 2)  # noqa: E731
        up = lambda t: upsample_trilinear2x(t, align_corners=True)  # noqa: E731
        cat = lambda *ts: torch.cat(ts, dim=-1)  # noqa: E731

        x0_0 = self.conv0_0(x, generator)
        x1_0 = self.conv1_0(down(x0_0), generator)
        x0_1 = self.conv0_1(cat(x0_0, up(x1_0)), generator)

        x2_0 = self.conv2_0(down(x1_0), generator)
        x1_1 = self.conv1_1(cat(x1_0, up(x2_0), down(x0_1)), generator)
        x0_2 = self.conv0_2(cat(x0_1, up(x1_1)), generator)

        x3_0 = self.conv3_0(down(x2_0), generator)
        x2_1 = self.conv2_1(cat(x2_0, up(x3_0), down(x1_1)), generator)
        x1_2 = self.conv1_2(cat(x1_1, up(x2_1), down(x0_2)), generator)
        x0_3 = self.conv0_3(cat(x0_2, up(x1_2)), generator)

        return self.hypothesis(self.out_conv(x0_3))
