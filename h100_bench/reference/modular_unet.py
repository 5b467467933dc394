"""ModularUNet, the msseg2 network, in plain PyTorch on (N, C, W, H, D): an
encoder of ``depth`` residual blocks, each but the last followed by a
BlurConv3d down-sampler that keeps its width (a 3^3 stride-2 kernel
blurred by a 2^3 box to 4^3, each tap 1/64), a decoder that doubles with a
BlurConvTranspose3d (the box-blurred kernel, each tap 1) and concatenates
[upsampled, skip] before its block, a 3^3 out conv and the channel
softmax (efirdc/Segmentation-Pipeline ``research/msseg2/msseg2.py`` and
``models/modular_unet.py``). State-dict names are the published model's
(``down_block_i``, ``down_i``, ``up_i``, ``up_block_i``, ``out_conv``);
sampler weights are (Cout, Cin, 3, 3, 3)."""
from __future__ import annotations

import torch
from torch import nn

from .layers import Block3d, Conv3d, blur_weight, conv3d, conv_transpose3d, softmax


class _Sampler(nn.Module):
    def __init__(self, c: int, transposed: bool):
        super().__init__()
        self.transposed = transposed
        self.weight = nn.Parameter(torch.zeros(c, c, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        if self.transposed:
            w = blur_weight(self.weight, 1.0)
            return conv_transpose3d(x, w.transpose(0, 1), self.bias, stride=2, padding=1)
        w = blur_weight(self.weight, 1.0 / 64.0)
        return conv3d(x, w, self.bias, stride=2, padding=1)


class ModularUNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, filters):
        super().__init__()
        filters = list(filters)
        self.depth = len(filters)
        for i, f in enumerate(filters):
            self.add_module(f"down_block_{i}",
                            Block3d(in_channels if i == 0 else filters[i - 1], f, True))
        for i in range(self.depth - 1):
            self.add_module(f"down_{i}", _Sampler(filters[i], False))
            self.add_module(f"up_block_{i}",
                            Block3d(filters[i + 1] + filters[i], filters[i], True))
            self.add_module(f"up_{i}", _Sampler(filters[i + 1], True))
        self.out_conv = Conv3d(filters[0], out_channels)

    def forward(self, x, generator=None):
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"down_block_{i}")(x, generator)
            if i != self.depth - 1:
                skips.append(x)
                x = getattr(self, f"down_{i}")(x)
        for i in reversed(range(self.depth - 1)):
            x = getattr(self, f"up_{i}")(x)
            x = getattr(self, f"up_block_{i}")(torch.cat([x, skips[i]], dim=1), generator)
        return softmax(self.out_conv(x))


def build(config: dict) -> ModularUNet:
    return ModularUNet(config["input_channels"], config["output_channels"], config["filters"])
