"""NestedResUNet — UNet++-style nested skip grid, channels-last.

Ported from segmentation_pipeline_tpu/models/nested_unet.py with the same
submodule names (conv0_0 ... conv3_0, out_conv) and the same concatenation
order, which the 2f- and 3f-channel block weights depend on. Spatial dims
must be divisible by 8 (three pooling levels). ``remat=True`` rematerializes
the blocks in a train-mode forward under autograd, as the JAX package's
``nn.remat(Block3d)`` (``modular_unet.rematerialized``); ``use_norm=False``
leaves BatchNorm out of every block. ``hypothesis_class`` (built with
``hypothesis_params``) is the head after the out conv: the channel softmax
by default, ``StochasticMatrix`` for the cascade.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops.convolution import avg_pool3d, upsample_trilinear2x
from .components import Block3d, Conv3d, Softmax
from .modular_unet import rematerialized

# (name, input width in units of filters (0: the network's input), residual)
_BLOCKS = (
    ("conv0_0", 0, True), ("conv1_0", 1, False), ("conv0_1", 2, True),
    ("conv2_0", 1, False), ("conv1_1", 3, False), ("conv0_2", 2, True),
    ("conv3_0", 1, False), ("conv2_1", 3, False), ("conv1_2", 3, False),
    ("conv0_3", 2, True),
)


class NestedResUNet(nn.Module):
    """x: (N, W, H, D, input_channels) -> the head on the out conv's
    (N, W, H, D, output_channels). In train mode every block draws its
    channel dropout from the generator given to ``forward``."""

    def __init__(self, input_channels: int, output_channels: int, filters: int = 40,
                 dropout_p: float = 0.0, hypothesis_class: Any = Softmax,
                 hypothesis_params: Optional[Dict] = None, remat: bool = False,
                 use_norm: bool = True):
        super().__init__()
        f = filters
        self.remat = remat
        for name, width, residual in _BLOCKS:
            cin = input_channels if width == 0 else width * f
            self.add_module(name, Block3d(cin, f, residual=residual, dropout_p=dropout_p,
                                          use_norm=use_norm))
        self.out_conv = Conv3d(f, output_channels, kernel_size=3, padding=1)
        self.hypothesis = hypothesis_class(**(hypothesis_params or {}))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        down = lambda t: avg_pool3d(t, 2)  # noqa: E731
        up = lambda t: upsample_trilinear2x(t, align_corners=True)  # noqa: E731
        cat = lambda *ts: torch.cat(ts, dim=-1)  # noqa: E731
        remat = self.remat and self.training and torch.is_grad_enabled()

        def block(name, t):
            module = getattr(self, name)
            return rematerialized(module, t, generator) if remat else module(t, generator)

        x0_0 = block("conv0_0", x)
        x1_0 = block("conv1_0", down(x0_0))
        x0_1 = block("conv0_1", cat(x0_0, up(x1_0)))

        x2_0 = block("conv2_0", down(x1_0))
        x1_1 = block("conv1_1", cat(x1_0, up(x2_0), down(x0_1)))
        x0_2 = block("conv0_2", cat(x0_1, up(x1_1)))

        x3_0 = block("conv3_0", down(x2_0))
        x2_1 = block("conv2_1", cat(x2_0, up(x3_0), down(x1_1)))
        x1_2 = block("conv1_2", cat(x1_1, up(x2_1), down(x0_2)))
        x0_3 = block("conv0_3", cat(x0_2, up(x1_2)))

        return self.hypothesis(self.out_conv(x0_3))
