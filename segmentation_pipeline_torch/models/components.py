"""Model building blocks over channels-last (N, W, H, D, C) tensors.

Ported from segmentation_pipeline_tpu/models/components.py (Conv3d, Block3d,
Softmax). Submodule names follow the flax tree (``Conv3d_0``,
``BatchNorm_0``, ``res_conv``) so that models/convert.py maps weights by name.
Convs route through ops/convolution.py.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.convolution import conv3d


def _triple(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def torch_conv_kernel_init(weight: torch.Tensor,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch Conv3d default init, in place: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    with fan_in = Cin * prod(kernel). weight: (Cout, Cin, kw, kh, kd)."""
    bound = 1.0 / math.sqrt(math.prod(weight.shape[1:]))
    with torch.no_grad():
        values = torch.empty(weight.shape, dtype=weight.dtype)
        values.uniform_(-bound, bound, generator=generator)
        return weight.copy_(values)


class Conv3d(nn.Module):
    """torch-style Conv3d on channels-last input. The weight is stored as
    torch's (Cout, Cin, kw, kh, kd); the bias is added after the conv, in the
    conv output's dtype."""

    def __init__(self, in_channels: int, features: int, kernel_size: Any = 3,
                 stride: Any = 1, padding: Any = 0, use_bias: bool = True):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(features, in_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        torch_conv_kernel_init(self.weight, generator)
        if self.bias is not None:
            bound = 1.0 / math.sqrt(math.prod(self.weight.shape[1:]))
            with torch.no_grad():
                values = torch.empty(self.bias.shape, dtype=self.bias.dtype)
                self.bias.copy_(values.uniform_(-bound, bound, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.weight.permute(2, 3, 4, 1, 0).to(x.dtype)
        y = conv3d(x, kernel, stride=self.stride, padding=self.padding)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Block3d(nn.Module):
    """n x (conv -> BatchNorm -> ReLU), optional residual 3^3 conv, channel
    dropout. BatchNorm keeps its statistics in float32 (momentum 0.1 in torch
    terms, flax's 0.9; eps 1e-5) and normalizes inputs of any dtype."""

    def __init__(self, in_channels: int, features: int, num_convs: int = 2,
                 residual: bool = False, dropout_p: float = 0.0):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            cin = in_channels if i == 0 else features
            self.add_module(f"Conv3d_{i}", Conv3d(cin, features, kernel_size=3,
                                                  padding=1, use_bias=False))
            self.add_module(f"BatchNorm_{i}", nn.BatchNorm3d(features, eps=1e-5,
                                                             momentum=0.1))
        self.res_conv = (Conv3d(in_channels, features, kernel_size=3, padding=1)
                         if residual else None)
        self.dropout = nn.Dropout3d(dropout_p) if dropout_p > 0.0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_in = x
        for i in range(self.num_convs):
            x = getattr(self, f"Conv3d_{i}")(x)
            # BatchNorm3d and Dropout3d take channels at dim 1: a view of the
            # channels-last tensor, permuted back after
            x = getattr(self, f"BatchNorm_{i}")(x.permute(0, 4, 1, 2, 3))
            x = F.relu(x.permute(0, 2, 3, 4, 1))
        if self.res_conv is not None:
            x = self.res_conv(x_in) + x
        if self.dropout is not None:
            x = self.dropout(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        return x


class Softmax(nn.Module):
    """Channel softmax hypothesis head (channels-last)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x, dim=-1)
