"""Model building blocks over channels-last (N, W, H, D, C) tensors.

Ported from segmentation_pipeline_tpu/models/components.py (Conv3d, Block3d,
Softmax) and flax's BatchNorm as Block3d uses it. Submodule names follow the
flax tree (``Conv3d_0``, ``BatchNorm_0``, ``res_conv``) so that
models/convert.py maps weights by name.
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


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis of a channels-last tensor, as flax's
    ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=x.dtype)``.

    Train mode: batch mean and variance in float32 for any input dtype, the
    variance biased and computed as E[x^2] - E[x]^2 (clipped at 0), as
    flax's; the output is normalized in float32 and cast to the input's
    dtype. The running statistics move as flax's do:
    ``0.9 * old + 0.1 * batch``, with the *biased* variance (torch's
    BatchNorm3d takes the unbiased one). Eval mode: ``F.batch_norm`` with the
    running statistics. The state-dict keys are torch's BatchNorm3d's.
    """

    MOMENTUM = 0.9
    EPS = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def reset_parameters(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = F.batch_norm(x.permute(0, 4, 1, 2, 3), self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.EPS)
            return y.permute(0, 2, 3, 4, 1)
        xf = x.float()
        axes = tuple(range(x.dim() - 1))
        mean = xf.mean(axes)
        var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(self.MOMENTUM * self.running_mean
                                    + (1 - self.MOMENTUM) * mean)
            self.running_var.copy_(self.MOMENTUM * self.running_var
                                   + (1 - self.MOMENTUM) * var)
            self.num_batches_tracked += 1
        y = (xf - mean) * (torch.rsqrt(var + self.EPS) * self.weight) + self.bias
        return y.to(x.dtype)


def channel_dropout(x: torch.Tensor, p: float,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Drop whole channels of a channels-last (N, W, H, D, C) tensor with
    probability p, scaling the kept ones by 1 / (1 - p): one draw per
    (sample, channel) from ``generator``, as flax's ``nn.Dropout(rate=p,
    broadcast_dims=(1, 2, 3))`` draws from its explicit key."""
    if generator is None:
        raise ValueError("channel dropout in train mode needs a torch.Generator")
    n, c = x.shape[0], x.shape[-1]
    keep = torch.rand((n, 1, 1, 1, c), generator=generator, device=x.device) >= p
    return x * keep / (1.0 - p)


class Block3d(nn.Module):
    """n x (conv -> BatchNorm -> ReLU), optional residual 3^3 conv, channel
    dropout in train mode (drawn from the generator given to ``forward``).
    BatchNorm keeps its statistics in float32 and normalizes inputs of any
    dtype."""

    def __init__(self, in_channels: int, features: int, num_convs: int = 2,
                 residual: bool = False, dropout_p: float = 0.0):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            cin = in_channels if i == 0 else features
            self.add_module(f"Conv3d_{i}", Conv3d(cin, features, kernel_size=3,
                                                  padding=1, use_bias=False))
            self.add_module(f"BatchNorm_{i}", BatchNorm(features))
        self.res_conv = (Conv3d(in_channels, features, kernel_size=3, padding=1)
                         if residual else None)
        self.dropout_p = dropout_p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x_in = x
        for i in range(self.num_convs):
            x = getattr(self, f"Conv3d_{i}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x))
        if self.res_conv is not None:
            x = self.res_conv(x_in) + x
        if self.training and self.dropout_p > 0.0:
            x = channel_dropout(x, self.dropout_p, generator)
        return x


class Softmax(nn.Module):
    """Channel softmax hypothesis head (channels-last)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x, dim=-1)
