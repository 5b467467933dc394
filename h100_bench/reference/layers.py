"""Plain PyTorch layers the reference networks are built from, on
(N, C, W, H, D) tensors, with the state-dict names of the published
(flax) models: ``Conv3d_i``, ``BatchNorm_i`` and ``res_conv`` in a block.

Every conv goes through ``conv3d`` / ``conv_transpose3d`` here, at the
precision that ``precision(...)`` sets for the block of code around it:

- "f32" (the default): float32 with TF32 off in cuDNN and in matmuls;
- "tf32": each conv's input and weight rounded to TF32 (10 mantissa
  bits, to nearest even), then float32 with TF32 off: what cuDNN's TF32
  convs compute, the control of a float32 cell, the same on any device;
- "fp8": each conv's input and weight rounded to float8 e4m3 with one
  scale per tensor, then float32 with TF32 off: the control of a bfloat16
  cell.

BatchNorm is flax's: batch mean and biased variance in train mode, running
statistics that move as 0.9 old + 0.1 batch, eps 1e-5. Channel dropout is
flax's ``nn.Dropout(rate=p, broadcast_dims=spatial)``: one uniform per
(sample, channel), drawn as a (N, 1, 1, 1, C) tensor from the generator
given to the forward, kept where it is >= p and scaled by 1 / (1 - p).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

_MODE = {"precision": "f32"}
FP8_MAX = 448.0


@contextlib.contextmanager
def precision(mode: str):
    """Run the reference's convs at ``mode`` ("f32", "tf32" or "fp8")
    inside the block; the caller's flags and mode after it."""
    if mode not in ("f32", "tf32", "fp8"):
        raise ValueError(f"unknown reference precision {mode!r}")
    saved = (_MODE["precision"], torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    _MODE["precision"] = mode
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (_MODE["precision"], torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the operand precision of the current mode."""
    t = t.float()
    if _MODE["precision"] == "fp8":
        return _fp8(t)
    if _MODE["precision"] == "tf32":
        return _tf32(t)
    return t


class _RoundedConv(torch.autograd.Function):
    """A conv whose operands, in the forward and in both gradients, are
    rounded to the mode's precision, with float32 sums."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding)
        return F.conv3d(_round(x), _round(w), stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conv
        g = _round(g)
        gx = torch.nn.grad.conv3d_input(x.shape, _round(w), g, stride, padding) \
            if ctx.needs_input_grad[0] else None
        gw = torch.nn.grad.conv3d_weight(_round(x), w.shape, g, stride, padding) \
            if ctx.needs_input_grad[1] else None
        return gx, gw, None, None


def conv3d(x, w, b=None, stride=1, padding=0):
    if _MODE["precision"] == "f32":
        return F.conv3d(x.float(), w.float(), b, stride=stride, padding=padding)
    y = _RoundedConv.apply(x, w, stride, padding)
    return y if b is None else y + b.view(1, -1, 1, 1, 1)


def conv_transpose3d(x, w, b=None, stride=2, padding=1, output_padding=0):
    return F.conv_transpose3d(_round(x), _round(w), b, stride=stride, padding=padding,
                              output_padding=output_padding)


class Conv3d(nn.Module):
    """A conv with a (Cout, Cin, k, k, k) weight and an optional bias."""

    def __init__(self, cin: int, cout: int, k: int = 3, padding: int = 1, bias: bool = True):
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return conv3d(x, self.weight, self.bias, padding=self.padding)


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.tensor(0))
        self.adopt = False  # inside statistics_adopted

    def forward(self, x):
        shape = (1, -1, 1, 1, 1)
        if self.training or self.adopt:
            axes = (0, 2, 3, 4)
            mean = x.mean(axes)
            var = ((x - mean.view(shape)) ** 2).mean(axes)
            with torch.no_grad():
                if self.adopt:
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(var)
                else:
                    self.running_mean.mul_(0.9).add_(0.1 * mean)
                    self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + 1e-5) * self.weight
        return (x - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)


@contextlib.contextmanager
def statistics_adopted(module: nn.Module):
    """Inside the block an eval-mode forward normalizes every BatchNorm of
    ``module`` with its batch's statistics and keeps them as the running
    ones, as a trained network's are for inputs like these."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.adopt = True
    try:
        yield
    finally:
        for m in norms:
            m.adopt = False


def channel_dropout(x, p: float, generator):
    n, c = x.shape[0], x.shape[1]
    u = torch.rand((n, 1, 1, 1, c), generator=generator, device=x.device)
    keep = (u >= p).permute(0, 4, 1, 2, 3)
    return x * keep / (1.0 - p)


class Block3d(nn.Module):
    """(conv -> BatchNorm -> ReLU) x 2, plus a residual 3^3 conv of the
    block's input where ``residual``, then channel dropout in train mode."""

    def __init__(self, cin: int, cout: int, residual: bool, dropout_p: float = 0.0):
        super().__init__()
        self.Conv3d_0 = Conv3d(cin, cout, bias=False)
        self.BatchNorm_0 = BatchNorm(cout)
        self.Conv3d_1 = Conv3d(cout, cout, bias=False)
        self.BatchNorm_1 = BatchNorm(cout)
        self.res_conv = Conv3d(cin, cout) if residual else None
        self.dropout_p = dropout_p

    def forward(self, x, generator=None):
        y = F.relu(self.BatchNorm_0(self.Conv3d_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv3d_1(y)))
        if self.res_conv is not None:
            y = self.res_conv(x) + y
        if self.training and self.dropout_p > 0:
            y = channel_dropout(y, self.dropout_p, generator)
        return y


def blur_weight(weight: torch.Tensor, scale: float) -> torch.Tensor:
    """A (Cout, Cin, k, k, k) kernel blurred by a 2^3 box with zero padding
    1, to (k + 1)^3, each tap the box sum times ``scale``."""
    k = weight.shape[2]
    padded = F.pad(weight, (1,) * 6)
    out = 0
    for i in range(2):
        for j in range(2):
            for m in range(2):
                out = out + padded[:, :, i:i + k + 1, j:j + k + 1, m:m + k + 1]
    return out * scale


def softmax(x):
    return torch.softmax(x.float(), dim=1)


def conv_flops_meta(module: nn.Module, shape, train: bool = False) -> int:
    """The model FLOPs of the convs of one forward of ``module`` at input
    ``shape`` (N, C, W, H, D), and with ``train`` of its backward too (the
    input gradient only where one is needed, the weight gradients), counted
    on the meta device: 2 per multiply-add, as the chip's peak counts."""
    from torch.utils.flop_counter import FlopCounterMode

    module = module.to("meta").train(train)
    x = torch.zeros(shape, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            module(x).sum().backward()
        else:
            with torch.no_grad():
                module(x)
    return int(counter.get_total_flops())
