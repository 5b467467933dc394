"""3D convolution primitives over channels-last (N, W, H, D, C) tensors.

Mirrors segmentation_pipeline_tpu/ops/convolution.py. Every model conv routes
through ``conv3d``: the 3x3x3 / stride 1 / padding 1 class goes to the
hand-written kernels through their autograd Function (``ops/conv3x3.py``;
plain versions on CPU tensors), any other shape to ``F.conv3d``, whose
gradients are cuDNN's, as the JAX package sends those to XLA. Transposed
convs (``conv_transpose3d``) go to ``F.conv_transpose3d``.

cuDNN runs float32 convs in TF32 while ``torch.backends.cudnn.allow_tf32``
is True, PyTorch's default, about 1e-3 away from float32. Every library
conv issued here, forward and both gradients, runs with it off
(``_LibraryConv`` under ``_f32_convs``), so float32 stays float32 whatever
the caller's global flags say.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .conv3x3 import Conv3x3S1P1


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    return tuple(v)


@contextlib.contextmanager
def _f32_convs():
    """cuDNN with TF32 off inside the block; the caller's setting after it."""
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = previous


class _LibraryConv(torch.autograd.Function):
    """``F.conv3d`` (or ``F.conv_transpose3d``) on (N, C, W, H, D) tensors
    with TF32 off in the forward and in the backward: autograd's own
    backward would run under the global flag of the moment it runs."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding, output_padding, transposed):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, output_padding, transposed)
        with _f32_convs():
            if transposed:
                return F.conv_transpose3d(x, weight, stride=stride, padding=padding,
                                          output_padding=output_padding)
            return F.conv3d(x, weight, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, output_padding, transposed = ctx.conv
        with _f32_convs():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad, x, weight, None, stride, padding, (1, 1, 1), transposed,
                output_padding, 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None, None


def conv3d(x: torch.Tensor, kernel: torch.Tensor,
           stride: Union[int, Sequence[int]] = 1,
           padding: Union[int, Sequence[int]] = 0) -> torch.Tensor:
    """x: (N, W, H, D, Cin); kernel: (kw, kh, kd, Cin, Cout).

    Explicit symmetric padding (torch Conv3d semantics). The output has x's
    dtype; float32 and bfloat16 sums are kept in float32.
    """
    stride = _triple(stride)
    padding = _triple(padding)
    if tuple(kernel.shape[:3]) == (3, 3, 3) and stride == (1, 1, 1) \
            and padding == (1, 1, 1):
        return Conv3x3S1P1.apply(x.contiguous(), kernel.contiguous())
    y = _LibraryConv.apply(x.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2),
                           stride, padding, (0, 0, 0), False)
    return y.permute(0, 2, 3, 4, 1)


def conv_transpose3d(x: torch.Tensor, kernel: torch.Tensor,
                     stride: Union[int, Sequence[int]] = 2,
                     padding: Union[int, Sequence[int]] = 0,
                     output_padding: Union[int, Sequence[int]] = 0) -> torch.Tensor:
    """torch ConvTranspose3d semantics, out = (in - 1) * s - 2p + k + op.

    x: (N, W, H, D, Cin); kernel: (kw, kh, kd, Cin, Cout) in forward
    orientation, as the JAX package's (its input-dilated conv with the
    flipped kernel is torch's transposed conv with the weight
    ``kernel.permute(3, 4, 0, 1, 2)``). The output has x's dtype.
    """
    y = _LibraryConv.apply(x.permute(0, 4, 1, 2, 3), kernel.permute(3, 4, 0, 1, 2),
                           _triple(stride), _triple(padding), _triple(output_padding), True)
    return y.permute(0, 2, 3, 4, 1)


def avg_pool3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """AvgPool3d over (N, W, H, D, C) with stride = window, VALID padding:
    window sums / window**3 (a trailing remainder is dropped)."""
    n, w, h, d, c = x.shape
    w, h, d = w // window, h // window, d // window
    x = x[:, :w * window, :h * window, :d * window]
    x = x.reshape(n, w, window, h, window, d, window, c)
    return x.sum(dim=(2, 4, 6)) / float(window ** 3)


def upsample_trilinear2x(x: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """Trilinear 2x upsample of (N, W, H, D, C), as torch
    ``nn.Upsample(scale_factor=2, mode='trilinear', align_corners=True)``;
    an axis of size 1 repeats its one value."""
    _, w, h, d, _ = x.shape
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=(2 * w, 2 * h, 2 * d),
                      mode="trilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 4, 1)
