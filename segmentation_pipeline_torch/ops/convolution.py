"""3D convolution primitives over channels-last (N, W, H, D, C) tensors.

Mirrors segmentation_pipeline_tpu/ops/convolution.py. Every model conv routes
through ``conv3d``: the 3x3x3 / stride 1 / padding 1 class goes to the
hand-written kernel (``ops/conv3x3.py``; its plain version on CPU tensors),
any other shape to ``F.conv3d``, as the JAX package sends those to XLA.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .conv3x3 import conv3x3_s1p1


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    return tuple(v)


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
        return conv3x3_s1p1(x.contiguous(), kernel.contiguous())
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2),
                 stride=stride, padding=padding)
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
