"""Trilinear 2x upsampling with align_corners=True over channels-last
(N, W, H, D, C) tensors, with its input gradient.

Replaces no Pallas kernel: the JAX package leaves the upsample to XLA
(``segmentation_pipeline_tpu/ops/convolution.py::upsample_trilinear2x``).
On the card the library path (permute to NCDHW, ``F.interpolate``, permute
back) ran far from its memory bound, so the upsample has a hand kernel:

- ``upsample_trilinear2x``: the forward, the CUDA kernel
  ``csrc/upsample_trilinear2x.cu``, f32 and bf16, (N, W, H, D, C) ->
  (N, 2W, 2H, 2D, C);
- ``upsample_trilinear2x_dx``: the input gradient, the same source's gather
  kernel (the forward's adjoint, no atomics, the same bits on every call);
- ``UpsampleTrilinear2x``: the ``torch.autograd.Function`` that ties them
  together; it saves only the input's shape.

Each wrapper launches its kernel on a CUDA tensor or raises; on a CPU tensor
it runs its plain PyTorch version (``*_plain``, ``F.interpolate`` and its
ATen gradient). Each counts its own launches (``.launches`` and
``.launches_by_shape``, keyed by (dtype, N, W, H, D, C) of the input grid);
CPU calls do not count. While torch's profiler records, every launch also
adds one to the ``upsample`` counter of utils/timer.py, keyed by
(direction, dtype, N, W, H, D, C).
"""
from __future__ import annotations

import collections
import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from ..utils.timer import count
from .conv3x3 import _SUFFIX, _check_cuda, _entry, _on_cpu, _raise_on

SOURCE = "upsample_trilinear2x.cu"


def upsample_trilinear2x_plain(x: torch.Tensor) -> torch.Tensor:
    """``F.interpolate`` on the NCDHW view of x, returned as a channels-last
    view."""
    _, w, h, d, _ = x.shape
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=(2 * w, 2 * h, 2 * d),
                      mode="trilinear", align_corners=True)
    return y.permute(0, 2, 3, 4, 1)


def upsample_trilinear2x_dx_plain(g: torch.Tensor, input_shape: Sequence[int]) -> torch.Tensor:
    """The input gradient of ``upsample_trilinear2x_plain`` for the cotangent g
    (N, 2W, 2H, 2D, C): ATen's ``upsample_trilinear3d_backward``, the op
    autograd runs for ``F.interpolate``, on the same views."""
    n, w, h, d, c = input_shape
    dx = torch.ops.aten.upsample_trilinear3d_backward(
        g.permute(0, 4, 1, 2, 3), [2 * w, 2 * h, 2 * d], [n, c, w, h, d], True)
    return dx.permute(0, 2, 3, 4, 1)


def _launch(name: str, src: torch.Tensor, dst: torch.Tensor, grid: Sequence[int]) -> None:
    """Run the C entry ``name`` from src into dst; ``grid`` is the input's
    (N, W, H, D, C)."""
    fn = _entry(SOURCE, f"{name}_{_SUFFIX[src.dtype]}",
                [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), dst.data_ptr(), *grid, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)


def _on_cpu_or_checked(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs); for a CUDA tensor,
    raise unless the kernel takes it."""
    if t.dim() != 5:
        raise ValueError(f"{name} takes a rank-5 channels-last tensor; got {tuple(t.shape)}")
    if _on_cpu(name, t, t):
        return True
    _check_cuda(name, t)
    return False


def _count(wrapper, direction: str, t: torch.Tensor, grid: Sequence[int]) -> None:
    dtype = str(t.dtype).replace("torch.", "")
    wrapper.launches += 1
    wrapper.launches_by_shape[(dtype, *grid)] += 1
    count("upsample", (direction, dtype, *grid))


def upsample_trilinear2x(x: torch.Tensor) -> torch.Tensor:
    """The forward: (N, W, H, D, C) -> (N, 2W, 2H, 2D, C), the kernel on a
    CUDA tensor (a contiguous result), the plain version on a CPU tensor."""
    if _on_cpu_or_checked("upsample_trilinear2x", x):
        return upsample_trilinear2x_plain(x)
    n, w, h, d, c = x.shape
    out = torch.empty((n, 2 * w, 2 * h, 2 * d, c), dtype=x.dtype, device=x.device)
    _launch("upsample_trilinear2x", x, out, x.shape)
    _count(upsample_trilinear2x, "forward", x, x.shape)
    return out


def upsample_trilinear2x_dx(g: torch.Tensor, input_shape: Sequence[int]) -> torch.Tensor:
    """The input gradient of ``upsample_trilinear2x`` for an input of
    ``input_shape`` (N, W, H, D, C) and the cotangent g (N, 2W, 2H, 2D, C),
    in g's dtype. Counted by the input's shape."""
    input_shape = tuple(input_shape)
    n, w, h, d, c = input_shape
    if tuple(g.shape) != (n, 2 * w, 2 * h, 2 * d, c):
        raise ValueError(f"upsample_trilinear2x_dx takes g (N, 2W, 2H, 2D, C) for the input "
                         f"{input_shape}; got {tuple(g.shape)}")
    if _on_cpu_or_checked("upsample_trilinear2x_dx", g):
        return upsample_trilinear2x_dx_plain(g, input_shape)
    dx = torch.empty(input_shape, dtype=g.dtype, device=g.device)
    _launch("upsample_trilinear2x_dx", g, dx, input_shape)
    _count(upsample_trilinear2x_dx, "backward", g, input_shape)
    return dx


WRAPPERS = (upsample_trilinear2x, upsample_trilinear2x_dx)
# Each wrapper's kernel launches since its count was last set to 0 (CPU calls
# do not count), in all and keyed by shape.
for _wrapper in WRAPPERS:
    _wrapper.launches = 0
    _wrapper.launches_by_shape = collections.Counter()


def reset_launch_counts() -> None:
    """Set the forward and gradient counts to 0."""
    for wrapper in WRAPPERS:
        wrapper.launches = 0
        wrapper.launches_by_shape.clear()


class UpsampleTrilinear2x(torch.autograd.Function):
    """``upsample_trilinear2x`` with its gradient; the forward saves only the
    input's shape (the upsample is linear)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.input_shape = tuple(x.shape)
        return upsample_trilinear2x(x.contiguous())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return upsample_trilinear2x_dx(g.contiguous(), ctx.input_shape)
