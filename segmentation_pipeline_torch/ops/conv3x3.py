"""Forward 3x3x3 convolution, stride 1, zero padding 1, channels-last.

``conv3x3_s1p1`` is the wrapper of the hand-written CUDA kernel in
``csrc/conv3x3_s1p1.cu``, which replaces the Pallas TPU kernel
``segmentation_pipeline_tpu/ops/pallas_conv.py::_pallas_conv3x3_s1p1``.
On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
``conv3x3_s1p1_plain``, the plain PyTorch version of the same function.

x is (N, W, H, D, Cin), kernel is (3, 3, 3, Cin, Cout); the output is
(N, W, H, D, Cout) in x's dtype, summed in float32.
"""
from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from . import build

SOURCE = "conv3x3_s1p1.cu"
_ENTRY = {torch.float32: "conv3x3_s1p1_f32", torch.bfloat16: "conv3x3_s1p1_bf16"}


def conv3x3_s1p1_plain(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """27 tap-shifted (voxels, Cin) @ (Cin, Cout) products on the zero-padded
    input, summed in float32."""
    N, W, H, D, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    k = kernel.float()
    out = torch.zeros((N, W, H, D, kernel.shape[-1]), dtype=torch.float32, device=x.device)
    for dw in range(3):
        for dh in range(3):
            for dd in range(3):
                out += xp[:, dw:dw + W, dh:dh + H, dd:dd + D, :] @ k[dw, dh, dd]
    return out.to(x.dtype)


def _kernel_function(dtype: torch.dtype):
    fn = getattr(build.load(SOURCE), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv3x3_s1p1(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if x.dim() != 5 or tuple(kernel.shape[:3]) != (3, 3, 3) or kernel.dim() != 5 \
            or kernel.shape[3] != x.shape[4]:
        raise ValueError(f"conv3x3_s1p1 takes x (N, W, H, D, Cin) and kernel "
                         f"(3, 3, 3, Cin, Cout); got {tuple(x.shape)} and "
                         f"{tuple(kernel.shape)}")
    if x.device != kernel.device:
        raise ValueError(f"x is on {x.device} and kernel on {kernel.device}")
    if x.device.type == "cpu":
        return conv3x3_s1p1_plain(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_s1p1 runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype not in _ENTRY or kernel.dtype != x.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 x and kernel of one "
                        f"dtype; got {x.dtype} and {kernel.dtype}")
    if not (x.is_contiguous() and kernel.is_contiguous()):
        raise ValueError("the kernel takes contiguous x and kernel")
    if x.numel() == 0 or kernel.numel() == 0:
        raise ValueError(f"the kernel takes no empty tensors; got {tuple(x.shape)} "
                         f"and {tuple(kernel.shape)}")
    N, W, H, D, cin = x.shape
    cout = kernel.shape[-1]
    out = torch.empty((N, W, H, D, cout), dtype=x.dtype, device=x.device)
    fn = _kernel_function(x.dtype)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), kernel.data_ptr(), out.data_ptr(), N, W, H, D, cin, cout,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_s1p1 kernel launch failed with CUDA error {err}")
    conv3x3_s1p1.launches += 1
    conv3x3_s1p1.launches_by_shape[(str(x.dtype), N, W, H, D, cin, cout)] += 1
    return out


conv3x3_s1p1.launches = 0
"""Kernel launches since the count was last set to 0 (CPU calls do not count)."""
conv3x3_s1p1.launches_by_shape = collections.Counter()
"""The same launches keyed by (dtype, N, W, H, D, Cin, Cout)."""
