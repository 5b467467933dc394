"""3x3x3 convolution, stride 1, zero padding 1, channels-last, with its
gradients.

Replaces the Pallas TPU kernel
``segmentation_pipeline_tpu/ops/pallas_conv.py::pallas_conv3d_3x3_s1p1`` and
its custom VJP (``_fwd``/``_bwd``):

- ``conv3x3_s1p1``: the forward, the CUDA kernel ``csrc/conv3x3_s1p1.cu``
  on the tensor cores (``mma.sync``): bf16, and f32 as three TF32 products
  per multiply-add (3xTF32, f32-accurate).
- ``conv3x3_s1p1_dx``: the input gradient, the same kernel on the cotangent
  with the kernel flipped along (W, H, D) and Cin/Cout swapped
  (``pallas_conv.py:118-120``).
- ``conv3x3_s1p1_dw``: the weight gradient, the CUDA kernel
  ``csrc/conv3x3_s1p1_dw.cu`` (``pallas_conv.py:128-142``) on the tensor
  cores (``mma.sync``): bf16, and f32 as 3xTF32.
- ``Conv3x3S1P1``: the ``torch.autograd.Function`` that ties them together.

Each wrapper launches its kernel on a CUDA tensor or raises; on a CPU tensor
it runs its plain PyTorch version (``*_plain``). Each counts its own launches
(``.launches`` and ``.launches_by_shape``); CPU calls do not count.

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
DW_SOURCE = "conv3x3_s1p1_dw.cu"
SOURCES = [SOURCE, DW_SOURCE]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def flip_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Cin, Cout) -> (3, 3, 3, Cout, Cin), flipped along the three
    spatial axes: the kernel whose conv of the cotangent is the input
    gradient."""
    return torch.flip(kernel, (0, 1, 2)).transpose(3, 4).contiguous()


def conv3x3_s1p1_dx_plain(g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The input gradient: the forward's plain version on the cotangent g
    (N, W, H, D, Cout) and the flipped kernel."""
    return conv3x3_s1p1_plain(g, flip_kernel(kernel))


def conv3x3_s1p1_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient: for each of the 27 taps, the window of the
    zero-padded x transposed times g over all voxels, (Cin, M) @ (M, Cout)
    with M = N*W*H*D, summed in float32; (3, 3, 3, Cin, Cout) in x's dtype."""
    N, W, H, D, cin = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    g_rows = g.float().reshape(-1, g.shape[-1])
    taps = [xp[:, dw:dw + W, dh:dh + H, dd:dd + D, :].reshape(-1, cin).T @ g_rows
            for dw in range(3) for dh in range(3) for dd in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, cin, g.shape[-1]).to(x.dtype)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """What every kernel takes: CUDA, float32 or bfloat16 of one dtype,
    contiguous, not empty."""
    dtype = tensors[0].dtype
    if dtype not in _SUFFIX or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name} takes float32 or bfloat16 tensors of one dtype; got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if any(t.numel() == 0 for t in tensors):
        raise ValueError(f"{name} takes no empty tensors; got "
                         f"{[tuple(t.shape) for t in tensors]}")


def _on_cpu(name: str, a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.device != b.device:
        raise ValueError(f"{name}: tensors on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return True
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {a.device}")
    return False


def _entry(source: str, name: str, argtypes):
    fn = getattr(build.load(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _conv_kernel(x: torch.Tensor, kernel: torch.Tensor, name: str) -> torch.Tensor:
    """Launch csrc/conv3x3_s1p1.cu on checked CUDA tensors."""
    _check_cuda(name, x, kernel)
    N, W, H, D, cin = x.shape
    cout = kernel.shape[-1]
    out = torch.empty((N, W, H, D, cout), dtype=x.dtype, device=x.device)
    fn = _entry(SOURCE, f"conv3x3_s1p1_{_SUFFIX[x.dtype]}",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), kernel.data_ptr(), out.data_ptr(), N, W, H, D, cin, cout,
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    return out


def _dw_kernel(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch csrc/conv3x3_s1p1_dw.cu on checked CUDA tensors."""
    _check_cuda("conv3x3_s1p1_dw", x, g)
    N, W, H, D, cin = x.shape
    cout = g.shape[-1]
    shape_args = (N, W, H, D, cin, cout)
    # the bf16 tensor-core kernel cuts the work otherwise than the f32 one
    splits = _entry(DW_SOURCE, f"conv3x3_s1p1_dw_splits_{_SUFFIX[x.dtype]}",
                    [ctypes.c_int] * 6)(*shape_args)
    # per-split partial sums in float32, reduced in a fixed order by a
    # second launch
    work = torch.empty((splits, 27 * cin * cout), dtype=torch.float32, device=x.device)
    out = torch.empty((3, 3, 3, cin, cout), dtype=x.dtype, device=x.device)
    fn = _entry(DW_SOURCE, f"conv3x3_s1p1_dw_{_SUFFIX[x.dtype]}",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), work.data_ptr(), out.data_ptr(), *shape_args,
                 splits, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "conv3x3_s1p1_dw")
    return out


def _count(wrapper, x: torch.Tensor, cin: int, cout: int) -> None:
    N, W, H, D, _ = x.shape
    wrapper.launches += 1
    wrapper.launches_by_shape[(str(x.dtype), N, W, H, D, cin, cout)] += 1


def conv3x3_s1p1(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The forward: the kernel on a CUDA tensor, its plain version on a CPU
    tensor."""
    if x.dim() != 5 or tuple(kernel.shape[:3]) != (3, 3, 3) or kernel.dim() != 5 \
            or kernel.shape[3] != x.shape[4]:
        raise ValueError(f"conv3x3_s1p1 takes x (N, W, H, D, Cin) and kernel "
                         f"(3, 3, 3, Cin, Cout); got {tuple(x.shape)} and "
                         f"{tuple(kernel.shape)}")
    if _on_cpu("conv3x3_s1p1", x, kernel):
        return conv3x3_s1p1_plain(x, kernel)
    out = _conv_kernel(x, kernel, "conv3x3_s1p1")
    _count(conv3x3_s1p1, x, x.shape[4], kernel.shape[4])
    return out


def conv3x3_s1p1_dx(g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The input gradient of ``conv3x3_s1p1(x, kernel)`` for the cotangent g
    (N, W, H, D, Cout): (N, W, H, D, Cin) in g's dtype. Counted by the shape
    of the conv it runs, (dtype, N, W, H, D, Cout, Cin)."""
    if g.dim() != 5 or kernel.dim() != 5 or tuple(kernel.shape[:3]) != (3, 3, 3) \
            or kernel.shape[4] != g.shape[4]:
        raise ValueError(f"conv3x3_s1p1_dx takes g (N, W, H, D, Cout) and kernel "
                         f"(3, 3, 3, Cin, Cout); got {tuple(g.shape)} and "
                         f"{tuple(kernel.shape)}")
    if _on_cpu("conv3x3_s1p1_dx", g, kernel):
        return conv3x3_s1p1_dx_plain(g, kernel)
    out = _conv_kernel(g, flip_kernel(kernel), "conv3x3_s1p1_dx")
    _count(conv3x3_s1p1_dx, g, kernel.shape[4], kernel.shape[3])
    return out


def conv3x3_s1p1_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``conv3x3_s1p1(x, kernel)`` for the cotangent g:
    (3, 3, 3, Cin, Cout) in x's dtype, bitwise the same from run to run.
    Counted by the forward's shape, (dtype, N, W, H, D, Cin, Cout)."""
    if x.dim() != 5 or g.dim() != 5 or x.shape[:4] != g.shape[:4]:
        raise ValueError(f"conv3x3_s1p1_dw takes x (N, W, H, D, Cin) and g "
                         f"(N, W, H, D, Cout); got {tuple(x.shape)} and {tuple(g.shape)}")
    if _on_cpu("conv3x3_s1p1_dw", x, g):
        return conv3x3_s1p1_dw_plain(x, g)
    out = _dw_kernel(x, g)
    _count(conv3x3_s1p1_dw, x, x.shape[4], g.shape[4])
    return out


WRAPPERS = (conv3x3_s1p1, conv3x3_s1p1_dx, conv3x3_s1p1_dw)
# Each wrapper's kernel launches since its count was last set to 0 (CPU calls
# do not count), in all and keyed by shape.
for _wrapper in WRAPPERS:
    _wrapper.launches = 0
    _wrapper.launches_by_shape = collections.Counter()


def reset_launch_counts() -> None:
    """Set the forward, dX and dW counts to 0."""
    for wrapper in WRAPPERS:
        wrapper.launches = 0
        wrapper.launches_by_shape.clear()


class Conv3x3S1P1(torch.autograd.Function):
    """``conv3x3_s1p1`` with its gradients, as the JAX package's custom VJP:
    the forward saves (x, kernel); the backward runs dX only when x needs a
    gradient (not for the convs that read the network's input) and dW only
    when the kernel does."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, kernel)
        return conv3x3_s1p1(x, kernel)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, kernel = ctx.saved_tensors
        g = g.contiguous()
        dx = conv3x3_s1p1_dx(g, kernel) if ctx.needs_input_grad[0] else None
        dk = conv3x3_s1p1_dw(x, g) if ctx.needs_input_grad[1] else None
        return dx, dk
