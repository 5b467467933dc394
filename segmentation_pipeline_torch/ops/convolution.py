"""3D convolution primitives over channels-last (N, W, H, D, C) tensors.

Mirrors segmentation_pipeline_tpu/ops/convolution.py. Every model conv routes
through ``conv3d``: the 3x3x3 / stride 1 / padding 1 class goes to the
hand-written kernels through their autograd Function (``ops/conv3x3.py``;
plain versions on CPU tensors), any other shape to ``F.conv3d``, whose
gradients are cuDNN's, as the JAX package sends those to XLA. Transposed
convs (``conv_transpose3d``) go to ``F.conv_transpose3d``. The
align-corners 2x trilinear upsample goes to its hand kernels
(``ops/upsample.py``), forward and gradient.

cuDNN runs float32 convs in TF32 while ``torch.backends.cudnn.allow_tf32``
is True, PyTorch's default, about 1e-3 away from float32. Every library
conv issued here, forward and both gradients, runs with it off
(``_LibraryConv`` under ``_library_flags``), so float32 stays float32
whatever the caller's global flags say. Where no gradient is recorded
(serving, validation sweeps) the answer is the same bits on every call, as
the JAX package's is, and every library conv runs under
``torch.backends.cudnn.deterministic``. cuDNN's default float32 algorithm
for msseg2's transposed convs sums in a varying order (the same request
gave probabilities up to 4.2e-7 apart from call to call on an H100), and
its deterministic one took 2.3 times as long per request there; so a
float32 transposed conv runs as one forward conv whose output channels
are the output phases' (``transposed_by_phases``), whose request came
within 1% of cuDNN's default there (medians of 10). In bfloat16 cuDNN's
deterministic transposed conv was as fast as its default, and the grouped
conv slower.

While torch's profiler records, every library conv call (each forward, each
backward, each conv of ``transposed_by_phases``) adds one to the
``library_conv`` counter of utils/timer.py.

A conv whose stride is its kernel and padding 0 (the 1^3 convs, a 2^3
stride-2 patch embedding) is a GEMM on the channels-last layout:
``conv3d_by_gemm`` runs it on the matmul (cuBLAS on the card, float32
unless the caller turned on TF32 for matmuls), with no layout transform,
and counts each call on the ``gemm_conv`` counter. Only the module that
asks for it uses it (models/components.py's ``PatchConv3d``); ``conv3d``
routes as above. On an H100 in bfloat16 at N=4 the GEMM took 0.294-0.360
ms against cuDNN's 0.377-0.430 at 96^3 (1->48, 96->48) and 0.065 against
0.108 for the patch embedding; the 2^3 stride-2 transposed conv stays on
``conv_transpose3d``, where cuDNN took 0.322 ms against a GEMM and
interleave's 0.717 at 48^3 (48->48).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.timer import count
from .conv3x3 import Conv3x3S1P1
from .upsample import UpsampleTrilinear2x


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    return tuple(v)


def _count_library_conv(direction: str, kind: str, x: torch.Tensor, weight: torch.Tensor,
                        stride) -> None:
    """One library conv call on the ``library_conv`` counter (recorded only
    under the profiler), keyed by direction ('forward', 'backward'), kind
    ('conv', 'transposed', 'by_phase'), dtype, N, Cin, Cout, the input's
    spatial shape and the stride. ``weight`` is torch's: (Cout, Cin, ...)
    for a conv, (Cin, Cout, ...) for a transposed one."""
    cin, cout = weight.shape[1::-1] if kind == "conv" else weight.shape[:2]
    count("library_conv", (direction, kind, str(x.dtype).replace("torch.", ""), x.shape[0],
                           cin, cout, tuple(x.shape[2:]), tuple(stride)))


@contextlib.contextmanager
def _library_flags(deterministic: bool):
    """cuDNN with TF32 off inside the block, and held to deterministic
    algorithms where ``deterministic``; the caller's settings after it."""
    previous = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic or previous[1]
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = previous


class _LibraryConv(torch.autograd.Function):
    """``F.conv3d`` (or ``F.conv_transpose3d``) on (N, C, W, H, D) tensors
    with TF32 off in the forward and in the backward: autograd's own
    backward would run under the global flag of the moment it runs. The
    forward is deterministic where ``deterministic`` (no gradient is
    recorded)."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding, output_padding, transposed, deterministic):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, output_padding, transposed)
        _count_library_conv("forward", "transposed" if transposed else "conv", x, weight,
                            stride)
        with _library_flags(deterministic):
            if transposed:
                return F.conv_transpose3d(x, weight, stride=stride, padding=padding,
                                          output_padding=output_padding)
            return F.conv3d(x, weight, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, output_padding, transposed = ctx.conv
        _count_library_conv("backward", "transposed" if transposed else "conv", x, weight,
                            stride)
        with _library_flags(False):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad, x, weight, None, stride, padding, (1, 1, 1), transposed,
                output_padding, 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None, None, None


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
                           stride, padding, (0, 0, 0), False, not torch.is_grad_enabled())
    return y.permute(0, 2, 3, 4, 1)


def conv_transpose3d(x: torch.Tensor, kernel: torch.Tensor,
                     stride: Union[int, Sequence[int]] = 2,
                     padding: Union[int, Sequence[int]] = 0,
                     output_padding: Union[int, Sequence[int]] = 0) -> torch.Tensor:
    """torch ConvTranspose3d semantics, out = (in - 1) * s - 2p + k + op.

    x: (N, W, H, D, Cin); kernel: (kw, kh, kd, Cin, Cout) in forward
    orientation, as the JAX package's (its input-dilated conv with the
    flipped kernel is torch's transposed conv with the weight
    ``kernel.permute(3, 4, 0, 1, 2)``). The output has x's dtype. Where no
    gradient is recorded it sums in a fixed order: in float32 as one forward
    conv by output phase (``transposed_by_phases``), in bfloat16 on cuDNN's
    deterministic transposed conv.
    """
    x_cf, weight = x.permute(0, 4, 1, 2, 3), kernel.permute(3, 4, 0, 1, 2)
    conv = (_triple(stride), _triple(padding), _triple(output_padding))
    if torch.is_grad_enabled():
        y = _LibraryConv.apply(x_cf, weight, *conv, True, False)
    elif x.dtype == torch.float32:
        with _library_flags(True):
            y = transposed_by_phases(x_cf, weight, *conv)
    else:
        y = _LibraryConv.apply(x_cf, weight, *conv, True, True)
    return y.permute(0, 2, 3, 4, 1)


def conv3d_by_gemm(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """A conv whose stride is its kernel and whose padding is 0 (the 1^3
    conv, the 2^3 stride-2 patch embedding), as one GEMM on the
    channels-last layout: each output voxel reads its own k^3 block of
    input voxels and no two blocks overlap.

    x: (N, W, H, D, Cin), each spatial extent a multiple of the kernel's;
    kernel: (kw, kh, kd, Cin, Cout). Returns (N, W/kw, H/kh, D/kd, Cout) in
    x's dtype, summed by the GEMM (float32 sums for bfloat16)."""
    kw, kh, kd, cin, cout = kernel.shape
    n, W, H, D, _ = x.shape
    if W % kw or H % kh or D % kd:
        raise ValueError(f"conv3d_by_gemm: grid {(W, H, D)} is not a multiple of the kernel "
                         f"{(kw, kh, kd)}")
    # recorded only under the profiler: dtype, N, Cin, Cout, the input's
    # spatial shape and the kernel (= stride)
    count("gemm_conv", (str(x.dtype).replace("torch.", ""), n, cin, cout, (W, H, D),
                        (kw, kh, kd)))
    grid = (W // kw, H // kh, D // kd)
    if (kw, kh, kd) == (1, 1, 1):
        blocks = x.reshape(-1, cin)
    else:
        blocks = x.reshape(n, grid[0], kw, grid[1], kh, grid[2], kd, cin)
        blocks = blocks.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, kw * kh * kd * cin)
    return (blocks @ kernel.reshape(-1, cout)).view(n, *grid, cout)


def _phase_taps(k: int, s: int, p: int, q: int):
    """Along one axis, the taps t of the outputs o = s*m + q of a transposed
    conv (kernel k, stride s, padding p) and their input offsets d:
    out[s*m + q] = sum over t of x[m + d] w[t], d = (q + p - t) / s; sorted
    by offset."""
    taps = sorted((t for t in range(k) if (q + p - t) % s == 0), key=lambda t: -t)
    return taps, [(q + p - t) // s for t in taps]


@functools.lru_cache(maxsize=None)
def _phase_layout(k: Tuple[int, ...], stride: Tuple[int, ...], padding: Tuple[int, ...]):
    """The grouped kernel's layout for ``transposed_by_phases``: the lowest
    and highest input offset per axis, and for each output phase and cell
    of the common window the flat index (over the k^3 taps) of the tap it
    holds, or k^3, the zero appended after them, where no tap reaches."""
    axes = [[_phase_taps(kk, s, p, q) for q in range(s)]
            for kk, s, p in zip(k, stride, padding)]
    lows = tuple(min((o[0] for _, o in phases if o), default=0) for phases in axes)
    highs = tuple(max((o[-1] for _, o in phases if o), default=0) for phases in axes)
    phases = list(itertools.product(*(range(s) for s in stride)))
    index = np.full((len(phases), *(h - lo + 1 for lo, h in zip(lows, highs))),
                    int(np.prod(k)), dtype=np.int64)
    for i, q in enumerate(phases):
        per_axis = [axis[qq] for axis, qq in zip(axes, q)]
        for (tw, dw), (th, dh), (td, dd) in itertools.product(*(zip(*t) for t in per_axis)):
            index[i, dw - lows[0], dh - lows[1], dd - lows[2]] = (tw * k[1] + th) * k[2] + td
    return lows, highs, index


@functools.lru_cache(maxsize=None)
def _phase_index(k, stride, padding, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_phase_layout(k, stride, padding)[2]).to(device)


def transposed_by_phases(x: torch.Tensor, weight: torch.Tensor, stride, padding,
                         output_padding) -> torch.Tensor:
    """``F.conv_transpose3d(x, weight, ...)`` on (N, Cin, W, H, D) with
    torch's (Cin, Cout, kw, kh, kd) weight, computed as one forward conv over
    the input grid with s^3 * Cout outputs, one group of Cout per output
    phase (the outputs of one residue modulo the stride on each axis): each
    group's kernel holds the taps that reach its phase, at their input
    offsets, and zeros elsewhere in the common window (one gather from the
    cached layout). Interleaving the groups gives the transposed conv. The
    products are its products (and zeros); cuDNN's forward algorithms sum
    them in a fixed order, where its transposed-conv algorithms may not."""
    n, _, *size = x.shape
    cin, cout, *k = weight.shape
    k, stride, padding = tuple(k), tuple(stride), tuple(padding)
    out_size = [(i - 1) * s - 2 * p + kk + op for i, s, p, kk, op
                in zip(size, stride, padding, k, output_padding)]
    lows, highs, _ = _phase_layout(k, stride, padding)
    index = _phase_index(k, stride, padding, weight.device)
    taps = F.pad(weight.reshape(cin, cout, -1), (0, 1))  # the zero tap last
    kernel = taps[:, :, index].permute(2, 1, 0, 3, 4, 5).reshape(-1, cin, *index.shape[1:])
    rows = [-(-o // s) for o, s in zip(out_size, stride)]  # outputs of phase 0
    pads = []
    for lo, h, m, length in zip(reversed(lows), reversed(highs), reversed(rows),
                                reversed(size)):
        pads += [-lo, m - 1 + h - (length - 1)]
    _count_library_conv("forward", "by_phase", x, weight, stride)
    y = F.conv3d(F.pad(x, pads) if any(pads) else x, kernel)
    y = y.view(n, *stride, cout, *rows).permute(0, 4, 5, 1, 6, 2, 7, 3)
    y = y.reshape(n, cout, *(m * s for m, s in zip(rows, stride)))
    return y[:, :, :out_size[0], :out_size[1], :out_size[2]]


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
    an axis of size 1 repeats its one value. Through the hand kernel's
    autograd Function (``ops/upsample.py``; its plain version on a CPU
    tensor). ``align_corners=False`` is kept for the JAX package's signature
    and raises: no caller passes it."""
    if not align_corners:
        raise ValueError("upsample_trilinear2x runs only align_corners=True")
    return UpsampleTrilinear2x.apply(x)


def upsample_trilinear2x_sharded(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """``upsample_trilinear2x(x, align_corners=True)`` of a tensor whose W
    axis is sharded over the mesh's ``axis_name``: x is this rank's slab
    (N, w, H, D, C) and the result its slab (N, 2w, 2H, 2D, C) of the
    unsharded upsample. The align-corners source rows come from the global
    W (2w output rows from coordinate c times 2w on, scale (W - 1) /
    (2W - 1), in float32 as PyTorch computes it) and are gathered from the
    slab widened by one row of each neighbour's (parallel/halo.py), in
    float32; H and D then go through ``F.interpolate``, whose W scale is
    exactly 1 there, and the result is cast back to x's dtype."""
    from ..parallel.halo import halo_exchange

    ranks, me = mesh.shape[axis_name], mesh.coords[axis_name]
    n, w_loc, h, d, c = x.shape
    w_in = ranks * w_loc
    x_ext = halo_exchange(x, 1, mesh, axis_name, axis=1)
    scale = torch.tensor((w_in - 1) / (2 * w_in - 1), dtype=torch.float32)
    g = torch.arange(2 * w_loc, dtype=torch.float32) + float(me * 2 * w_loc)
    src = g * scale
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=w_in - 1)
    frac = (src - lo.float()).to(x.device).reshape(1, -1, 1, 1, 1)
    base = me * w_loc - 1  # the global row of x_ext's row 0
    a = x_ext[:, (lo - base).to(x.device)].float()
    b = x_ext[:, (hi - base).to(x.device)].float()
    out = a * (1 - frac) + b * frac
    y = F.interpolate(out.permute(0, 4, 1, 2, 3), size=(2 * w_loc, 2 * h, 2 * d),
                      mode="trilinear", align_corners=True)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)
