"""Model building blocks over channels-last (N, W, H, D, C) tensors.

Ported from segmentation_pipeline_tpu/models/components.py (Conv3d, WSConv3d,
BlurConv3d, BlurConvTranspose3d, Block3d, AvgPoolDown, TrilinearUp, Softmax,
StochasticMatrix)
and flax's BatchNorm as Block3d uses it. InstanceNorm, LayerNorm, Linear,
PatchConv3d and PatchConvTranspose3d are Swin UNETR's (models/swin_unetr.py;
the JAX package has no such model). Submodule names follow the flax tree
(``Conv3d_0``, ``BatchNorm_0``, ``res_conv``) and every conv weight is
torch's (Cout, Cin, kw, kh, kd), so that models/convert.py maps weights by
name. Convs route through ops/convolution.py.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.convolution import (avg_pool3d, conv3d, conv3d_by_gemm, conv_transpose3d,
                               upsample_trilinear2x)
from ..utils.timer import count


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
    conv output's dtype.

    Inside ``spatially_sharded`` (``spatial`` is a (mesh, axis name) pair)
    x is this rank's slab of a volume whose W axis is sharded over that
    axis, and the conv, 3^3/s1/p1 only, is the unsharded one's slab
    (parallel/halo.py::halo_conv3d, on the hand kernels)."""

    def __init__(self, in_channels: int, features: int, kernel_size: Any = 3,
                 stride: Any = 1, padding: Any = 0, use_bias: bool = True):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(features, in_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.spatial = None  # (mesh, axis name) inside spatially_sharded
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        torch_conv_kernel_init(self.weight, generator)
        if self.bias is not None:
            bound = 1.0 / math.sqrt(math.prod(self.weight.shape[1:]))
            with torch.no_grad():
                values = torch.empty(self.bias.shape, dtype=self.bias.dtype)
                self.bias.copy_(values.uniform_(-bound, bound, generator=generator))

    def shardable(self) -> bool:
        """Whether the conv runs on W-sharded slabs: the 3^3/s1/p1 class."""
        return self.kernel_size == (3, 3, 3) and _triple(self.stride) == (1, 1, 1) \
            and _triple(self.padding) == (1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.weight.permute(2, 3, 4, 1, 0).to(x.dtype)
        if self.spatial is not None:
            from ..parallel.halo import halo_conv3d

            y = halo_conv3d(x, kernel, *self.spatial)
        else:
            y = conv3d(x, kernel, stride=self.stride, padding=self.padding)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def _standardize(weight: torch.Tensor) -> torch.Tensor:
    """Weight standardization, as the JAX package's: per output channel, zero
    mean and unit std over (Cin, kw, kh, kd), the variance unbiased and 1e-5
    added to the std. weight: (Cout, Cin, kw, kh, kd)."""
    axes = (1, 2, 3, 4)
    mean = weight.mean(dim=axes, keepdim=True)
    n = math.prod(weight.shape[1:])
    var = ((weight - mean) ** 2).sum(dim=axes, keepdim=True) / max(n - 1, 1)
    return (weight - mean) / (torch.sqrt(var) + 1e-5)


def _blur_weight(weight: torch.Tensor, scale: float) -> torch.Tensor:
    """2x2x2 box blur of a conv weight with zero padding 1: (Cout, Cin, k, k, k)
    -> (Cout, Cin, k+1, k+1, k+1), each tap the sum of a 2^3 neighbourhood
    times ``scale``, summed in the JAX package's order (the reference blurs
    weights, not activations)."""
    k = weight.shape[2:]
    padded = F.pad(weight, (1, 1, 1, 1, 1, 1))
    out = torch.zeros((*weight.shape[:2], k[0] + 1, k[1] + 1, k[2] + 1),
                      dtype=weight.dtype, device=weight.device)
    for dw in range(2):
        for dh in range(2):
            for dd in range(2):
                out = out + padded[:, :, dw:dw + k[0] + 1, dh:dh + k[1] + 1, dd:dd + k[2] + 1]
    return out * scale


class _ZeroBiasConv(nn.Module):
    """What WSConv3d, BlurConv3d and BlurConvTranspose3d share: a weight
    (Cout, Cin, kw, kh, kd) with torch's conv init, standardized before use
    if asked, and a bias that starts at zero."""

    def __init__(self, in_channels: int, features: int, kernel_size: Any, stride: Any,
                 padding: Any, use_bias: bool, weight_standardization: bool):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.stride = _triple(stride)
        self.padding = padding
        self.weight_standardization = weight_standardization
        self.weight = nn.Parameter(torch.empty(features, in_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        torch_conv_kernel_init(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def _weight(self) -> torch.Tensor:
        return _standardize(self.weight) if self.weight_standardization else self.weight

    def _add_bias(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.bias is None else y + self.bias.to(y.dtype)


class WSConv3d(_ZeroBiasConv):
    """Weight-standardized conv: the kernel standardized per output channel
    before the conv."""

    def __init__(self, in_channels: int, features: int, kernel_size: Any = 3,
                 stride: Any = 1, padding: Any = 0, use_bias: bool = True):
        super().__init__(in_channels, features, kernel_size, stride, padding, use_bias,
                         weight_standardization=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self._weight().permute(2, 3, 4, 1, 0).to(x.dtype)
        return self._add_bias(conv3d(x, kernel, stride=self.stride, padding=self.padding))


class BlurConv3d(_ZeroBiasConv):
    """Anti-aliased strided conv: the weight blurred by a 2^3 box to extent
    k+1, each tap 1/(8 * prod(stride)). The blur is computed in float32 and
    cast to x's dtype."""

    def __init__(self, in_channels: int, features: int, kernel_size: Any = 3,
                 stride: Any = 2, padding: Any = 1, use_bias: bool = True,
                 weight_standardization: bool = False):
        super().__init__(in_channels, features, kernel_size, stride, padding, use_bias,
                         weight_standardization)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blurred = _blur_weight(self._weight(), 1.0 / (8.0 * math.prod(self.stride)))
        kernel = blurred.permute(2, 3, 4, 1, 0).to(x.dtype)
        return self._add_bias(conv3d(x, kernel, stride=self.stride, padding=self.padding))


class BlurConvTranspose3d(_ZeroBiasConv):
    """Anti-aliased transposed conv: the weight blurred by a 2^3 box to
    extent k+1, each tap prod(stride)/8; out = (in - 1) * s - 2p + (k + 1) +
    output_padding."""

    def __init__(self, in_channels: int, features: int, kernel_size: Any = 3,
                 stride: Any = 2, padding: Any = 1, output_padding: Any = 0,
                 use_bias: bool = True, weight_standardization: bool = False):
        super().__init__(in_channels, features, kernel_size, stride, padding, use_bias,
                         weight_standardization)
        self.output_padding = output_padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blurred = _blur_weight(self._weight(), math.prod(self.stride) / 8.0)
        kernel = blurred.permute(2, 3, 4, 1, 0).to(x.dtype)
        return self._add_bias(conv_transpose3d(x, kernel, stride=self.stride,
                                               padding=self.padding,
                                               output_padding=self.output_padding))


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

    Inside ``statistics_frozen`` a train-mode forward normalizes as always
    but leaves the running statistics alone: the recompute of a
    rematerialized block must not move them a second time.

    Inside ``data_parallel`` (a mesh's train step) the statistics are those
    of the global batch, as GSPMD computes them in the JAX package: each
    rank's sums of x and x^2 are summed over the mesh axes that shard the
    batch's voxels (its rows, and a spatial axis's W slabs) by a
    differentiable all-reduce and divided by the global batch's voxel
    count, so the running statistics move alike on every rank.
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
        self.frozen = False
        self.shard = None  # a parallel.mesh.BatchShard inside data_parallel

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
        if self.shard is None:
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        else:
            from ..parallel.mesh import all_reduce_sum

            count = xf.numel() // xf.shape[-1] * self.shard.voxels
            sums = all_reduce_sum(torch.stack([xf.sum(axes), (xf * xf).sum(axes)]),
                                  self.shard.mesh, self.shard.axes) / count
            mean = sums[0]
            var = torch.clamp(sums[1] - mean * mean, min=0.0)
        if not self.frozen:
            with torch.no_grad():
                self.running_mean.copy_(self.MOMENTUM * self.running_mean
                                        + (1 - self.MOMENTUM) * mean)
                self.running_var.copy_(self.MOMENTUM * self.running_var
                                       + (1 - self.MOMENTUM) * var)
                self.num_batches_tracked += 1
        y = (xf - mean) * (torch.rsqrt(var + self.EPS) * self.weight) + self.bias
        return y.to(x.dtype)


class InstanceNorm(nn.Module):
    """InstanceNorm over a channels-last (N, W, H, D, C) tensor, as MONAI's
    ``norm_name="instance"`` (torch's InstanceNorm3d: no affine, no running
    statistics, eps 1e-5): each sample's channels normalized by their mean
    and biased variance over the spatial axes, with no permute to NCDHW.

    The statistics are float32 for any input dtype: ``torch.var_mean`` of
    x in float32 (Welford's one-pass update, which keeps the variance
    accurate where the mean is large against the spread; E[x^2] - E[x]^2
    in float32 put the 3^3 decoder's gradients 1e-2 away from the
    reference's on the CPU). The output is normalized in float32 and
    written in x's dtype: where a gradient is recorded as (x - mean) *
    rstd, else in one pass as x * rstd - mean * rstd (whose cancellation
    costs float32 rounding times |mean| / std, far under a bfloat16
    output's rounding). The one pass reads x once and writes the output
    once; the other path makes three float32 temporaries. On an H100 in
    bfloat16 at N=4 the one pass took 0.908 ms and the other 1.984 ms at
    96^3 x 48, 0.125 and 0.263 ms at 48^3 x 48, 0.239 and 0.509 ms at
    48^3 x 96. While the profiler records, each call adds one to
    the ``instance_norm`` counter of utils/timer.py under (N, C, voxels,
    dtype)."""

    EPS = 1e-5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        axes = tuple(range(1, x.dim() - 1))
        count("instance_norm", (n, c, x.numel() // max(n * c, 1),
                                str(x.dtype).replace("torch.", "")))
        var, mean = torch.var_mean(x.float(), dim=axes, correction=0, keepdim=True)
        scale = torch.rsqrt(var + self.EPS)
        if torch.is_grad_enabled():
            return ((x.float() - mean) * scale).to(x.dtype)
        return torch.addcmul(-mean * scale, x, scale, out=torch.empty_like(x))


class LayerNorm(nn.Module):
    """torch's LayerNorm over the channel (last) axis, eps 1e-5, with a
    learned scale and shift cast to x's dtype; ``F.layer_norm`` keeps the
    statistics in float32 for bfloat16 inputs."""

    EPS = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.features = features
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (self.features,), self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.EPS)


class Linear(nn.Module):
    """A dense layer over the channel (last) axis: torch's Linear (weight
    (out, in), bias (out,), its default init), with the weight and bias
    cast to x's dtype, so that a bfloat16 network keeps float32
    parameters."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            for p in (self.weight, self.bias):
                if p is not None:
                    values = torch.empty(p.shape, dtype=p.dtype)
                    p.copy_(values.uniform_(-bound, bound, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class PatchConv3d(nn.Module):
    """A conv whose stride is its kernel and padding 0 (the 1^3 conv, the
    2^3 stride-2 patch embedding) on channels-last input, as one GEMM
    (ops/convolution.py::conv3d_by_gemm). Weight (Cout, Cin, k, k, k) and
    optional bias, torch's conv init; the bias is added in the output's
    dtype."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_channels, *_triple(kernel_size)))
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
        y = conv3d_by_gemm(x, self.weight.permute(2, 3, 4, 1, 0).to(x.dtype))
        return y if self.bias is None else y + self.bias.to(y.dtype)


class PatchConvTranspose3d(nn.Module):
    """A transposed conv whose stride is its kernel and padding 0 (the 2^3
    stride-2 up-sampler) on channels-last input, with no bias, through
    ops/convolution.py::conv_transpose3d (cuDNN). Weight torch's
    ConvTranspose3d layout (Cin, Cout, k, k, k), torch's conv init over its
    trailing axes."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 2):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.weight = nn.Parameter(torch.empty(in_channels, features, *self.kernel_size))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        torch_conv_kernel_init(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose3d(x, self.weight.permute(2, 3, 4, 0, 1).to(x.dtype),
                                stride=self.kernel_size, padding=0)


@contextlib.contextmanager
def statistics_frozen(module: nn.Module):
    """Every BatchNorm in ``module`` keeps its running statistics inside the
    block (``BatchNorm.frozen``), and takes updates again after it."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.frozen = False


@contextlib.contextmanager
def data_parallel(module: nn.Module, shard):
    """Inside the block, ``module`` runs a rank's rows of a global batch
    (``shard``, a parallel.mesh.BatchShard): every BatchNorm normalizes with
    the global batch's statistics and every Block3d's channel dropout keeps
    its rows of the global batch's masks. Wrap the backward pass too: the
    recompute of a rematerialized block runs there."""
    members = [m for m in module.modules() if isinstance(m, (BatchNorm, Block3d))]
    for m in members:
        m.shard = shard
    try:
        yield
    finally:
        for m in members:
            m.shard = None


@contextlib.contextmanager
def spatially_sharded(module: nn.Module, mesh, axis_name: str):
    """Inside the block, ``module`` (a NestedResUNet) runs on this rank's
    slab of volumes whose W axis is sharded over the mesh's ``axis_name``:
    every conv halo-exchanges one row (``Conv3d``), the 2x upsample is
    ``upsample_trilinear2x_sharded``, pooling stays on the slab. Pair it
    with ``data_parallel`` in train mode (BatchNorm's statistics over the
    slabs, dropout masks alike on a sample's slabs). A conv of another
    class or shape raises: it would compute wrong values at the slab
    boundaries."""
    if not getattr(module, "spatially_shardable", False):
        raise TypeError(f"{type(module).__name__} does not run on W-sharded volumes (the "
                        "NestedResUNet does)")
    convs = [m for m in module.modules() if isinstance(m, (nn.Conv3d, _ZeroBiasConv, Conv3d))]
    for m in convs:
        if not (isinstance(m, Conv3d) and m.shardable()):
            raise ValueError(f"spatial sharding supports the 3^3/s1/p1 Conv3d; "
                             f"{type(m).__name__} {getattr(m, 'kernel_size', '')} would "
                             f"compute wrong values at the slab boundaries")
    members = convs + [module]
    for m in members:
        m.spatial = (mesh, axis_name)
    try:
        yield
    finally:
        for m in members:
            m.spatial = None


def channel_dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
                    shard=None) -> torch.Tensor:
    """Drop whole channels of a channels-last (N, W, H, D, C) tensor with
    probability p, scaling the kept ones by 1 / (1 - p): one draw per
    (sample, channel) from ``generator``, as flax's ``nn.Dropout(rate=p,
    broadcast_dims=(1, 2, 3))`` draws from its explicit key. With a
    ``shard`` (parallel.mesh.BatchShard) x holds its rows of a global batch:
    the masks of the whole global batch are drawn and its rows kept, so a
    mesh step drops what the one-device step drops."""
    if generator is None:
        raise ValueError("channel dropout in train mode needs a torch.Generator")
    n, c = x.shape[0], x.shape[-1]
    if shard is None:
        keep = torch.rand((n, 1, 1, 1, c), generator=generator, device=x.device) >= p
    else:
        keep = torch.rand((shard.n_global, 1, 1, 1, c), generator=generator,
                          device=x.device)[shard.rows] >= p
    return x * keep / (1.0 - p)


class Block3d(nn.Module):
    """n x (conv -> BatchNorm -> ReLU), optional residual 3^3 conv, channel
    dropout in train mode (drawn from the generator given to ``forward``).
    BatchNorm keeps its statistics in float32 and normalizes inputs of any
    dtype; ``use_norm=False`` leaves it out."""

    def __init__(self, in_channels: int, features: int, num_convs: int = 2,
                 residual: bool = False, dropout_p: float = 0.0, use_norm: bool = True):
        super().__init__()
        self.num_convs = num_convs
        self.use_norm = use_norm
        for i in range(num_convs):
            cin = in_channels if i == 0 else features
            self.add_module(f"Conv3d_{i}", Conv3d(cin, features, kernel_size=3,
                                                  padding=1, use_bias=False))
            if use_norm:
                self.add_module(f"BatchNorm_{i}", BatchNorm(features))
        self.res_conv = (Conv3d(in_channels, features, kernel_size=3, padding=1)
                         if residual else None)
        self.dropout_p = dropout_p
        self.shard = None  # a parallel.mesh.BatchShard inside data_parallel

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x_in = x
        for i in range(self.num_convs):
            x = getattr(self, f"Conv3d_{i}")(x)
            if self.use_norm:
                x = getattr(self, f"BatchNorm_{i}")(x)
            x = F.relu(x)
        if self.res_conv is not None:
            x = self.res_conv(x_in) + x
        if self.training and self.dropout_p > 0.0:
            x = channel_dropout(x, self.dropout_p, generator, self.shard)
        return x


class AvgPoolDown(nn.Module):
    """AvgPool3d(2, 2) down-sampler, ModularUNet's default."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool3d(x, 2)


class TrilinearUp(nn.Module):
    """Trilinear 2x up-sampler (align_corners=True), ModularUNet's default."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_trilinear2x(x, align_corners=True)


class Softmax(nn.Module):
    """Channel softmax hypothesis head (channels-last)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x, dim=-1)


class StochasticMatrix(nn.Module):
    """The cascade head: (..., C^2) -> the per-voxel C x C transition matrix
    (row-major), with ``diag_bias`` added to its diagonal when given and a
    softmax over its rows (each column sums to 1), flattened back. No
    parameters."""

    def __init__(self, channels: int, diag_bias: Optional[float] = None):
        super().__init__()
        self.channels = channels
        self.diag_bias = diag_bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = self.channels
        if x.shape[-1] != C * C:
            raise RuntimeError(
                "Expected final dim of input tensor to be the square of the number "
                "of out channels")
        shape = x.shape
        x = x.reshape(*shape[:-1], C, C)  # (..., row, col)
        if self.diag_bias is not None:
            x = x + torch.eye(C, dtype=x.dtype, device=x.device) * self.diag_bias
        x = torch.softmax(x, dim=-2)
        return x.reshape(shape)
