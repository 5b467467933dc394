"""Swin UNETR (Hatamizadeh et al., arXiv:2201.01266; MONAI
``monai/networks/nets/swin_unetr.py``, ``SwinUNETR`` v1) on channels-last
(N, W, H, D, C) tensors, the port's spatial order for MONAI's (d, h, w).

The Swin encoder (``swinViT``): a 2^3 stride-2 patch embedding to
``feature_size`` channels (with a bias, no norm), then four stages of
``depths[i]`` blocks at width feature_size * 2^i, each block
``x + attn(LN(x))`` then ``x + MLP(LN(x))`` (MLP: Linear(C, 4C), exact
GELU, Linear(4C, C)); odd blocks shift their windows by window // 2
(ops/window_attention.py). Each stage ends in PatchMerging: the 2^3
sub-grids of the tokens concatenated (in MONAI v1's ``PatchMerging`` order,
which takes the sub-grids (0, 1, 0) and (0, 0, 1) twice and (1, 1, 0) and
(0, 1, 1) not at all), LayerNorm(8C), Linear(8C, 2C) without bias. The
five hidden states (after the embedding and after each stage) go to the
decoder through ``proj_out``, a LayerNorm without weights (``normalize``).

The CNN decoder: ``encoder1`` on the input, ``encoder2``-``encoder4`` and
``encoder10`` on hidden states 0-2 and 4, then ``decoder5`` ... ``decoder1``,
each a 2^3 stride-2 transposed conv, the concatenation [up, skip] and a
residual block, and ``out``, a 1^3 conv with bias. The residual block
(MONAI's ``UnetResBlock``): 3^3 conv -> InstanceNorm -> LeakyReLU(0.01) ->
3^3 conv -> InstanceNorm, plus the input (through a 1^3 conv and
InstanceNorm where the width changes), then LeakyReLU; its convs have no
bias. The model returns logits.

The 3^3 convs run on the hand kernels (ops/conv3x3.py), the 1^3 convs and
the patch embedding as GEMMs (``PatchConv3d``), the transposed convs on
cuDNN (``PatchConvTranspose3d``). Submodule and parameter names are MONAI's,
except that no ``relative_position_index`` buffer is kept (the index is
computed from the window, ops/window_attention.py). While the profiler
records, the spans ``swin.encoder`` (the Swin encoder and the encoder
blocks) and ``swin.decoder`` (the decoder blocks and the out conv) cover
each forward's two halves.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import window_attention as wa
from ..utils.timer import span
from .components import Conv3d, InstanceNorm, LayerNorm, Linear, PatchConv3d, PatchConvTranspose3d

# MONAI v1 PatchMerging's sub-grids, by (W, H, D) offset, in concatenation order
MERGE_ORDER = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0), (0, 0, 1),
               (1, 1, 1))
LEAKY_SLOPE = 0.01


class WindowAttention(nn.Module):
    """MONAI's ``WindowAttention``: qkv (with bias where ``qkv_bias``), the
    relative position bias table ((2w - 1)^3, heads), the attention
    (ops/window_attention.py::window_attention) and the output projection."""

    def __init__(self, dim: int, num_heads: int, window: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window = (window,) * 3
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, num_heads))
        self.qkv = Linear(dim, 3 * dim, use_bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The bias table as MONAI draws it: normal, std 0.02, cut at +-2."""
        with torch.no_grad():
            table = self.relative_position_bias_table
            values = torch.empty(table.shape, dtype=table.dtype)
            table.copy_(nn.init.trunc_normal_(values, std=0.02, generator=generator))

    def bias(self, n: int) -> torch.Tensor:
        """(heads, n, n): the table at the window's relative index ``[:n, :n]``."""
        index = wa.relative_index(self.window, self.relative_position_bias_table.device)[:n, :n]
        table = self.relative_position_bias_table
        return table[index.reshape(-1)].view(n, n, -1).permute(2, 0, 1)

    def forward(self, windows: torch.Tensor, mask: Optional[torch.Tensor],
                stage: int) -> torch.Tensor:
        """(N * nW, n, C) windows -> (N * nW, n, C)."""
        bnw, n, c = windows.shape
        heads = self.num_heads
        qkv = self.qkv(windows).view(bnw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        out = wa.window_attention(qkv[0], qkv[1], qkv[2], self.bias(n), mask, stage)
        return self.proj(out.transpose(1, 2).reshape(bnw, n, c))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = Linear(dim, hidden)
        self.linear2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shifted: bool,
                 mlp_ratio: float, qkv_bias: bool):
        super().__init__()
        self.window = window
        self.shift = window // 2 if shifted else 0
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        n, W, H, D, _ = x.shape
        window, shift = wa.window_geometry((W, H, D), self.window, self.shift)
        mask = None
        if any(shift):
            mask = wa.region_mask(wa.padded_extent((W, H, D), window), window, shift, x.device)
        windows = wa.shifted_windows(self.norm1(x), window, shift)
        x = x + wa.merge_windows(self.attn(windows, mask, stage), window, shift, (n, W, H, D))
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim)
        self.reduction = Linear(8 * dim, 2 * dim, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, W, H, D, _ = x.shape
        if W % 2 or H % 2 or D % 2:
            x = F.pad(x, (0, 0, 0, D % 2, 0, H % 2, 0, W % 2))
        x = torch.cat([x[:, a::2, b::2, c::2] for a, b, c in MERGE_ORDER], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window: int, mlp_ratio: float,
                 qkv_bias: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window, i % 2 == 1, mlp_ratio, qkv_bias)
            for i in range(depth)])
        self.downsample = PatchMerging(dim)

    def forward(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, stage)
        return self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch_size: int):
        super().__init__()
        self.proj = PatchConv3d(in_channels, dim, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class SwinTransformer(nn.Module):
    def __init__(self, in_channels: int, feature_size: int, depths: Sequence[int],
                 num_heads: Sequence[int], window: int, patch_size: int, mlp_ratio: float,
                 qkv_bias: bool):
        super().__init__()
        self.patch_embed = PatchEmbed(in_channels, feature_size, patch_size)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            self.add_module(f"layers{i + 1}", nn.ModuleList([BasicLayer(
                feature_size * 2 ** i, depth, heads, window, mlp_ratio, qkv_bias)]))
        self.num_stages = len(depths)

    def forward(self, x: torch.Tensor, normalize: bool = True):
        """The hidden states after the embedding and after each stage,
        through ``proj_out``."""
        def proj_out(t):
            return F.layer_norm(t, (t.shape[-1],)) if normalize else t

        x = self.patch_embed(x)
        hidden = [proj_out(x)]
        for i in range(self.num_stages):
            x = getattr(self, f"layers{i + 1}")[0](x, i)
            hidden.append(proj_out(x))
        return hidden


class _Conv(nn.Module):
    """MONAI's ``Convolution`` holding one conv as ``conv``."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UnetResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = _Conv(Conv3d(in_channels, out_channels, 3, padding=1, use_bias=False))
        self.conv2 = _Conv(Conv3d(out_channels, out_channels, 3, padding=1, use_bias=False))
        self.norm1 = InstanceNorm()
        self.norm2 = InstanceNorm()
        if in_channels != out_channels:
            self.conv3 = _Conv(PatchConv3d(in_channels, out_channels, 1, use_bias=False))
            self.norm3 = InstanceNorm()
        else:
            self.conv3 = self.norm3 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu(self.norm1(self.conv1(x)), LEAKY_SLOPE)
        out = self.norm2(self.conv2(out))
        residual = x if self.conv3 is None else self.norm3(self.conv3(x))
        return F.leaky_relu(out + residual, LEAKY_SLOPE)


class UnetrBasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.transp_conv = _Conv(PatchConvTranspose3d(in_channels, out_channels, 2))
        self.conv_block = UnetResBlock(2 * out_channels, out_channels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))


class UnetOutBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = _Conv(PatchConv3d(in_channels, out_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class SwinUNETR(nn.Module):
    """Swin UNETR with MONAI v1's equations and names (module docstring).
    ``forward(x, generator=None)``: x (N, W, H, D, in_channels), each
    extent a multiple of patch_size * 2^len(depths) (32 for the published
    model); returns logits (N, W, H, D, out_channels) in x's dtype. The
    model has no dropout: ``generator`` is the trainer's argument, unused."""

    def __init__(self, in_channels: int, out_channels: int, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 2, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, normalize: bool = True):
        super().__init__()
        if len(depths) != 4 or len(num_heads) != 4:
            raise ValueError("SwinUNETR has four stages: depths and num_heads take four values")
        if feature_size % 12:
            raise ValueError(f"feature_size {feature_size} must be a multiple of 12")
        self.normalize = normalize
        self.divisor = patch_size * 2 ** len(depths)
        fs = feature_size
        self.swinViT = SwinTransformer(in_channels, fs, depths, num_heads, window_size,
                                       patch_size, mlp_ratio, qkv_bias)
        self.encoder1 = UnetrBasicBlock(in_channels, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = UnetOutBlock(fs, out_channels)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if any(s % self.divisor for s in x.shape[1:4]):
            raise ValueError(f"SwinUNETR takes extents that are multiples of {self.divisor}; "
                             f"got {tuple(x.shape[1:4])}")
        with span("swin.encoder"):
            hidden = self.swinViT(x, self.normalize)
            enc0 = self.encoder1(x)
            enc1 = self.encoder2(hidden[0])
            enc2 = self.encoder3(hidden[1])
            enc3 = self.encoder4(hidden[2])
            dec4 = self.encoder10(hidden[4])
        with span("swin.decoder"):
            dec3 = self.decoder5(dec4, hidden[3])
            dec2 = self.decoder4(dec3, enc3)
            dec1 = self.decoder3(dec2, enc2)
            dec0 = self.decoder2(dec1, enc1)
            return self.out(self.decoder1(dec0, enc0))
