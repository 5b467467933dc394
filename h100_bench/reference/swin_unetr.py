"""Swin UNETR (Hatamizadeh et al., arXiv:2201.01266; MONAI
``monai/networks/nets/swin_unetr.py``, ``SwinUNETR`` v1, the BTCV recipe of
Project-MONAI/research-contributions ``SwinUNETR/BTCV``) in plain PyTorch on
(N, C, W, H, D), following MONAI's code: ``SwinTransformer`` (patch
embedding, four ``BasicLayer`` stages of ``SwinTransformerBlock``s with
(shifted) window attention, ``PatchMerging``, ``proj_out``) and the
residual CNN decoder (``UnetrBasicBlock``, ``UnetrUpBlock``,
``UnetOutBlock``). Logits out.

The attention is written out: softmax(q k^T * hd^-1/2 + relative position
bias + region mask) v, the bias table indexed by the 7^3 window's relative
index ``[:n, :n]`` (as MONAI does where a stage clips the window to n
tokens), the region mask -100 between tokens of different regions of the
rolled volume, the zero-padded tokens unmasked. PatchMerging takes the
sub-grids in MONAI v1's order, (0, 1, 0) and (0, 0, 1) twice. State-dict
names are MONAI's (no ``relative_position_index`` buffer).

Convs go through ``layers.conv3d`` / ``layers.conv_transpose3d``; the
linears and both attention matmuls round their operands as ``layers``
rounds a conv's (``layers._round``), so ``layers.precision`` sets the
precision of every product: "f32" is float32 with TF32 off, "fp8" the
control of a bfloat16 cell. LayerNorm, InstanceNorm (eps 1e-5, no
affine) and the softmax are float32.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch import nn

from .layers import _round, conv3d, conv_transpose3d

MERGE_ORDER = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0), (0, 0, 1),
               (1, 1, 1))


def linear(x, weight, bias=None):
    return F.linear(_round(x), _round(weight), bias)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, 1e-5)


def get_window_size(size, window, shift):
    use_window, use_shift = list(window), list(shift)
    for i in range(len(size)):
        if size[i] <= window[i]:
            use_window[i] = size[i]
            use_shift[i] = 0
    return tuple(use_window), tuple(use_shift)


def window_partition(x, ws):
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows, ws, dims):
    b, d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def compute_mask(dims, ws, shift, device):
    img_mask = torch.zeros((1, *dims, 1), device=device)
    cnt = 0
    cuts = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(ws, shift)]
    for d, h, w in itertools.product(*cuts):
        img_mask[:, d, h, w, :] = cnt
        cnt += 1
    mask_windows = window_partition(img_mask, ws).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(attn_mask == 0, 0.0)


def relative_position_index(ws, device):
    coords = torch.stack(torch.meshgrid(*[torch.arange(w, device=device) for w in ws],
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 2] += ws[2] - 1
    rel[:, :, 0] *= (2 * ws[1] - 1) * (2 * ws[2] - 1)
    rel[:, :, 1] *= 2 * ws[2] - 1
    return rel.sum(-1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.window = (window,) * 3
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, mask):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = _round(q) @ _round(k).transpose(-2, -1)
        index = relative_position_index(self.window, x.device)[:n, :n].reshape(-1)
        bias = self.relative_position_bias_table[index].reshape(n, n, -1).permute(2, 0, 1)
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, self.heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.heads, n, n)
        attn = torch.softmax(attn.float(), dim=-1)
        out = (_round(attn) @ _round(v)).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = Linear(dim, hidden)
        self.linear2 = Linear(hidden, dim)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = (window,) * 3, (shift,) * 3
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x, mask_matrix):
        b, d, h, w, c = x.shape
        ws, shift = get_window_size((d, h, w), self.window, self.shift)
        shortcut = x
        x = self.norm1(x)
        pads = [(ws[i] - s % ws[i]) % ws[i] for i, s in enumerate((d, h, w))]
        x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        _, dp, hp, wp, _ = x.shape
        if any(i > 0 for i in shift):
            x = torch.roll(x, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
            mask = mask_matrix
        else:
            mask = None
        windows = self.attn(window_partition(x, ws), mask)
        x = window_reverse(windows.view(-1, *ws, c), ws, (b, dp, hp, wp))
        if any(i > 0 for i in shift):
            x = torch.roll(x, shifts=shift, dims=(1, 2, 3))
        x = shortcut + x[:, :d, :h, :w, :]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        _, d, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, a::2, b::2, c::2, :] for a, b, c in MERGE_ORDER], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = (window,) * 3, (window // 2,) * 3
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, heads, window, 0 if i % 2 == 0 else window // 2,
                                 mlp_ratio) for i in range(depth)])
        self.downsample = PatchMerging(dim)

    def forward(self, x):
        """(N, C, d, h, w) -> (N, 2C, d/2, h/2, w/2)."""
        b, c, d, h, w = x.shape
        ws, shift = get_window_size((d, h, w), self.window, self.shift)
        x = x.permute(0, 2, 3, 4, 1)
        padded = [-(-s // wsi) * wsi for s, wsi in zip((d, h, w), ws)]
        mask = compute_mask(padded, ws, shift, x.device)
        for blk in self.blocks:
            x = blk(x, mask)
        return self.downsample(x).permute(0, 4, 1, 2, 3)


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int):
        super().__init__()
        self.patch = patch
        self.proj = ConvLayer(cin, dim, patch, bias=True)

    def forward(self, x):
        return conv3d(x, self.proj.weight, self.proj.bias, stride=self.patch)


class ConvLayer(nn.Module):
    """A bare (Cout, Cin, k, k, k) weight and optional bias."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return conv3d(x, self.weight, self.bias, padding=self.weight.shape[-1] // 2)


class Convolution(nn.Module):
    """MONAI's ``Convolution``: the conv as ``conv``."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = False):
        super().__init__()
        self.conv = ConvLayer(cin, cout, k, bias)

    def forward(self, x):
        return self.conv(x)


class UnetResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Convolution(cin, cout, 3)
        self.conv2 = Convolution(cout, cout, 3)
        self.downsample = cin != cout
        if self.downsample:
            self.conv3 = Convolution(cin, cout, 1)

    def forward(self, x):
        out = F.leaky_relu(F.instance_norm(self.conv1(x), eps=1e-5), 0.01)
        out = F.instance_norm(self.conv2(out), eps=1e-5)
        residual = F.instance_norm(self.conv3(x), eps=1e-5) if self.downsample else x
        return F.leaky_relu(out + residual, 0.01)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.layer = UnetResBlock(cin, cout)

    def forward(self, x):
        return self.layer(x)


class TransposedConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 2, 2, 2))


class UnetrUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.transp_conv = nn.Module()
        self.transp_conv.conv = TransposedConv(cin, cout)
        self.conv_block = UnetResBlock(2 * cout, cout)

    def forward(self, x, skip):
        up = conv_transpose3d(x, self.transp_conv.conv.weight, stride=2, padding=0)
        return self.conv_block(torch.cat((up, skip), dim=1))


class UnetOutBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Convolution(cin, cout, 1, bias=True)

    def forward(self, x):
        return self.conv(x)


class SwinTransformer(nn.Module):
    def __init__(self, cin, fs, depths, heads, window, patch, mlp_ratio):
        super().__init__()
        self.patch_embed = PatchEmbed(cin, fs, patch)
        for i in range(4):
            self.add_module(f"layers{i + 1}", nn.ModuleList(
                [BasicLayer(fs * 2 ** i, depths[i], heads[i], window, mlp_ratio)]))

    @staticmethod
    def proj_out(x):
        x = x.permute(0, 2, 3, 4, 1)
        return F.layer_norm(x, (x.shape[-1],)).permute(0, 4, 1, 2, 3)

    def forward(self, x):
        x = self.patch_embed(x)
        out = [self.proj_out(x)]
        for i in range(4):
            x = getattr(self, f"layers{i + 1}")[0](x.contiguous())
            out.append(self.proj_out(x))
        return out


class SwinUNETR(nn.Module):
    def __init__(self, cin: int, cout: int, fs: int = 48, depths=(2, 2, 2, 2),
                 heads=(3, 6, 12, 24), window: int = 7, patch: int = 2, mlp_ratio: float = 4.0):
        super().__init__()
        self.swinViT = SwinTransformer(cin, fs, depths, heads, window, patch, mlp_ratio)
        self.encoder1 = UnetrBasicBlock(cin, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = UnetOutBlock(fs, cout)

    def forward(self, x, generator=None):
        hidden = self.swinViT(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(hidden[0])
        enc2 = self.encoder3(hidden[1])
        enc3 = self.encoder4(hidden[2])
        dec4 = self.encoder10(hidden[4])
        dec3 = self.decoder5(dec4, hidden[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        return self.out(self.decoder1(dec0, enc0))


def build(config: dict) -> SwinUNETR:
    """The configuration file's keys: input/output channels, feature_size,
    depths, num_heads, window_size, patch_size, mlp_ratio (qkv_bias true,
    normalize true and no dropout, as the recipe's)."""
    if not config.get("qkv_bias", True) or not config.get("normalize", True):
        raise ValueError("the reference follows the recipe: qkv_bias and normalize true")
    return SwinUNETR(config["input_channels"], config["output_channels"],
                     config["feature_size"], tuple(config["depths"]), tuple(config["num_heads"]),
                     config["window_size"], config["patch_size"], config["mlp_ratio"])


def flops(config: dict, shape) -> int:
    """The model FLOPs of one forward at input ``shape`` (N, C, W, H, D):
    2 per multiply-add of every conv (3^3, 1^3, the patch embedding, the
    transposed convs), every linear (on the padded windows where they run
    there) and both attention matmuls (q k^T and p v), counted on the meta
    device."""
    from torch.utils.flop_counter import FlopCounterMode

    module = build(config).to("meta").eval()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        module(torch.zeros(shape, device="meta"))
    return int(counter.get_total_flops())
