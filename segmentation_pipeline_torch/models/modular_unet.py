"""ModularUNet — configurable-depth UNet with injectable components,
channels-last.

Ported from segmentation_pipeline_tpu/models/modular_unet.py: an encoder of
``depth`` blocks with injected down- and up-sampler classes (AvgPool or
BlurConv3d down; trilinear or BlurConvTranspose3d up), a decoder that
concatenates ``[upsampled, skip]``, a 3^3 out conv and the hypothesis head.
The samplers keep their channel count (filters[i] -> filters[i]). Submodule
names are flax's (``down_block_i``, ``down_i``, ``up_i``, ``up_block_i``,
``out_conv``), so that models/convert.py maps weights by name; torch-style
keyword names in the ``*_params`` dicts are accepted, as there.

flax infers each submodule's input width; here every constructor that takes
``in_channels`` gets it: ``down_block_i`` reads ``in_channels`` (i = 0) or
``filters[i-1]``, ``down_i`` and ``up_i`` read the width they keep,
``up_block_i`` reads ``filters[i+1] + filters[i]`` and ``out_conv``
``filters[0]``.

``remat=True`` rematerializes every block in a train-mode forward under
autograd, as the JAX package's ``nn.remat(block_class)``: the block's
activations are dropped after the forward and recomputed in the backward
(``rematerialized``).
"""
from __future__ import annotations

import contextlib
import inspect
from typing import Any, Dict, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .components import AvgPoolDown, Block3d, Conv3d, Softmax, TrilinearUp, statistics_frozen

_TORCH_PARAM_MAP = {
    "kernel_size": "kernel_size",
    "stride": "stride",
    "padding": "padding",
    "output_padding": "output_padding",
    "bias": "use_bias",
    "weight_standardization": "weight_standardization",
}


def _map_params(cls, params: Optional[Dict], features: Optional[int],
                in_channels: Optional[int]) -> Dict:
    """Translate torch-style keyword names to the components' own, keep only
    those the class takes, and inject ``features`` and ``in_channels`` where
    it takes them."""
    out = {_TORCH_PARAM_MAP.get(k, k): v for k, v in (params or {}).items()}
    accepted = inspect.signature(cls).parameters
    out = {k: v for k, v in out.items() if k in accepted}
    for name, value in (("features", features), ("in_channels", in_channels)):
        if value is not None and name in accepted:
            out[name] = value
    return out


def rematerialized(block: nn.Module, x: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block(x, generator)`` under a non-reentrant ``torch.utils.checkpoint``
    that keeps flax's ``nn.remat`` contract: the recompute in the backward
    draws the forward's dropout mask (``generator`` set back to its state
    before the block, and returned to where it stood after the recompute)
    and leaves BatchNorm's running statistics alone (``statistics_frozen``),
    so loss, gradients, statistics and the generator's state equal those of
    the plain call. The block draws from ``generator`` only, so the global
    RNG states are not saved."""
    before = generator.get_state() if generator is not None else None

    @contextlib.contextmanager
    def recompute():
        after = generator.get_state() if generator is not None else None
        if generator is not None:
            generator.set_state(before)
        try:
            with statistics_frozen(block):
                yield
        finally:
            if generator is not None:
                generator.set_state(after)

    return checkpoint(block, x, generator, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), recompute()))


class ModularUNet(nn.Module):
    """x: (N, W, H, D, in_channels) -> the hypothesis of out_channels
    (channel softmax by default). Spatial sizes must halve ``depth - 1``
    times.

    ``remat`` rematerializes the blocks in train mode when autograd records
    (msseg2 builds with it); in eval mode, or without autograd, it changes
    nothing."""

    def __init__(self, in_channels: int, out_channels: int,
                 filters: Union[int, Sequence[int]], depth: int,
                 block_class: Any = Block3d, block_params: Optional[Dict] = None,
                 upsample_class: Any = TrilinearUp, upsample_params: Optional[Dict] = None,
                 downsample_class: Any = AvgPoolDown, downsample_params: Optional[Dict] = None,
                 out_conv_class: Any = Conv3d, out_conv_params: Optional[Dict] = None,
                 hypothesis_class: Any = Softmax, hypothesis_params: Optional[Dict] = None,
                 remat: bool = False):
        super().__init__()
        if isinstance(filters, int):
            filters = [filters] * depth
        elif len(filters) != depth:
            raise ValueError(f"Sequence of filters {filters} does not match depth {depth}")
        filters = list(filters)
        self.depth = depth
        self.remat = remat

        for i in range(depth):
            cin = in_channels if i == 0 else filters[i - 1]
            self.add_module(f"down_block_{i}", block_class(
                **_map_params(block_class, block_params, filters[i], cin)))
        for i in range(depth - 1):
            self.add_module(f"down_{i}", downsample_class(
                **_map_params(downsample_class, downsample_params, filters[i], filters[i])))
        for i in range(depth - 1):
            self.add_module(f"up_block_{i}", block_class(
                **_map_params(block_class, block_params, filters[i],
                              filters[i + 1] + filters[i])))
        for i in range(depth - 1):
            self.add_module(f"up_{i}", upsample_class(
                **_map_params(upsample_class, upsample_params, filters[i + 1],
                              filters[i + 1])))
        self.out_conv = out_conv_class(**_map_params(
            out_conv_class, out_conv_params or {"kernel_size": 3, "padding": 1},
            out_channels, filters[0]))
        self.hypothesis = hypothesis_class(**(hypothesis_params or {}))

    def _block(self, name: str, x: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        block = getattr(self, name)
        if self.remat and self.training and torch.is_grad_enabled():
            return rematerialized(block, x, generator)
        return block(x, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        skips = []
        for i in range(self.depth):
            x = self._block(f"down_block_{i}", x, generator)
            if i != self.depth - 1:
                skips.append(x)
                x = getattr(self, f"down_{i}")(x)
        for i in reversed(range(self.depth - 1)):
            x = getattr(self, f"up_{i}")(x)
            x = self._block(f"up_block_{i}", torch.cat([x, skips[i]], dim=-1), generator)
        return self.hypothesis(self.out_conv(x))
