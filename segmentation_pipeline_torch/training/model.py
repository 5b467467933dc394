"""SegModel: the runtime-facing model object.

Ported from segmentation_pipeline_tpu/training/model.py. Wraps an
``nn.Module`` that runs channels-last behind the channel-first
(N, C, W, H, D) API the predictors speak. Parameters are initialized lazily
from ``seed`` through a ``torch.Generator`` (its numbers differ from JAX's;
weights are shared with the JAX package through models/convert.py).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..models.components import BatchNorm, Conv3d, _ZeroBiasConv


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """(N, C, W, H, D) -> (N, W, H, D, C)."""
    return x.permute(0, 2, 3, 4, 1)


def to_channels_first(x: torch.Tensor) -> torch.Tensor:
    """(N, W, H, D, C) -> (N, C, W, H, D)."""
    return x.permute(0, 4, 1, 2, 3)


class SegModel:
    """Owns the module and its device; runs it in eval mode. A train step
    (training/train_step.py) updates the module in place, so calls after it
    serve the trained weights."""

    def __init__(self, module: nn.Module, seed: int = 0, compute_dtype: Optional[str] = None,
                 device=None):
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.seed = seed
        # mixed-precision inference: run the network in this dtype (e.g.
        # 'bfloat16'); parameters and BatchNorm statistics stay float32 and
        # outputs are cast back to float32.
        self.compute_dtype = compute_dtype
        self.initialized = False

    # ---- init ----------------------------------------------------------
    def ensure_initialized(self):
        """Initialize every parameter from ``seed`` unless weights were
        loaded: torch's Conv3d init for convs (the kernels of WSConv3d,
        BlurConv3d and BlurConvTranspose3d too, whose biases start at zero),
        ones/zeros for BatchNorm."""
        if self.initialized:
            return
        generator = torch.Generator().manual_seed(self.seed)
        for module in self.module.modules():
            if isinstance(module, (Conv3d, _ZeroBiasConv)):
                module.reset_parameters(generator)
            elif isinstance(module, BatchNorm):
                module.reset_parameters()
        self.initialized = True

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        """The module's parameters by state-dict name (live: training
        updates them in place)."""
        self.ensure_initialized()
        return dict(self.module.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics by state-dict name (live)."""
        self.ensure_initialized()
        return {name: buf for name, buf in self.module.named_buffers()
                if name.endswith(("running_mean", "running_var"))}

    # ---- inference -----------------------------------------------------
    def _dtype(self) -> Optional[torch.dtype]:
        if self.compute_dtype is None:
            return None
        dtype = getattr(torch, str(self.compute_dtype))
        return None if dtype == torch.float32 else dtype

    def __call__(self, x) -> torch.Tensor:
        """Channel-first in, channel-first float32 out; eval mode (no dropout,
        running BatchNorm statistics)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        self.ensure_initialized()
        self.module.eval()
        with torch.inference_mode():
            x_cl = to_channels_last(x)
            dtype = self._dtype()
            if dtype is not None:
                x_cl = x_cl.to(dtype)
            y = self.module(x_cl.contiguous())
            return to_channels_first(y.float())

    # ---- checkpointing -------------------------------------------------
    def state_dict(self) -> Dict[str, torch.Tensor]:
        if not self.initialized:
            return {}
        return self.module.state_dict()

    def load_state_dict(self, state):
        """Tensors or numpy arrays (a checkpoint's host copies), by
        state-dict name."""
        if state:
            self.module.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
            self.initialized = True

    @property
    def num_params(self) -> int:
        if not self.initialized:
            return 0
        return sum(p.numel() for p in self.module.parameters())
