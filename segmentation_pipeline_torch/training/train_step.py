"""The train step: forward in train mode, hybrid loss, backward, optimizer
step.

Ported from segmentation_pipeline_tpu/training/train_step.py
(``make_train_step``, ``create_train_state``, ``collate_to_device``).
PyTorch runs the step eagerly; the JAX package jits it into one XLA
program. The state is the module's own parameters and
BatchNorm statistics, updated in place, and the torch optimizer that holds
the moments, so a ``SegModel`` whose module was trained serves the trained
weights.

With ``compute_dtype`` ('bfloat16') the network runs forward and backward in
that dtype; parameters, optimizer state, BatchNorm statistics, the loss and
the returned prediction stay float32.

With a ``mesh`` (parallel/mesh.py: one process per device) each rank runs
its rows of the global batch. BatchNorm normalizes with the global batch's
statistics and dropout keeps the rank's rows of the global masks
(models/components.py::data_parallel); each rank back-propagates its share
of the global mean loss and the gradients are summed over the ranks before
the optimizer steps, so every rank takes the step of the global batch, the
one GSPMD takes in the JAX package.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..models.components import data_parallel
from ..parallel.mesh import (SPATIAL_ITEM, BatchShard, all_reduce_gradients, all_reduce_sum)
from .model import to_channels_last
from .optimizers import OptimizerFactory


class TrainState(NamedTuple):
    step: int
    params: Dict[str, nn.Parameter]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: torch.optim.Optimizer


def create_train_state(model, optimizer: OptimizerFactory,
                       example_batch_cf: Dict[str, Any]) -> TrainState:
    """model: SegModel; optimizer: a factory from training/optimizers.py.
    The state lives where the model does, and a model on the card raises
    where there is none. ``example_batch_cf`` ({'X': (N, C, W, H, D), ...})
    keeps the JAX package's signature: torch modules make their parameters
    at construction, so no example shapes them."""
    resolve_device(model.device)
    params = model.params
    return TrainState(step=0, params=params, batch_stats=model.batch_stats,
                      opt_state=optimizer.init(params.values()))


def split_and_flip_cl(x: torch.Tensor) -> torch.Tensor:
    """Sagittal hemisphere split into the batch, channels-last:
    (N, W, H, D, C) -> (2N, W/2, H, D, C), the second half mirrored."""
    half = x.shape[1] // 2
    return torch.cat([x[:, :half], torch.flip(x[:, half:], dims=(1,))], dim=0)


def reverse_split_and_flip_cl(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[0] // 2
    return torch.cat([x[:half], torch.flip(x[half:], dims=(1,))], dim=1)


def _normalize_compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """None and float32 mean full float32; a name such as 'bfloat16' or a
    torch dtype runs the network in that dtype."""
    if compute_dtype is None:
        return None
    dtype = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
    return None if dtype == torch.float32 else dtype


def apply_stochastic_matrix_cl(y_pred: torch.Tensor, y_prior: torch.Tensor) -> torch.Tensor:
    """Channels-last cascade contraction: y_pred (..., C^2) holds per-voxel
    column-stochastic C x C matrices (row-major); refined[..., row] =
    sum_col M[row, col] * prior[..., col], in y_pred's dtype (an integer
    one-hot prior is promoted)."""
    C = y_prior.shape[-1]
    M = y_pred.reshape(*y_pred.shape[:-1], C, C)
    return torch.einsum("...rc,...c->...r", M, y_prior.to(M.dtype))


def make_train_step(module: nn.Module, criterion, optimizer: OptimizerFactory,
                    mesh=None, data_axis: str = "data", sagittal_split: bool = False,
                    compute_dtype=None, refine_image: Optional[str] = None) -> Callable:
    """Returns train_step(state, batch_cl, generator) -> (state, loss_dict,
    y_pred).

    batch_cl: {'X': (N, W, H, D, C), 'y': (N, W, H, D, C)} channels-last, on
    the module's device (``collate_to_device``). ``generator`` is the
    ``torch.Generator`` on that device that the blocks' channel dropout
    draws from. ``optimizer`` is the factory that made ``state.opt_state``;
    the torch optimizer in the state carries the update (with
    ``accumulate_steps > 1`` a ``MultiSteps`` that banks the gradients and
    moves the parameters on every k-th step only). The returned prediction
    is the train-mode one, float32 and detached.

    With a ``mesh`` the batch holds this rank's rows (``collate_to_device(...,
    mesh=mesh)``) and every rank gets the same ``generator`` state; the
    returned ``loss_dict`` holds the global batch's losses on every rank and
    the prediction is this rank's rows. The sagittal split keeps the JAX
    package's global order: the split batch holds half 1 of subject i at row
    i and half 2 at row N + i, and dropout draws at those rows.
    """
    compute_dtype = _normalize_compute_dtype(compute_dtype)
    if mesh is not None and data_axis != mesh.data_axis:
        raise NotImplementedError(f"a train step over mesh axis {data_axis!r} waits for the "
                                  f"port of {SPATIAL_ITEM}")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor], torch.Tensor]:
        if not optimizer.made(state.opt_state):
            raise TypeError(f"state.opt_state is a {type(state.opt_state).__name__}, not "
                            f"made by {optimizer!r}")
        module.train()
        x = batch["X"]
        share, sharded = 1.0, contextlib.nullcontext()
        if mesh is not None:
            shard = BatchShard.of(mesh, x.shape[0] * mesh.size)
            share = x.shape[0] / shard.n_global
            sharded = data_parallel(module, shard.split() if sagittal_split else shard)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        if sagittal_split:
            x = split_and_flip_cl(x)
        with sharded:  # the backward too: a rematerialized block recomputes there
            y_pred = module(x.contiguous(), generator)
            if sagittal_split:
                y_pred = reverse_split_and_flip_cl(y_pred)
            y_pred = y_pred.float()
            if refine_image is not None:
                y_pred = apply_stochastic_matrix_cl(y_pred, batch[refine_image])
            loss_dict = criterion(y_pred, batch["y"])
            state.opt_state.zero_grad(set_to_none=True)
            if mesh is None:
                loss_dict["loss"].backward()
            else:
                (loss_dict["loss"] * share).backward()
        losses = {k: v.detach() for k, v in loss_dict.items()}
        if mesh is not None:
            all_reduce_gradients(state.params.values(), mesh)
            # every rank reports the global batch's losses
            summed = all_reduce_sum(torch.stack(list(losses.values())) * share, mesh)
            losses = dict(zip(losses, summed))
        state.opt_state.step()
        return state._replace(step=state.step + 1), losses, y_pred.detach()

    return train_step


def collate_to_device(batch_cf: Dict[str, Any], device=None, mesh=None,
                      data_axis: Optional[str] = "data",
                      spatial_axis: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Channel-first host batch -> channels-last device batch (the card
    unless ``device`` says otherwise; with a ``mesh``, this rank's rows of
    the batch on the mesh's device). float64 becomes float32; float32,
    bfloat16, float16 and integer arrays keep their dtype (uint8 label ids
    ship as they are); 5-D arrays (N, C, W, H, D) become (N, W, H, D, C),
    contiguous. To the card, each array is staged in pinned memory and
    copied without blocking the host, in order on the current stream: a
    batch uploaded while a train step runs does not wait for the step."""
    if spatial_axis is not None or (mesh is not None and data_axis != mesh.data_axis):
        raise NotImplementedError(f"sharding a batch over a spatial axis waits for the port of "
                                  f"{SPATIAL_ITEM}")
    device = resolve_device(device if mesh is None else mesh.device)
    out = {}
    for key, value in batch_cf.items():
        tensor = torch.as_tensor(value)
        if mesh is not None:
            tensor = tensor[mesh.rows(tensor.shape[0])]
        if tensor.dtype == torch.float64:
            tensor = tensor.float()
        if device.type == "cuda":
            tensor = tensor.pin_memory().to(device, non_blocking=True)
        else:
            tensor = tensor.to(device)
        if tensor.dim() == 5:
            tensor = to_channels_last(tensor).contiguous()
        out[key] = tensor
    return out
