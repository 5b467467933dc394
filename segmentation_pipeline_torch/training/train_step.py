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
one GSPMD takes in the JAX package. A wide mesh axis besides the data
axis holds replicas: they take the same rows and reduce over the data
axis only.

``make_spatial_train_step`` trains on volumes whose W axis is sharded over
a mesh axis (and N over the data axis where given): the module runs
inside ``spatially_sharded`` and ``data_parallel`` (halo-exchanging convs
on the hand kernels, BatchNorm statistics over every slab, a sample's
dropout masks alike on its slabs), the criterion completes its sums over
the ranks, and every rank of the step's axes holds the global loss.
"""
from __future__ import annotations

import contextlib
import copy
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..models.components import data_parallel, spatially_sharded
from ..parallel.mesh import BatchShard, all_reduce_gradients, all_reduce_sum
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
    if mesh is not None and data_axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {data_axis!r}")

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
            shard = BatchShard.of(mesh, x.shape[0] * mesh.shape[data_axis], data_axis)
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
            all_reduce_gradients(state.params.values(), mesh, (data_axis,))
            # every rank reports the global batch's losses
            summed = all_reduce_sum(torch.stack(list(losses.values())) * share, mesh,
                                    (data_axis,))
            losses = dict(zip(losses, summed))
        state.opt_state.step()
        return state._replace(step=state.step + 1), losses, y_pred.detach()

    return train_step


def collate_to_device(batch_cf: Dict[str, Any], device=None, mesh=None,
                      data_axis: Optional[str] = "data",
                      spatial_axis: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Channel-first host batch -> channels-last device batch (the card
    unless ``device`` says otherwise; with a ``mesh``, this rank's part of
    the batch on the mesh's device: its rows by its coordinate on
    ``data_axis`` (None: every row) and, with ``spatial_axis``, its slab of
    W by its coordinate there, the layout of ``make_spatial_train_step``).
    float64 becomes float32; float32, bfloat16, float16 and integer arrays
    keep their dtype (uint8 label ids ship as they are); 5-D arrays (N, C,
    W, H, D) become (N, W, H, D, C), contiguous. To the card, each array
    is staged in pinned memory and copied without blocking the host, in
    order on the current stream: a batch uploaded while a train step runs
    does not wait for the step."""
    if mesh is None and spatial_axis is not None:
        raise ValueError("collate_to_device(spatial_axis=...) needs a mesh")
    device = resolve_device(device if mesh is None else mesh.device)
    out = {}
    for key, value in batch_cf.items():
        tensor = torch.as_tensor(value)
        if mesh is not None:
            if data_axis is not None:
                tensor = tensor[mesh.rows(tensor.shape[0], data_axis)]
            if spatial_axis is not None:
                w_dim = 2 if tensor.dim() == 5 else 1  # (N, C, W, H, D) or (N, W, H, D)
                slab = mesh.w_slab(tensor.shape[w_dim], spatial_axis)
                tensor = tensor.narrow(w_dim, slab.start, slab.stop - slab.start)
        if tensor.dtype == torch.float64:
            tensor = tensor.float()
        if device.type == "cuda":
            tensor = tensor.contiguous().pin_memory().to(device, non_blocking=True)
        else:
            tensor = tensor.to(device)
        if tensor.dim() == 5:
            tensor = to_channels_last(tensor).contiguous()
        out[key] = tensor
    return out


def make_spatial_train_step(module: nn.Module, criterion, optimizer: OptimizerFactory, mesh,
                            spatial_axis: str = "spatial", data_axis: Optional[str] = None,
                            compute_dtype=None) -> Callable:
    """The train step on volumes whose W axis is sharded over the mesh's
    ``spatial_axis`` (and N over ``data_axis`` where given): the scaling
    path for volumes whose activations outgrow one device. Returns
    train_step(state, batch_cl, generator) -> (state, loss_dict, y_pred),
    as ``make_train_step``'s.

    batch_cl: this rank's part of the global batch, (n, w, H, D, C)
    (``collate_to_device(..., mesh=mesh, data_axis=data_axis,
    spatial_axis=spatial_axis)``); every rank gets the same ``generator``
    state. The module runs on its slabs (models/components.py::
    spatially_sharded: every conv halo-exchanges one row and runs on the
    hand kernels, the upsample reads global rows); BatchNorm normalizes
    with the statistics of every slab of the global batch, and a sample's
    channel dropout masks are the same on all its slabs: the rows of the
    global batch's masks, as the one-device step draws them. The criterion
    completes its per-sample sums over the spatial axis and its batch
    means over the data axis, so the returned losses are the global
    batch's on every rank; y_pred is this rank's slab.

    The gradient is the unsharded one. Each of the R ranks of the step's
    axes holds the loss, and the all-reduces and halo exchanges
    differentiate to the sums of the ranks' cotangents, so the ranks'
    backward passes of loss / R add up, in the all-reduce of the
    parameter gradients over those ranks, to the gradient of the loss.
    (The JAX package's shard_map transposes its psums so that no extra
    gradient sum is needed; here the backward of each all-reduce sums,
    and the 1 / R takes that back.) The slab width must divide by 2^3
    (NestedResUNet's pooling levels)."""
    axes = tuple(a for a in (data_axis, spatial_axis) if a is not None)
    for axis in axes:
        if axis not in mesh.shape:
            raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    crit = copy.copy(criterion)
    crit.spatial_axis_name, crit.batch_axis_name, crit.mesh = spatial_axis, data_axis, mesh
    compute_dtype = _normalize_compute_dtype(compute_dtype)
    share = 1.0 / math.prod(mesh.shape[a] for a in axes)
    levels = getattr(module, "pooling_levels", 3)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor], torch.Tensor]:
        if not optimizer.made(state.opt_state):
            raise TypeError(f"state.opt_state is a {type(state.opt_state).__name__}, not "
                            f"made by {optimizer!r}")
        x = batch["X"]
        if x.shape[1] % 2 ** levels:
            raise ValueError(
                f"Per-shard W slab of {x.shape[1]} voxels is not divisible by 2^{levels}: "
                f"shard-local pooling needs W divisible by mesh[{spatial_axis!r}] * "
                f"{2 ** levels} (= {mesh.shape[spatial_axis] * 2 ** levels})")
        module.train()
        n_global = x.shape[0] * (1 if data_axis is None else mesh.shape[data_axis])
        shard = BatchShard.of(mesh, n_global, data_axis, spatial_axis)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        # the backward inside too: it exchanges the halos' cotangents
        with data_parallel(module, shard), spatially_sharded(module, mesh, spatial_axis):
            y_pred = module(x.contiguous(), generator).float()
            loss_dict = crit(y_pred, batch["y"])
            state.opt_state.zero_grad(set_to_none=True)
            (loss_dict["loss"] * share).backward()
        all_reduce_gradients(state.params.values(), mesh, axes)
        state.opt_state.step()
        losses = {k: v.detach() for k, v in loss_dict.items()}
        return state._replace(step=state.step + 1), losses, y_pred.detach()

    return train_step
