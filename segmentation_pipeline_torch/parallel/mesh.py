"""The data-parallel mesh over ``torch.distributed``.

Ported from segmentation_pipeline_tpu/parallel/mesh.py. The JAX package is
single-controller: one process drives every device of a ``jax.sharding.Mesh``
and GSPMD inserts the collectives. The port uses PyTorch's idiom: one process
per device, joined by ``torch.distributed``. A ``Mesh`` is the process
group's ranks, one device each (``cuda:LOCAL_RANK``, or the CPU under gloo).
Every rank runs the same host code from the same seed, so every rank sees
the same global batch and the same random draws, and takes its own rows of
the batch (``Mesh.rows``): rank r holds rows [r * n / R, (r + 1) * n / R).

The collectives the data-parallel paths need live here: a sum all-reduce
that autograd differentiates (its gradient is the sum all-reduce of the
cotangents), a gradient all-reduce after ``backward()``, an all-gather of
rows, and a vote that makes one decision for all ranks (``any_rank``). Without a process group a mesh has one rank and they are the
identity.

Only the data axis shards: a mesh whose other axes are larger than 1 (the
JAX package's spatial sharding) waits for ROADMAP Queue 1 item 10b.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

SPATIAL_ITEM = "ROADMAP Queue 1 item 10b (multi-device, spatial sharding)"


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """The ranks of the default process group, one device each.

    ``axis_names`` and ``shape`` name the mesh as the JAX package's does;
    ``shape`` reads as ``jax.sharding.Mesh.shape``, a dict of axis sizes.
    ``rank`` and ``device`` are this process's. ``distributed`` is False for
    the one-rank mesh of a process without a process group: its collectives
    are the identity."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], rank: int,
                 device: torch.device, distributed: bool):
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != len(tuple(shape)):
            raise ValueError(f"mesh axes {self.axis_names} and shape {tuple(shape)} differ "
                             "in length")
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.data_axis = "data" if "data" in self.axis_names else self.axis_names[0]
        wide = {a: s for a, s in self.shape.items() if a != self.data_axis and s > 1}
        if wide:
            raise NotImplementedError(
                f"mesh axes {wide} besides the data axis shard volumes, which waits for the "
                f"port of {SPATIAL_ITEM}")
        self.size = math.prod(self.shape.values())
        self.rank = int(rank)
        self.device = torch.device(device)
        self.distributed = bool(distributed)
        self._host_group = None

    def host_group(self):
        """The group for collectives of host values (CPU tensors): the
        default group where it is gloo, else a gloo group over the same
        ranks, made at the first call (every rank reaches it at the same
        point of the same code)."""
        if self._host_group is None:
            self._host_group = (dist.group.WORLD if "gloo" in dist.get_backend()
                                else dist.new_group(backend="gloo"))
        return self._host_group

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over the {self.size} ranks of "
                             "the mesh; pad it (pad_batch_to_devices)")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"distributed={self.distributed})")


class MeshRecipe:
    """Picklable stand-in for a mesh: checkpoints and pickled predictors
    store the (axis_names, shape) recipe and rebuild the mesh over this
    process's process group on restore."""

    def __init__(self, axis_names, shape):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape)

    @classmethod
    def of(cls, mesh: Mesh) -> "MeshRecipe":
        return cls(mesh.axis_names, tuple(mesh.shape.values()))

    def build(self, device=None) -> Mesh:
        n = int(np.prod(self.shape))
        world = dist.get_world_size() if _joined() else 1
        if world < n:
            raise RuntimeError(
                f"Checkpoint mesh {dict(zip(self.axis_names, self.shape))} "
                f"needs {n} devices but only {world} are available")
        return make_mesh(n, self.axis_names, self.shape, device=device)


def _default_device(rank: int) -> torch.device:
    """``cuda:LOCAL_RANK`` (the rank modulo the cards when the launcher set
    none); without a card ``resolve_device`` raises."""
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(None)


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """The mesh over the initialized process group (default: a 1-D 'data'
    mesh over all its ranks); without a process group a one-rank mesh on
    ``device``. ``device`` defaults to this rank's card. ``n_devices``, where
    given, must be the group's size: a port mesh spans its process group."""
    joined = _joined()
    world = dist.get_world_size() if joined else 1
    n = world if n_devices is None else int(n_devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} devices")
    if n > world:
        raise RuntimeError(f"a mesh of {n} devices needs a process group of {n} ranks; this "
                           f"process has {world} (launch one process per device: "
                           "segmentation_pipeline_torch.research.scripts.launch_multihost)")
    if n < world:
        raise ValueError(f"a mesh spans its whole process group: asked for {n} devices in a "
                         f"group of {world} ranks")
    rank = dist.get_rank() if joined else 0
    device = _default_device(rank) if device is None else resolve_device(device)
    return Mesh(axis_names, shape, rank, device, joined)


class BatchShard:
    """This rank's rows of a global batch: ``rows`` holds their global
    indices (on the mesh's device) among ``n_global``. Train-mode BatchNorm
    sums its statistics over the mesh, and channel dropout draws the masks
    of the global batch and keeps these rows (models/components.py)."""

    def __init__(self, mesh: Mesh, n_global: int, rows: torch.Tensor):
        self.mesh = mesh
        self.n_global = int(n_global)
        self.rows = rows

    @classmethod
    def of(cls, mesh: Mesh, n_global: int) -> "BatchShard":
        sl = mesh.rows(n_global)
        return cls(mesh, n_global, torch.arange(sl.start, sl.stop, device=mesh.device))

    def split(self) -> "BatchShard":
        """The rows of the sagittal split of the batch (2 n_global rows:
        half 1 of subject i at row i, half 2 at n_global + i)."""
        return BatchShard(self.mesh, 2 * self.n_global,
                          torch.cat([self.rows, self.rows + self.n_global]))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, on every rank. Differentiable:
    the gradient is the sum of the ranks' cotangents, so that the ranks'
    gradients add up to the gradient of the sum of their losses."""
    if mesh is None or not mesh.distributed:
        return x
    return _AllReduceSum.apply(x)


def all_reduce_gradients(parameters, mesh: Optional[Mesh]):
    """Sum the parameters' gradients over the mesh, in place, through one
    flat buffer (parameters without a gradient are skipped; the ranks run
    the same graph, so they skip the same ones)."""
    if mesh is None or not mesh.distributed:
        return
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``x`` (each with the same shape) concatenated along dim
    0 in rank order, on every rank: the global batch of row-sharded
    results. Not differentiated."""
    if mesh is None or not mesh.distributed:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
    """Whether ``flag`` holds on any rank of the mesh, on every rank: one
    decision for the whole mesh where each rank reads its own clock or
    signals (a rank that acted alone would leave the others waiting in
    their next collective)."""
    if mesh is None or not mesh.distributed:
        return bool(flag)
    # on the host: a vote on the device would wait for the queued steps
    votes = torch.tensor([int(bool(flag))])
    dist.all_reduce(votes, op=dist.ReduceOp.MAX, group=mesh.host_group())
    return bool(votes.item())


def shard_batch(batch: dict, mesh: Optional[Mesh], axis: str = "data") -> dict:
    """A dict of host arrays to this rank's device, its rows of each (dim
    0). Without a mesh the whole arrays go to the card. ``axis`` keeps the
    JAX package's signature: a port mesh shards its data axis only."""
    if mesh is None:
        device = resolve_device(None)
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    if axis != mesh.data_axis:
        raise NotImplementedError(f"sharding the batch over mesh axis {axis!r} waits for the "
                                  f"port of {SPATIAL_ITEM}")
    return {k: torch.as_tensor(v)[mesh.rows(len(v))].to(mesh.device) for k, v in batch.items()}


def pad_batch_to_devices(batch: dict, n_devices: int):
    """Pad the batch dim up to a multiple of the mesh size (every rank
    takes the same number of rows); returns (padded_batch, real_batch_size)."""
    sizes = {v.shape[0] for v in batch.values()}
    assert len(sizes) == 1, f"Inconsistent batch sizes {sizes}"
    n = sizes.pop()
    rem = (-n) % n_devices
    if rem == 0:
        return batch, n
    out = {}
    for k, v in batch.items():
        pad_width = [(0, rem)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(np.asarray(v), pad_width)
    return out, n
