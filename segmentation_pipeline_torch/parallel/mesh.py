"""The data-parallel mesh over ``torch.distributed``.

Ported from segmentation_pipeline_tpu/parallel/mesh.py. The JAX package is
single-controller: one process drives every device of a ``jax.sharding.Mesh``
and GSPMD inserts the collectives. The port uses PyTorch's idiom: one process
per device, joined by ``torch.distributed``. A ``Mesh`` is the process
group's ranks, one device each (``cuda:LOCAL_RANK``, or the CPU under gloo).
Every rank runs the same host code from the same seed, so every rank sees
the same global batch and the same random draws, and takes its own rows of
the batch (``Mesh.rows``): rank r holds rows [r * n / R, (r + 1) * n / R).

A mesh of several axes lays its ranks out as ``jax.sharding.Mesh`` lays
out ``jax.devices()``: rank r sits at ``np.unravel_index(r, shape)``. Each
rank keeps its coordinate on every axis (``coords``) and, for every axis
wider than 1, a process group over the ranks that differ from it only on
that axis (``group``), made with ``dist.new_group`` in the same order on
every rank. The data axis shards the batch (``rows``); another axis
(``spatial``) shards the W axis of volumes (``w_slab``,
parallel/halo.py, parallel/sharded_model.py,
training/train_step.py::make_spatial_train_step). On the data-parallel
paths a wide axis besides the data axis holds replicas, as in the JAX
package, where GSPMD replicates over the axes a sharding does not name:
every replica takes the same rows and reduces over the data axis only.

The collectives live here: a sum all-reduce over some axes that autograd
differentiates (its gradient is the sum all-reduce of the cotangents), a
gradient all-reduce after ``backward()``, all-gathers along an axis, and a
vote that makes one decision for all ranks (``any_rank``). Without a
process group a mesh has one rank and they are the identity.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """The ranks of the default process group, one device each.

    ``axis_names`` and ``shape`` name the mesh as the JAX package's does;
    ``shape`` reads as ``jax.sharding.Mesh.shape``, a dict of axis sizes.
    ``rank`` and ``device`` are this process's, ``coords`` its coordinate on
    each axis. ``distributed`` is False for the one-rank mesh of a process
    without a process group: its collectives are the identity. A mesh with
    two or more axes wider than 1 makes its axis groups here, so every rank
    must build it at the same point of the same code."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], rank: int,
                 device: torch.device, distributed: bool):
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != len(tuple(shape)):
            raise ValueError(f"mesh axes {self.axis_names} and shape {tuple(shape)} differ "
                             "in length")
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.data_axis = "data" if "data" in self.axis_names else self.axis_names[0]
        self.size = math.prod(self.shape.values())
        self.rank = int(rank)
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} is not on a mesh of {self.size} ranks")
        self.device = torch.device(device)
        self.distributed = bool(distributed)
        if self.size > 1 and not self.distributed:
            raise ValueError(f"a mesh of {self.size} ranks needs a process group")
        sizes = tuple(self.shape.values())
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, sizes))))
        self._groups = {}
        wide = [a for a in self.axis_names if self.shape[a] > 1]
        for axis in wide:
            if self.shape[axis] == self.size:
                self._groups[axis] = dist.group.WORLD
                continue
            # one group per line of the mesh along ``axis``; every rank makes
            # them all, in the same order
            position = self.axis_names.index(axis)
            ranks = np.arange(self.size).reshape(sizes)
            lines = np.moveaxis(ranks, position, -1).reshape(-1, self.shape[axis])
            for line in lines.tolist():
                group = dist.new_group(line)
                if self.rank in line:
                    self._groups[axis] = group
        self._wide = tuple(wide)
        self._host_group = None

    @property
    def data_size(self) -> int:
        """The number of shards of the batch: the data axis's size."""
        return self.shape[self.data_axis]

    def group(self, axes: Optional[Sequence[str]] = None):
        """The process group over ``axes`` (default: every axis): None where
        they are all of size 1 (nothing to reduce), the default group where
        they hold every wide axis, else the group of the one wide axis among
        them."""
        axes = self.axis_names if axes is None else tuple(axes)
        for axis in axes:
            if axis not in self.shape:
                raise ValueError(f"mesh {self.shape} has no axis {axis!r}")
        wide = tuple(a for a in self._wide if a in axes)
        if not wide or not self.distributed:
            return None
        if wide == self._wide:
            return dist.group.WORLD
        if len(wide) == 1:
            return self._groups[wide[0]]
        raise NotImplementedError(f"a group over the axes {wide} of a mesh whose wide axes "
                                  f"are {self._wide}")

    def host_group(self):
        """The group for collectives of host values (CPU tensors): the
        default group where it is gloo, else a gloo group over the same
        ranks, made at the first call (every rank reaches it at the same
        point of the same code)."""
        if self._host_group is None:
            self._host_group = (dist.group.WORLD if "gloo" in dist.get_backend()
                                else dist.new_group(backend="gloo"))
        return self._host_group

    def rows(self, n: int, axis: Optional[str] = None) -> slice:
        """This rank's rows of a global batch of ``n``, sharded over ``axis``
        (default: the data axis)."""
        axis = self.data_axis if axis is None else axis
        ranks = self.shape[axis]
        if n % ranks:
            raise ValueError(f"a batch of {n} does not split over the {ranks} ranks of "
                             f"the mesh's {axis!r} axis; pad it (pad_batch_to_devices)")
        per = n // ranks
        return slice(self.coords[axis] * per, (self.coords[axis] + 1) * per)

    def w_slab(self, w: int, axis: str) -> slice:
        """This rank's slab of a W axis of ``w`` voxels sharded over
        ``axis``: rows [c * w / R, (c + 1) * w / R) at coordinate c of R."""
        ranks = self.shape[axis]
        if w % ranks:
            raise ValueError(f"W={w} must divide evenly over the {ranks} ranks of the mesh's "
                             f"{axis!r} axis")
        per = w // ranks
        return slice(self.coords[axis] * per, (self.coords[axis] + 1) * per)

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
    sums its statistics over the mesh ``axes`` that shard the batch's
    voxels, and channel dropout draws the masks of the global batch and
    keeps these rows (models/components.py). ``voxels`` is the global
    batch's voxel count over this rank's: the rows' share times the
    ranks of a spatial axis that shards W."""

    def __init__(self, mesh: Mesh, n_global: int, rows: torch.Tensor,
                 axes: Optional[Sequence[str]] = None, voxels: Optional[float] = None):
        self.mesh = mesh
        self.n_global = int(n_global)
        self.rows = rows
        self.axes = (mesh.data_axis,) if axes is None else tuple(axes)
        self.voxels = self.n_global / len(rows) if voxels is None else float(voxels)

    @classmethod
    def of(cls, mesh: Mesh, n_global: int, data_axis: Optional[str] = "",
           spatial_axis: Optional[str] = None) -> "BatchShard":
        """The rows of ``data_axis`` (default: the mesh's data axis; None:
        every row, the batch replicated), W sharded over ``spatial_axis``
        where given."""
        data_axis = mesh.data_axis if data_axis == "" else data_axis
        if data_axis is None:
            sl = slice(0, n_global)
        else:
            sl = mesh.rows(n_global, data_axis)
        axes = tuple(a for a in (data_axis, spatial_axis) if a is not None)
        voxels = n_global / (sl.stop - sl.start) * (
            1 if spatial_axis is None else mesh.shape[spatial_axis])
        return cls(mesh, n_global, torch.arange(sl.start, sl.stop, device=mesh.device),
                   axes, voxels)

    def split(self) -> "BatchShard":
        """The rows of the sagittal split of the batch (2 n_global rows:
        half 1 of subject i at row i, half 2 at n_global + i)."""
        return BatchShard(self.mesh, 2 * self.n_global,
                          torch.cat([self.rows, self.rows + self.n_global]), self.axes,
                          self.voxels)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh],
                   axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the mesh's ``axes`` (default:
    all), on each of them. Differentiable: the gradient is the sum of those
    ranks' cotangents, so that the ranks' gradients add up to the gradient
    of the sum of their losses."""
    group = None if mesh is None else mesh.group(axes)
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_gradients(parameters, mesh: Optional[Mesh],
                         axes: Optional[Sequence[str]] = None):
    """Sum the parameters' gradients over the ranks of the mesh's ``axes``
    (default: all), in place, through one flat buffer (parameters without a
    gradient are skipped; the ranks run the same graph, so they skip the
    same ones)."""
    group = None if mesh is None else mesh.group(axes)
    if group is None:
        return
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def gather_along(x: torch.Tensor, mesh: Optional[Mesh], axis: str) -> list:
    """The ``x`` of every rank on this rank's line along ``axis`` (each
    with the same shape), in coordinate order. Not differentiated."""
    group = None if mesh is None else mesh.group((axis,))
    if group is None:
        return [x]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=group)
    return parts


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh],
                    axis: Optional[str] = None) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` (default: the data axis; each with
    the same shape) concatenated along dim 0 in coordinate order, on every
    rank: the global batch of row-sharded results. Not differentiated."""
    if mesh is None:
        return x
    parts = gather_along(x, mesh, mesh.data_axis if axis is None else axis)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def gather_w(x: torch.Tensor, mesh: Optional[Mesh], axis: str, dim: int) -> torch.Tensor:
    """The whole of a tensor whose dimension ``dim`` (W) is sharded over
    ``axis`` in slabs (``Mesh.w_slab``), on every rank of the line. Not
    differentiated."""
    if mesh is None:
        return x
    parts = gather_along(x, mesh, axis)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


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
    0) by its coordinate on ``axis``, as the JAX package's ``P(axis)``
    places them: replicated over the mesh's other axes. Without a mesh the
    whole arrays go to the card. (The layout of a W-sharded batch, N over
    the data axis and W over a spatial one, is
    training/train_step.py::collate_to_device's.)"""
    if mesh is None:
        device = resolve_device(None)
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    return {k: torch.as_tensor(v)[mesh.rows(len(v), axis)].to(mesh.device)
            for k, v in batch.items()}


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
