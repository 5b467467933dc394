"""Hybrid soft-Dice + logistic loss, channels-last.

Ported from segmentation_pipeline_tpu/criterions/hybrid_logistic_dice_loss.py:
squared-denominator soft Dice per (subject, class), eps-shifted log loss with
optional per-class weights, convex mix by ``dice_weight``. Inputs are
(N, W, H, D, C); the spatial reductions run over axes (1, 2, 3).

On a mesh (``mesh``, parallel/mesh.py) with ``spatial_axis_name`` the
inputs are this rank's W slabs of its samples: the per-sample sums are
summed over that axis's ranks and the per-sample logistic mean is their
mean (the slabs are equal); with ``batch_axis_name`` the batch means are
averaged over that axis's ranks. The all-reduces are differentiable
(their gradient sums the ranks' cotangents), and every rank of those axes
holds the same loss. Without the names, the one-device math.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


class HybridLogisticDiceLoss:
    def __init__(self, dice_weight: float = 0.5,
                 logistic_class_weights: Optional[Sequence[float]] = None,
                 square_dice: bool = True,
                 spatial_axis_name: Optional[str] = None,
                 batch_axis_name: Optional[str] = None, mesh=None):
        self.dice_weight = dice_weight
        self.logistic_class_weights = (
            None if logistic_class_weights is None
            else torch.as_tensor(logistic_class_weights, dtype=torch.float32))
        self.square_dice = square_dice
        self.spatial_axis_name = spatial_axis_name
        self.batch_axis_name = batch_axis_name
        self.mesh = mesh

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("mesh", None)  # the process group is this process's
        return state

    def __setstate__(self, state):
        # attributes newer than a pickled checkpoint
        state.setdefault("spatial_axis_name", None)
        state.setdefault("batch_axis_name", None)
        state.setdefault("mesh", None)
        self.__dict__.update(state)

    def _reduced(self, x: torch.Tensor, axis: Optional[str], mean: bool) -> torch.Tensor:
        """``x`` summed (or averaged) over the ranks of the mesh's ``axis``."""
        if axis is None:
            return x
        if self.mesh is None:
            raise ValueError(f"HybridLogisticDiceLoss over mesh axis {axis!r} needs a mesh")
        from ..parallel.mesh import all_reduce_sum

        out = all_reduce_sum(x, self.mesh, (axis,))
        return out / self.mesh.shape[axis] if mean else out

    def __call__(self, prediction: torch.Tensor, target: torch.Tensor) -> Dict[str, torch.Tensor]:
        """prediction/target: (N, W, H, D, C) softmax probabilities against
        one-hot labels."""
        spatial = (1, 2, 3)
        eps = 1e-8

        overlap = torch.sum(prediction * target, dim=spatial)
        if self.square_dice:
            total = (torch.sum(target * target, dim=spatial)
                     + torch.sum(prediction * prediction, dim=spatial))
        else:
            total = torch.sum(target, dim=spatial) + torch.sum(prediction, dim=spatial)

        prediction_safe = (prediction + eps) / (1 + eps)
        logistic = torch.mean(target * torch.log(prediction_safe), dim=spatial)

        if self.spatial_axis_name is not None:
            overlap, total, logistic = self._reduced(
                torch.stack([overlap, total, logistic]), self.spatial_axis_name, False)
            logistic = logistic / self.mesh.shape[self.spatial_axis_name]

        dice_coeffs = 2 * overlap / (total + eps)
        if self.logistic_class_weights is not None:
            logistic = logistic * self.logistic_class_weights.to(logistic.device)[None]

        logistic_loss = torch.mean(-logistic)
        dice_loss = torch.mean(1 - dice_coeffs)
        if self.batch_axis_name is not None:
            logistic_loss, dice_loss = self._reduced(
                torch.stack([logistic_loss, dice_loss]), self.batch_axis_name, True)

        t = self.dice_weight
        hybrid_loss = (1.0 - t) * logistic_loss + t * dice_loss
        return {
            "loss": hybrid_loss,
            "dice_loss": dice_loss,
            "logistic_loss": logistic_loss,
        }
