"""Hybrid soft-Dice + logistic loss, channels-last.

Ported from segmentation_pipeline_tpu/criterions/hybrid_logistic_dice_loss.py:
squared-denominator soft Dice per (subject, class), eps-shifted log loss with
optional per-class weights, convex mix by ``dice_weight``. Inputs are
(N, W, H, D, C); the spatial reductions run over axes (1, 2, 3).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


class HybridLogisticDiceLoss:
    def __init__(self, dice_weight: float = 0.5,
                 logistic_class_weights: Optional[Sequence[float]] = None,
                 square_dice: bool = True):
        self.dice_weight = dice_weight
        self.logistic_class_weights = (
            None if logistic_class_weights is None
            else torch.as_tensor(logistic_class_weights, dtype=torch.float32))
        self.square_dice = square_dice

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

        dice_coeffs = 2 * overlap / (total + eps)
        if self.logistic_class_weights is not None:
            logistic = logistic * self.logistic_class_weights.to(logistic.device)[None]

        logistic_loss = torch.mean(-logistic)
        dice_loss = torch.mean(1 - dice_coeffs)

        t = self.dice_weight
        hybrid_loss = (1.0 - t) * logistic_loss + t * dice_loss
        return {
            "loss": hybrid_loss,
            "dice_loss": dice_loss,
            "logistic_loss": logistic_loss,
        }
