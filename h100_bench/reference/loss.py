"""The hybrid logistic-Dice loss (efirdc/Segmentation-Pipeline
``criterions/hybrid_logistic_dice_loss.py``) on (N, C, W, H, D) softmax
probabilities and one-hot targets: (1 - t) times the mean over samples and
classes of minus the spatial mean of target * log(p), plus t times the
mean of 1 - squared Dice, t = 0.5."""
from __future__ import annotations

import torch


def hybrid_logistic_dice(prediction: torch.Tensor, target: torch.Tensor,
                         dice_weight: float = 0.5, class_weights=None) -> torch.Tensor:
    spatial = (2, 3, 4)
    eps = 1e-8
    overlap = (prediction * target).sum(spatial)
    total = (target * target).sum(spatial) + (prediction * prediction).sum(spatial)
    logistic = (target * torch.log((prediction + eps) / (1 + eps))).mean(spatial)
    if class_weights is not None:
        logistic = logistic * torch.as_tensor(class_weights, dtype=logistic.dtype,
                                              device=logistic.device)[None]
    dice = 2 * overlap / (total + eps)
    return (1 - dice_weight) * (-logistic).mean() + dice_weight * (1 - dice).mean()
