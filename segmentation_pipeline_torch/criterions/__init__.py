from .hybrid_logistic_dice_loss import HybridLogisticDiceLoss

__all__ = ["HybridLogisticDiceLoss"]
