from .model import SegModel, to_channels_first, to_channels_last
from .optimizers import SGD, Adam, MultiSteps, OptimizerFactory
from .train_step import (TrainState, collate_to_device, create_train_state,
                         make_spatial_train_step, make_train_step)
from .context import Context, Ref, TorchContext, list_checkpoint_files

__all__ = ["SegModel", "to_channels_first", "to_channels_last", "Adam", "SGD",
           "MultiSteps", "OptimizerFactory", "TrainState", "collate_to_device", "create_train_state",
           "make_spatial_train_step", "make_train_step", "Context", "Ref", "TorchContext",
           "list_checkpoint_files"]
