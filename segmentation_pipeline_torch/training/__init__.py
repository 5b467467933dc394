from .model import SegModel, to_channels_first, to_channels_last
from .optimizers import SGD, Adam, MultiSteps, OptimizerFactory
from .train_step import TrainState, collate_to_device, create_train_state, make_train_step

__all__ = ["SegModel", "to_channels_first", "to_channels_last", "Adam", "SGD",
           "MultiSteps", "OptimizerFactory", "TrainState", "collate_to_device", "create_train_state",
           "make_train_step"]
