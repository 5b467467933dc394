from .components import (BatchNorm, Block3d, Conv3d, Softmax, channel_dropout,
                         torch_conv_kernel_init)
from .convert import flax_to_state_dict, state_dict_to_flax
from .nested_unet import NestedResUNet

__all__ = ["BatchNorm", "Block3d", "Conv3d", "Softmax", "channel_dropout",
           "torch_conv_kernel_init", "flax_to_state_dict", "state_dict_to_flax",
           "NestedResUNet"]
