from .components import (AvgPoolDown, BatchNorm, BlurConv3d, BlurConvTranspose3d, Block3d,
                         Conv3d, Softmax, StochasticMatrix, TrilinearUp, WSConv3d, channel_dropout,
                         torch_conv_kernel_init)
from .convert import flax_to_state_dict, state_dict_to_flax
from .modular_unet import ModularUNet
from .nested_unet import NestedResUNet

__all__ = ["AvgPoolDown", "BatchNorm", "BlurConv3d", "BlurConvTranspose3d", "Block3d", "Conv3d",
           "Softmax", "StochasticMatrix", "TrilinearUp", "WSConv3d", "channel_dropout",
           "torch_conv_kernel_init",
           "flax_to_state_dict", "state_dict_to_flax", "ModularUNet", "NestedResUNet"]
