from .components import Block3d, Conv3d, Softmax, torch_conv_kernel_init
from .convert import flax_to_state_dict, state_dict_to_flax
from .nested_unet import NestedResUNet

__all__ = ["Block3d", "Conv3d", "Softmax", "torch_conv_kernel_init",
           "flax_to_state_dict", "state_dict_to_flax", "NestedResUNet"]
