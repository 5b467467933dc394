"""segmentation_pipeline_torch — the PyTorch/CUDA port of
segmentation_pipeline_tpu for NVIDIA Hopper GPUs.

The port grows slice by slice beside the JAX package, which stays the
reference. It covers whole-volume inference (the data model,
StandardPredict, SegModel, NestedResUNet) and the train step
(make_train_step, HybridLogisticDiceLoss, Adam and SGD). The 3x3x3 convs and
their input and weight gradients run on hand-written CUDA kernels
(csrc/conv3x3_s1p1.cu, csrc/conv3x3_s1p1_dw.cu). Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
from .core import Image, LabelMap, ScalarImage, Subject, collate_subjects, read_nifti, write_nifti
from .criterions import HybridLogisticDiceLoss
from .models import Block3d, NestedResUNet, flax_to_state_dict, state_dict_to_flax
from .prediction import Predictor, StandardPredict
from .training import SGD, Adam, SegModel, collate_to_device, create_train_state, make_train_step
from .transforms import EnforceConsistentAffine, Transform, TransformRecord

__version__ = "0.1.0"
