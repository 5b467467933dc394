"""segmentation_pipeline_torch — the PyTorch/CUDA port of
segmentation_pipeline_tpu for NVIDIA Hopper GPUs.

The port grows slice by slice beside the JAX package, which stays the
reference. This slice covers whole-volume inference: the data model,
StandardPredict, SegModel and NestedResUNet, whose 3x3x3 convs run on a
hand-written CUDA kernel (csrc/conv3x3_s1p1.cu). Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
from .core import Image, LabelMap, ScalarImage, Subject, collate_subjects, read_nifti, write_nifti
from .models import Block3d, NestedResUNet, flax_to_state_dict, state_dict_to_flax
from .prediction import Predictor, StandardPredict
from .training import SegModel
from .transforms import EnforceConsistentAffine, Transform, TransformRecord

__version__ = "0.1.0"
