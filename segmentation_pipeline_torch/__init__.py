"""segmentation_pipeline_torch — the PyTorch/CUDA port of
segmentation_pipeline_tpu for NVIDIA Hopper GPUs.

The port grows slice by slice beside the JAX package, which stays the
reference. It covers whole-volume inference (the data model,
StandardPredict, SegModel, NestedResUNet), the dmri_hippo serving path
around it (the deterministic transforms and the inversion of their tape,
fold and flip/orientation ensembles, bit-packed label fetch, host
post-processing), msseg2 serving (the geometry transforms, sliding-window
PatchPredict, ModularUNet with blurred strided and transposed convs),
msseg2's training data path (the random transforms, the patch queue and
its samplers), the train step (make_train_step, HybridLogisticDiceLoss,
Adam and SGD; ModularUNet's rematerialized blocks) and the training loop
around it: SubjectFolder with its loaders and cohort filters, the Context
and its checkpoints, SegmentationTrainer with scheduled evaluators, and
FileLogger; and the trainer's device levers (the device cache, device patch
sampling and the batched device augmentation derived from the declared
pipeline: ``tpu_fast_path=True``); the dmri_hippo cascade (StochasticMatrix,
refined predictions); the native connected-component labeller (native.py)
and the device morphology, instance and confusion reductions (fused
cleanup in PatchPredict, the trainer's device-reduced sweeps). The
configurations of dmri_hippo and msseg2 live in
``segmentation_pipeline_torch.research``. The 3x3x3 convs and their input
and weight gradients run on hand-written CUDA kernels
(csrc/conv3x3_s1p1.cu, csrc/conv3x3_s1p1_dw.cu). Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
from .core import Image, LabelMap, ScalarImage, Subject, collate_subjects, read_nifti, write_nifti
from .criterions import HybridLogisticDiceLoss
from .data.device_cache import DeviceDataCache
from .data import (AnyFilter, AttributeLoader, ComposeFilters, ComposeLoaders, ForbidAttributes,
                   ImageLoader, LabelSampler, NegateFilter, PatchDataLoader, PatchQueue,
                   RandomFoldFilter, RandomSampler, RandomSelectFilter, RequireAttributes,
                   SequentialSampler, StandardDataLoader, StratifiedFilter, SubjectFolder,
                   TensorLoader, UniformSampler, WeightedSampler)
from .evaluators import (ContourImageEvaluator, ImageRegionEvaluator,
                         InstanceSegmentationEvaluator, LabeledTensor, LabelMapEvaluator,
                         SegmentationEvaluator)
from .loggers import FileLogger, NonLogger
from .models import (BlurConv3d, BlurConvTranspose3d, Block3d, ModularUNet, NestedResUNet,
                     StochasticMatrix, WSConv3d, flax_to_state_dict, state_dict_to_flax)
from .models.ensemble import EnsembleFlips, EnsembleModels, EnsembleOrientations
from .post_processing import (keep_components, remove_holes, remove_small_components,
                              sort_by_size, unsort_by_size)
from .prediction import PatchPredict, Predictor, StandardPredict, add_evaluation_labels
from .training import (SGD, Adam, MultiSteps, SegModel, collate_to_device, create_train_state,
                       make_train_step)
from .training.context import Context, Ref, list_checkpoint_files
from .training.trainer import ScheduledEvaluation, SegmentationTrainer
from .transforms import *  # noqa: F401,F403
from . import post_processing

__version__ = "0.1.0"
