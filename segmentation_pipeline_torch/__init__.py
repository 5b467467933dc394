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
cleanup in PatchPredict, the trainer's device-reduced sweeps); affine TTA
(EnsembleAffines), the loaders' process workers, the dataset fingerprint,
the native NIfTI reader, and the tensorboard, image and wandb loggers;
meshes over torch.distributed (parallel/: make_mesh, MeshRecipe, the mesh
train step and trainer, the sharded TTA ensembles and sliding window) and
spatial sharding over them (halo exchange, the W-sharded NestedResUNet
forward, make_spatial_train_step and the trainer's spatial_axis, the
W-sharded sliding window behind PatchPredict(volume_sharded=True)). The
configurations of dmri_hippo and msseg2 live in
``segmentation_pipeline_torch.research``. The 3x3x3 convs and their input
and weight gradients run on hand-written CUDA kernels
(csrc/conv3x3_s1p1.cu, csrc/conv3x3_s1p1_dw.cu). Swin UNETR (SwinUNETR:
shifted-window attention, InstanceNorm residual decoder; MONAI's model,
which the JAX package does not have) serves through SegModel and
PatchPredict and trains through make_train_step like the other models.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from .core import (Image, LabelMap, ScalarImage, Subject, collate_subjects, read_nifti,
                   slice_volume, write_nifti)
from .criterions import HybridLogisticDiceLoss
from .data.device_cache import DeviceDataCache
from .data import (AnyFilter, AttributeLoader, ComposeFilters, ComposeLoaders, DataLoaderFactory,
                   ForbidAttributes, ImageLoader, LabelSampler, NegateFilter, PatchDataLoader,
                   PatchQueue, RandomFoldFilter, RandomSampler, RandomSelectFilter,
                   RequireAttributes, SequentialSampler, StandardDataLoader, StratifiedFilter,
                   SubjectFilter, SubjectFolder, SubjectLoader, SubjectsLoader, TensorLoader,
                   UniformSampler, WeightedSampler, get_dataset_fingerprint)
from .evaluators import (ContourImageEvaluator, Evaluator, ImageRegionEvaluator,
                         InstanceSegmentationEvaluator, LabeledTensor, LabelMapEvaluator,
                         SegmentationEvaluator, msseg_detection_test)
from .loggers import FileLogger, Logger, NonLogger, WandbLogger
from .models import (BlurConv3d, BlurConvTranspose3d, Block3d, ModularUNet, NestedResUNet,
                     StochasticMatrix, SwinUNETR, WSConv3d, flax_to_state_dict,
                     state_dict_to_flax)
from .models.ensemble import (EnsembleAffines, EnsembleFlips, EnsembleModels,
                              EnsembleOrientations)
from .parallel.mesh import MeshRecipe, make_mesh
from .post_processing import (keep_components, remove_holes, remove_small_components,
                              sort_by_size, unsort_by_size)
from .prediction import (PatchPredict, Predictor, StandardPredict, add_evaluation_labels,
                         apply_stochastic_matrix)
from .training import (SGD, Adam, Context, MultiSteps, Ref, SegModel, TorchContext, TrainState,
                       collate_to_device, create_train_state, list_checkpoint_files,
                       make_spatial_train_step, make_train_step)
from .training.trainer import ScheduledEvaluation, SegmentationTrainer
from .transforms import *  # noqa: F401,F403
from .typing import PathLike
from .utils.compact_json import CompactJSONEncoder
from .utils.dataset_files import prepare_dataset_files
from .utils.misc import (auto_str, filter_kwargs, flatten_nested_dict, no_op, random_folds,
                         time_str_to_seconds)
from .utils.nn_unet_convert import save_dataset_as_nn_unet
from .utils.timer import Timer
from .visualizations import vis_features, vis_model, vis_subject
from . import native, ops, parallel, post_processing  # noqa: F401

__version__ = "0.1.0"
