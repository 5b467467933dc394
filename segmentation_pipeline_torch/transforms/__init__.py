from .base import (Compose, IntensityTransform, LabelTransform, OneOf, RandomTransform,
                   SpatialTransform, Transform, TransformRecord, apply_inverse_on_new_subject,
                   filter_records, filter_transform, get_rng, invert_records, seed_all)
from .intensity import ReplaceNan, RescaleIntensity
from .label import CustomArgMax, CustomOneHot, CustomRemapLabels, get_mask_from_masking_method
from .spatial import Crop, CropOrPad, EnforceConsistentAffine, Pad
from .structural import ConcatenateImages, CopyProperty, RenameProperty, SplitImage

__all__ = ["Compose", "IntensityTransform", "LabelTransform", "OneOf", "RandomTransform",
           "SpatialTransform", "Transform", "TransformRecord", "apply_inverse_on_new_subject",
           "filter_records", "filter_transform", "get_rng", "invert_records", "seed_all",
           "ReplaceNan", "RescaleIntensity", "CustomArgMax", "CustomOneHot",
           "CustomRemapLabels", "get_mask_from_masking_method", "Crop", "CropOrPad",
           "EnforceConsistentAffine", "Pad", "ConcatenateImages", "CopyProperty",
           "RenameProperty", "SplitImage"]
