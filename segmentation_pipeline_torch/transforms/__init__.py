from .base import (Compose, IntensityTransform, LabelTransform, OneOf, RandomTransform,
                   SpatialTransform, Transform, TransformRecord, apply_inverse_on_new_subject,
                   filter_records, filter_transform, get_rng, invert_records, seed_all)
from .intensity import ReplaceNan, RescaleIntensity, SetDataType
from .label import CustomArgMax, CustomOneHot, CustomRemapLabels, get_mask_from_masking_method
from .spatial import (Crop, CropOrPad, CropToMask, EnforceConsistentAffine, MinSizePad, Pad,
                      Resample, TargetResample, resample_array)
from .structural import ConcatenateImages, CopyProperty, RenameProperty, SplitImage

__all__ = ["Compose", "IntensityTransform", "LabelTransform", "OneOf", "RandomTransform",
           "SpatialTransform", "Transform", "TransformRecord", "apply_inverse_on_new_subject",
           "filter_records", "filter_transform", "get_rng", "invert_records", "seed_all",
           "ReplaceNan", "RescaleIntensity", "SetDataType", "CustomArgMax", "CustomOneHot",
           "CustomRemapLabels", "get_mask_from_masking_method", "Crop", "CropOrPad",
           "CropToMask", "EnforceConsistentAffine", "MinSizePad", "Pad", "Resample",
           "TargetResample", "resample_array", "ConcatenateImages", "CopyProperty",
           "RenameProperty", "SplitImage"]
