from .base import (Compose, IntensityTransform, LabelTransform, OneOf, RandomTransform,
                   SpatialTransform, Transform, TransformRecord, apply_inverse_on_new_subject,
                   filter_records, filter_transform, get_rng, invert_records, seed_all)
from .dwi import ReconstructMeanDWI, ReconstructMeanDWIClassic
from .intensity import (RandomBiasField, RandomBlur, RandomGamma, RandomNoise, ReplaceNan,
                        RescaleIntensity, SetDataType, ZNormalization)
from .label import (CustomArgMax, CustomOneHot, CustomRemapLabels, CustomRemoveLabels,
                    CustomSequentialLabels, MergeLabels, get_mask_from_masking_method)
from .misc import FindInterestingSlice, ImageFromLabels
from .random_spatial import (Affine, ElasticDeformation, RandomAffine, RandomElasticDeformation,
                             RandomFlip, invert_displacement_field_voxels)
from .spatial import (CopyAffine, Crop, CropOrPad, CropToMask, EnforceConsistentAffine, Flip,
                      MinSizePad, Pad, Resample, TargetResample, resample_array)
from .structural import (ConcatenateImages, CopyProperty, PermuteDimensions,
                         RandomPermuteDimensions, RenameProperty, SplitImage)

__all__ = ["Compose", "IntensityTransform", "LabelTransform", "OneOf", "RandomTransform",
           "SpatialTransform", "Transform", "TransformRecord", "apply_inverse_on_new_subject",
           "filter_records", "filter_transform", "get_rng", "invert_records", "seed_all",
           "ReconstructMeanDWI", "ReconstructMeanDWIClassic",
           "RandomBiasField", "RandomBlur", "RandomGamma", "RandomNoise", "ReplaceNan",
           "RescaleIntensity", "SetDataType", "ZNormalization", "CustomArgMax", "CustomOneHot",
           "CustomRemapLabels", "CustomRemoveLabels", "CustomSequentialLabels", "MergeLabels",
           "get_mask_from_masking_method", "FindInterestingSlice",
           "ImageFromLabels", "Affine",
           "ElasticDeformation", "RandomAffine", "RandomElasticDeformation", "RandomFlip",
           "invert_displacement_field_voxels", "CopyAffine", "Crop", "CropOrPad", "CropToMask",
           "EnforceConsistentAffine", "Flip", "MinSizePad", "Pad", "Resample", "TargetResample",
           "resample_array", "ConcatenateImages", "CopyProperty", "PermuteDimensions",
           "RandomPermuteDimensions", "RenameProperty", "SplitImage"]
