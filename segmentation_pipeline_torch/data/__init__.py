from .dataset_fingerprint import get_dataset_fingerprint
from .loader import (DataLoaderFactory, LabelSampler, PatchDataLoader, PatchQueue, PatchSampler,
                     RandomSampler, SequentialSampler, StandardDataLoader, SubjectsLoader,
                     UniformSampler, WeightedSampler, extract_patch)
from .subject_filters import (AnyFilter, ComposeFilters, ForbidAttributes, NegateFilter,
                              RandomFoldFilter, RandomSelectFilter, RequireAttributes,
                              StratifiedFilter, SubjectFilter)
from .subject_folder import SubjectFolder
from .subject_loaders import (AttributeLoader, ComposeLoaders, ImageLoader, SubjectLoader,
                              TensorLoader)

__all__ = ["DataLoaderFactory", "LabelSampler", "PatchDataLoader", "PatchQueue", "PatchSampler",
           "RandomSampler", "SequentialSampler", "StandardDataLoader", "SubjectsLoader",
           "UniformSampler", "WeightedSampler", "extract_patch", "AnyFilter", "ComposeFilters",
           "ForbidAttributes", "NegateFilter", "RandomFoldFilter", "RandomSelectFilter",
           "RequireAttributes", "StratifiedFilter", "SubjectFilter", "SubjectFolder",
           "AttributeLoader", "ComposeLoaders", "ImageLoader", "SubjectLoader", "TensorLoader",
           "get_dataset_fingerprint"]
