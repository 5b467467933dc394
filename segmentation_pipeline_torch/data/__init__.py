from .loader import (DataLoaderFactory, LabelSampler, PatchDataLoader, PatchQueue, PatchSampler,
                     RandomSampler, SequentialSampler, StandardDataLoader, SubjectsLoader,
                     UniformSampler, WeightedSampler, extract_patch)

__all__ = ["DataLoaderFactory", "LabelSampler", "PatchDataLoader", "PatchQueue", "PatchSampler",
           "RandomSampler", "SequentialSampler", "StandardDataLoader", "SubjectsLoader",
           "UniformSampler", "WeightedSampler", "extract_patch"]
