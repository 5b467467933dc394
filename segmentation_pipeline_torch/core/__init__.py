from .nifti import read_nifti, write_nifti
from .subject import Image, LabelMap, ScalarImage, Subject, collate_subjects, slice_volume

__all__ = [
    "read_nifti", "write_nifti",
    "Image", "LabelMap", "ScalarImage", "Subject", "collate_subjects", "slice_volume",
]
