"""Spatial transforms, ported from segmentation_pipeline_tpu/transforms/spatial.py
(so far only ``EnforceConsistentAffine``, which prediction applies)."""
from __future__ import annotations

from .base import Transform


class EnforceConsistentAffine(Transform):
    """Copy a source image's affine to all images."""

    def __init__(self, source_image_name: str = None, **kwargs):
        super().__init__(**kwargs)
        self.source_image_name = source_image_name

    def apply_transform(self, subject):
        if self.source_image_name is not None and self.source_image_name not in subject:
            return None
        if self.source_image_name is not None:
            source = subject[self.source_image_name]
        else:
            source = subject.get_first_image()
        for name, image in self.get_images_dict(subject).items():
            if name == self.source_image_name:
                continue
            image.affine = source.affine.copy()
        return None
