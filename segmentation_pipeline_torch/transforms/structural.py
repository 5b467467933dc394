"""Structural transforms, ported from
segmentation_pipeline_tpu/transforms/structural.py: they rearrange the subject
dict (concatenate or split channels, copy or rename an entry) and are part of
the evaluation-space inverse set (``EVAL_LABEL_TYPES`` in prediction.py);
``PermuteDimensions`` and ``RandomPermuteDimensions`` permute the spatial
axes (msseg2's training augmentation).
"""
from __future__ import annotations

import copy
from typing import Sequence, Tuple

import numpy as np

from .base import RandomTransform, SpatialTransform, Transform


class ConcatenateImages(Transform):
    """Channel-concat named images into one (inverse: SplitImage)."""

    def __init__(self, image_names: Sequence[str], image_channels: Sequence[int],
                 new_image_name: str, **kwargs):
        super().__init__(**kwargs)
        if len(image_names) != len(image_channels):
            raise ValueError("The number of image names and number of channels must match.")
        self.image_names = list(image_names)
        self.image_channels = list(image_channels)
        self.new_image_name = new_image_name

    def apply_transform(self, subject):
        if any(name not in subject for name in self.image_names):
            return None
        images = [subject[name] for name in self.image_names]
        new_data = np.concatenate([np.asarray(img.data) for img in images], axis=0)
        new_image = copy.deepcopy(images[0])
        new_image.set_data(new_data)
        subject[self.new_image_name] = new_image
        return None

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        return SplitImage(image_name=self.new_image_name, new_image_names=self.image_names,
                          new_image_channels=self.image_channels)


class SplitImage(Transform):
    """Split an image's channels into separate named images (inverse:
    ConcatenateImages)."""

    def __init__(self, image_name: str, new_image_names: Sequence[str],
                 new_image_channels: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        if len(new_image_names) != len(new_image_channels):
            raise ValueError("The number of image names and number of channels must match.")
        self.image_name = image_name
        self.new_image_names = list(new_image_names)
        self.new_image_channels = list(new_image_channels)

    def apply_transform(self, subject):
        if self.image_name not in subject:
            return None
        target = subject[self.image_name]
        splits = np.split(np.asarray(target.data), np.cumsum(self.new_image_channels)[:-1], axis=0)
        for name, data in zip(self.new_image_names, splits):
            subject[name] = type(target)(tensor=data, affine=target.affine)
        return None

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        return ConcatenateImages(image_names=self.new_image_names,
                                 image_channels=self.new_image_channels,
                                 new_image_name=self.image_name)


class CopyProperty(Transform):
    def __init__(self, old_name, new_name, **kwargs):
        super().__init__(**kwargs)
        self.old_name = old_name
        self.new_name = new_name

    def apply_transform(self, subject):
        if self.old_name not in subject:
            return None
        subject[self.new_name] = copy.deepcopy(subject[self.old_name])
        return None

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        return CopyProperty(self.new_name, self.old_name)


class RenameProperty(Transform):
    def __init__(self, old_name, new_name, **kwargs):
        super().__init__(**kwargs)
        self.old_name = old_name
        self.new_name = new_name

    def apply_transform(self, subject):
        if self.old_name not in subject:
            return None
        subject[self.new_name] = subject[self.old_name]
        del subject[self.old_name]
        return None

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        return RenameProperty(self.new_name, self.old_name)


class PermuteDimensions(SpatialTransform):
    """Permute the three spatial dims of all selected images, and the
    affine's columns with them, so that world geometry stays the same;
    inverse: the argsort of the permutation."""

    def __init__(self, permutation: Tuple[int, int, int], **kwargs):
        super().__init__(**kwargs)
        self.permutation = tuple(permutation)

    def apply_transform(self, subject):
        perm = (0,) + tuple(p + 1 for p in self.permutation)
        for image in self.get_images(subject):
            image.set_data(np.transpose(np.asarray(image.data), perm))
            affine = image.affine.copy()
            affine[:3, :3] = affine[:3, list(self.permutation)]
            image.affine = affine
        return None

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        inverse_permutation = tuple(int(i) for i in np.argsort(self.permutation))
        return PermuteDimensions(permutation=inverse_permutation, **self._sel())


class RandomPermuteDimensions(RandomTransform, SpatialTransform):
    """A random order of the spatial dims; the concrete PermuteDimensions
    lands on the tape, so the inversion is exact."""

    def __call__(self, subject, record: bool = True):
        if isinstance(subject, (list, tuple)):
            return [self(s, record=record) for s in subject]
        if self.p < 1.0 and self.rng.random() > self.p:
            return subject
        perm = [0, 1, 2]
        self.rng.shuffle(perm)
        concrete = PermuteDimensions(tuple(perm), **self._sel())
        return concrete(subject, record=record)

    def apply_transform(self, subject):  # pragma: no cover
        raise RuntimeError("dispatches via __call__")
