"""Ported from segmentation_pipeline_tpu/transforms/misc.py:
``ImageFromLabels``, the weight image built from label masks that msseg2's
WeightedSampler draws patch centres from (``patch_probability``), and
``FindInterestingSlice``, which ContourImageEvaluator ranks slices with.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

from ..core.subject import LabelMap, ScalarImage
from .base import Transform

TypeLabelWeights = Tuple[str, Union[int, str], float]


class ImageFromLabels(Transform):
    """Synthesize a weight image from label masks: the patch-sampling
    probability map (ref image_from_labels.py:11). With ``mode="overwrite"``
    each mask overwrites the voxels it covers with its weight, later masks
    over earlier ones; with ``mode="additive"`` the weights of the masks
    that cover a voxel add up."""

    def __init__(self, new_image_name: str, label_weights: Sequence[TypeLabelWeights],
                 mode: str = "overwrite", **kwargs):
        super().__init__(**kwargs)
        self.new_image_name = new_image_name
        self.label_weights = list(label_weights)
        self.mode = mode

    def apply_transform(self, subject):
        subject.check_consistent_spatial_shape()
        spatial = subject.spatial_shape
        output = np.zeros((1, *spatial), dtype=np.float32)

        for label_map_name, label_identifier, weight in self.label_weights:
            if label_map_name not in subject:
                continue
            label_map = subject[label_map_name]
            if isinstance(label_identifier, str):
                if "label_values" not in label_map:
                    raise RuntimeError(
                        "LabelMap must have a 'label_values' dict to select a label by name")
                label_identifier = label_map["label_values"][label_identifier]

            label_data = np.asarray(label_map.data)
            if label_map.get("one_hot", False):
                label_data = np.argmax(label_data, axis=0, keepdims=True)
            label_mask = label_data[0:1] == label_identifier
            if self.mode == "additive":
                output += label_mask.astype(np.float32) * weight
            if self.mode == "overwrite":
                output[label_mask] = weight

        affine = subject.get_first_image().affine
        subject[self.new_image_name] = ScalarImage(tensor=output, affine=affine)
        return None


class FindInterestingSlice(Transform):
    """Rank slices per plane by label mass; attaches
    'interesting_slice_ids'/'interesting_slice_counts' dicts keyed by plane."""

    PLANES = ("Saggital", "Coronal", "Axial")

    def apply_transform(self, subject):
        for image in self.get_images(subject):
            if not isinstance(image, LabelMap):
                continue
            data = np.asarray(image.data)
            if image.get("one_hot", False):
                mask = np.argmax(data, axis=0) != 0
            else:
                mask = data[0] != 0

            ids_out, counts_out = {}, {}
            for plane, where in zip(self.PLANES, np.where(mask)):
                slice_ids, counts = np.unique(where, return_counts=True)
                order = np.argsort(-counts, kind="stable")
                ids_out[plane] = slice_ids[order]
                counts_out[plane] = counts[order]
            image["interesting_slice_ids"] = ids_out
            image["interesting_slice_counts"] = counts_out
        return None

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        return _Identity()


class _Identity(Transform):
    def apply_transform(self, subject):
        return None
