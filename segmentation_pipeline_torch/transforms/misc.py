"""``ImageFromLabels``, ported from segmentation_pipeline_tpu/transforms/misc.py:
the weight image built from label masks that msseg2's WeightedSampler draws
patch centres from (``patch_probability``).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

from ..core.subject import ScalarImage
from .base import Transform

TypeLabelWeights = Tuple[str, Union[int, str], float]


class ImageFromLabels(Transform):
    """Synthesize a weight image from label masks: the patch-sampling
    probability map (ref image_from_labels.py:11). Each mask overwrites the
    voxels it covers with its weight, later masks over earlier ones."""

    def __init__(self, new_image_name: str, label_weights: Sequence[TypeLabelWeights],
                 **kwargs):
        super().__init__(**kwargs)
        self.new_image_name = new_image_name
        self.label_weights = list(label_weights)

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
            output[label_data[0:1] == label_identifier] = weight

        affine = subject.get_first_image().affine
        subject[self.new_image_name] = ScalarImage(tensor=output, affine=affine)
        return None
