"""Label-map transforms, ported from segmentation_pipeline_tpu/transforms/label.py:
masked remapping that keeps the ``label_values`` name->id dict in sync
(``CustomRemapLabels``, with the 'Left'/'Right' half-space masks of
``get_mask_from_masking_method``), label removal, sequential relabelling and
the merge of paired left/right labels that qsm's configuration runs
(``CustomRemoveLabels``, ``CustomSequentialLabels``, ``MergeLabels``), and
the invertible one-hot/argmax pair. Host-side numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import numpy as np

from ..core.subject import Subject
from .base import LabelTransform

TypeLabelRemapping = Union[Dict[int, int], Sequence[Tuple[str, int, int]]]


def get_mask_from_masking_method(masking_method, subject: Subject, data: np.ndarray) -> np.ndarray:
    """A boolean mask of ``data``'s shape (C, W, H, D).

    Supports None (all true), the anatomical half-spaces 'Left'/'Right' (the
    spatial axis that carries world x in the first image's affine, split at
    its middle, the half chosen by that axis's sign), the name of a label
    map in the subject, or a callable.
    """
    if masking_method is None:
        return np.ones(data.shape, dtype=bool)
    if callable(masking_method):
        return np.asarray(masking_method(subject, data), dtype=bool)
    if isinstance(masking_method, str):
        if masking_method in ("Left", "Right"):
            affine = subject.get_first_image().affine
            xcomp = affine[0, :3]
            axis = int(np.argmax(np.abs(xcomp)))
            positive_is_right = xcomp[axis] > 0
            half = data.shape[1 + axis] // 2
            mask = np.zeros(data.shape, dtype=bool)
            idx = [slice(None)] * 4
            want_upper = (masking_method == "Right") == positive_is_right
            idx[1 + axis] = slice(half, None) if want_upper else slice(0, half)
            mask[tuple(idx)] = True
            return mask
        if masking_method in subject:
            m = np.asarray(subject[masking_method].data) > 0
            if m.shape[0] == 1 and data.shape[0] != 1:
                m = np.broadcast_to(m, data.shape)
            return m
    raise ValueError(f"Unsupported masking_method: {masking_method!r}")


class CustomRemapLabels(LabelTransform):
    """Masked label remap that keeps ``label_values`` in sync; invertible by
    swapping old and new ids."""

    def __init__(self, remapping: TypeLabelRemapping, masking_method=None,
                 invertible: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.remapping = self._parse(remapping)
        self.masking_method = masking_method
        self.invertible = invertible

    @staticmethod
    def _parse(remapping):
        if isinstance(remapping, dict):
            for k, v in remapping.items():
                if not isinstance(k, int) or not isinstance(v, int):
                    raise ValueError(f"Dict remapping must be Dict[int, int], got {remapping}")
        elif isinstance(remapping, (list, tuple)):
            for remap in remapping:
                if len(remap) != 3 or not isinstance(remap[0], str):
                    raise ValueError(
                        "Sequence remapping must be (label_name, old_id, new_id) tuples, "
                        f"got {remapping}")
        else:
            raise ValueError(f"Bad remapping {remapping}")
        return remapping

    def apply_transform(self, subject):
        for image in self.get_images(subject):
            if isinstance(self.remapping, dict):
                label_remapping = dict(self.remapping)
            else:
                label_remapping = {old_id: new_id for _, old_id, new_id in self.remapping}
                if "label_values" in image:
                    label_values = image["label_values"]
                    for label_name, _, new_id in self.remapping:
                        label_values[label_name] = new_id

            data = np.asarray(image.data)
            new_data = data.copy()
            mask = get_mask_from_masking_method(self.masking_method, subject, new_data)
            for old_id, new_id in label_remapping.items():
                new_data[mask & (data == old_id)] = new_id
            image.set_data(new_data)
        return None

    def is_invertible(self):
        return self.invertible

    def inverse(self, args=None):
        if isinstance(self.remapping, dict):
            inverse_remapping = {v: k for k, v in self.remapping.items()}
        else:
            inverse_remapping = [(name, new_id, old_id) for name, old_id, new_id in self.remapping]
        return CustomRemapLabels(inverse_remapping, masking_method=self.masking_method,
                                 **self._sel())


class CustomRemoveLabels(LabelTransform):
    """Remove labels (by name or id) to a background value; prunes
    ``label_values`` entries; not invertible."""

    def __init__(self, labels, background_label: int = 0, masking_method=None, **kwargs):
        super().__init__(**kwargs)
        self.labels = list(labels)
        self.background_label = background_label
        self.masking_method = masking_method

    def apply_transform(self, subject):
        for name, image in self.get_images_dict(subject).items():
            label_ids = []
            for label in self.labels:
                if isinstance(label, int):
                    label_ids.append(label)
                elif isinstance(label, str):
                    if "label_values" not in image:
                        raise RuntimeError(
                            "Image must have a 'label_values' dict to remove a label by name")
                    label_ids.append(image["label_values"][label])
                else:
                    raise ValueError(f"Label must be str or int, got {label!r}")

            remap = CustomRemapLabels(
                remapping={lid: self.background_label for lid in label_ids},
                masking_method=self.masking_method, include=[name], invertible=False)
            remap(subject, record=False)

            if "label_values" in image:
                for label_name in [n for n, v in image["label_values"].items() if v in label_ids]:
                    del image["label_values"][label_name]
        return None

    def is_invertible(self):
        return False


class CustomSequentialLabels(LabelTransform):
    """Remap label ids to 1..K in the order of their current values."""

    def __init__(self, masking_method=None, **kwargs):
        super().__init__(**kwargs)
        self.masking_method = masking_method

    def apply_transform(self, subject):
        for name, image in self.get_images_dict(subject).items():
            if "label_values" in image:
                # ranks the distinct values, not the names: after MergeLabels
                # two names share one id, and a rank per name would give ids
                # beyond the class count (as the JAX package does)
                label_values = image["label_values"]
                value_rank = {v: i + 1 for i, v in enumerate(sorted(set(label_values.values())))}
                remapping = [(n, v, value_rank[v]) for n, v in label_values.items()]
            else:
                unique = [u for u in sorted(np.unique(np.asarray(image.data)).tolist()) if u != 0]
                remapping = {int(u): i + 1 for i, u in enumerate(unique)}
            remap = CustomRemapLabels(remapping, masking_method=self.masking_method,
                                      include=[name])
            remap(subject, record=False)
        return None


class CustomOneHot(LabelTransform):
    """One-hot encode 1-channel label maps; the class count comes from
    ``label_values`` when not given; the inverse is CustomArgMax."""

    def __init__(self, num_classes: int = -1, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes

    def apply_transform(self, subject):
        for image in self.get_images(subject):
            data = np.asarray(image.data)
            if data.shape[0] != 1:
                raise RuntimeError(
                    f"Expected 1 input channel for one-hot, got {data.shape[0]}")
            if self.num_classes == -1 and "label_values" in image:
                num_classes = max(image["label_values"].values()) + 1
            else:
                num_classes = self.num_classes
            if num_classes <= 0:
                num_classes = int(data.max()) + 1
            labels = data[0].astype(np.int64)
            one_hot = np.eye(num_classes, dtype=data.dtype)[labels]  # (W, H, D, C)
            image.set_data(np.moveaxis(one_hot, -1, 0))
            image["one_hot"] = True
        return None

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        return CustomArgMax(num_classes=self.num_classes, **self._sel())


class CustomArgMax(LabelTransform):
    """Channel argmax to int32; the inverse is CustomOneHot."""

    def __init__(self, num_classes: int = -1, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes

    def apply_transform(self, subject):
        for image in self.get_images(subject):
            data = np.asarray(image.data)
            image.set_data(np.argmax(data, axis=0)[None].astype(np.int32))
            image["one_hot"] = False
        return None

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        return CustomOneHot(num_classes=self.num_classes, **self._sel())


class MergeLabels(LabelTransform):
    """Merge paired left/right labels under a hemisphere mask. Exactly one of
    ``left_masking_method``/``right_masking_method`` is given: with the left
    one, the left label's id becomes the right label's inside the left mask;
    with the right one, the other way round."""

    def __init__(self, merge_labels: Sequence[Tuple[str, str]],
                 left_masking_method=None, right_masking_method=None, **kwargs):
        super().__init__(**kwargs)
        if (left_masking_method is None) == (right_masking_method is None):
            raise ValueError(
                "Exactly one of left_masking_method or right_masking_method must be provided")
        for left, right in merge_labels:
            if not isinstance(left, str) or not isinstance(right, str):
                raise ValueError("Label identifiers must be strings")
        self.merge_labels = list(merge_labels)
        self.left_masking_method = left_masking_method
        self.right_masking_method = right_masking_method

    def apply_transform(self, subject):
        for name, image in self.get_images_dict(subject).items():
            if "label_values" not in image:
                raise RuntimeError(f"label_values dict not found in image {name}")
            label_values = image["label_values"]
            if self.left_masking_method:
                remapping = [(l, label_values[l], label_values[r]) for l, r in self.merge_labels]
                masking_method = self.left_masking_method
            else:
                remapping = [(r, label_values[r], label_values[l]) for l, r in self.merge_labels]
                masking_method = self.right_masking_method
            remap = CustomRemapLabels(remapping, masking_method=masking_method, include=[name])
            remap(subject, record=False)
        return None

    def is_invertible(self):
        return False
