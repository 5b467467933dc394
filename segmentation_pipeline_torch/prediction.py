"""Whole-image prediction, ported from segmentation_pipeline_tpu/prediction.py
(``StandardPredict`` with the sagittal split-and-flip batching trick, and
``add_evaluation_labels``).

The prediction stays on the device through the model; with ``device_argmax``
only the label ids come back to the host, bit-packed (ops/bitpack.py).
"""
from __future__ import annotations

import copy
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.subject import LabelMap, Subject, collate_subjects
from .device import resolve_device
from .ops.bitpack import fetch_ids
from .transforms.base import LabelTransform, apply_inverse_on_new_subject
from .transforms.spatial import EnforceConsistentAffine
from .transforms.structural import ConcatenateImages, CopyProperty, RenameProperty


def split_and_flip(x: torch.Tensor) -> torch.Tensor:
    """Split each volume into hemispheres along W and mirror the second half
    into the batch. x: (N, C, W, H, D) -> (2N, C, W/2, H, D)."""
    half = x.shape[2] // 2
    first, second = x[:, :, :half], x[:, :, half:]
    return torch.cat([first, torch.flip(second, dims=(2,))], dim=0)


def reverse_split_and_flip(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[0] // 2
    first, second = x[:half], x[half:]
    return torch.cat([first, torch.flip(second, dims=(2,))], dim=2)


class Predictor(ABC):
    """Gets model predictions for a list of subjects; attaches 'y_pred'."""

    @abstractmethod
    def predict(self, model, subjects: Sequence[Subject],
                label_attributes: Optional[Dict[str, Any]] = None
                ) -> Tuple[Sequence[Subject], Dict[str, torch.Tensor]]:
        ...


# the transform types whose inverses produce evaluation-space labels
EVAL_LABEL_TYPES = (LabelTransform, CopyProperty, RenameProperty,
                    ConcatenateImages)


def idx_dtype_for(n_channels: int) -> torch.dtype:
    """Smallest integer dtype holding channel indices (device-argmax fetch)."""
    return torch.uint8 if n_channels <= 255 else torch.int32


def ids_to_onehot(ids: np.ndarray, n_channels: int, channel_axis: int = 0
                  ) -> np.ndarray:
    """Expand argmax ids back to the float32 one-hot the framework's y_pred
    consumers expect. Host-side: a memory-bandwidth op, never a transfer."""
    return np.moveaxis(np.eye(n_channels, dtype=np.float32)[ids], -1, channel_axis)


def _fetch_ids_host(ids_dev: torch.Tensor, n_channels: int) -> np.ndarray:
    """Fetch device argmax ids to the host: bit-packed (ceil(log2 C) bits per
    voxel) when C fits uint8, a plain copy otherwise. The one fetch policy of
    every device_argmax path."""
    if n_channels <= 255:
        return fetch_ids(ids_dev, n_channels)
    return ids_dev.cpu().numpy()


def _attach_prediction(subject: Subject, y_pred: np.ndarray, label_attributes):
    image = LabelMap(tensor=y_pred, **copy.deepcopy(label_attributes or {}))
    if "X" in subject:
        image.affine = subject["X"].affine.copy()
    subject.add_image(image, "y_pred")
    EnforceConsistentAffine(source_image_name="X")(subject)
    return subject


class StandardPredict(Predictor):
    """Whole-image batched prediction on ``device`` (the card unless the
    caller passes ``device="cpu"``)."""

    def __init__(self, image_names: Sequence[str] = ("X",), sagittal_split: bool = False,
                 device_argmax: bool = False, cache_inputs: Optional[bool] = None,
                 device=None):
        self.image_names = list(image_names)
        self.sagittal_split = sagittal_split
        # fetch argmax label ids instead of the C-channel float32 volume and
        # attach the one-hot expansion
        self.device_argmax = device_argmax
        # cache_inputs: keep each input image's device upload alive on the
        # subject (Image.device_mirror) so predicting the same unchanged
        # subjects again skips the host->device transfer
        self.cache_inputs = cache_inputs
        self.device = resolve_device(device)

    def predict(self, model, subjects, label_attributes=None):
        batch = collate_subjects(subjects, image_names=self.image_names,
                                 device=self.device, cache=bool(self.cache_inputs))

        if self.sagittal_split:
            y_pred = reverse_split_and_flip(model(split_and_flip(batch["X"])))
        else:
            y_pred = model(batch["X"])

        batch["y_pred"] = y_pred
        n_ch = y_pred.shape[1]
        if self.device_argmax and n_ch > 1:
            ids = torch.argmax(y_pred, dim=1).to(idx_dtype_for(n_ch))
            y_np = ids_to_onehot(_fetch_ids_host(ids, n_ch), n_ch, channel_axis=1)
        else:
            # C == 1: the single channel IS the mask/probability — argmax
            # would collapse it to all-zero ids; fall back to the full fetch
            y_np = y_pred.cpu().numpy()
        out_subjects = []
        for i, subject in enumerate(subjects):
            out_subjects.append(_attach_prediction(subject, y_np[i], label_attributes))
        return out_subjects, batch


def add_evaluation_labels(subjects: Sequence[Subject]):
    """Invert the label-only part of each subject's history on 'y_pred' and
    'y', and attach 'y_pred_eval' and 'y_eval'."""
    label_types = list(EVAL_LABEL_TYPES)
    for subject in subjects:
        records = subject.get_composed_history()

        if "y_pred" in subject:
            # deepcopy: the transforms mutate in place
            pred_subject = Subject({"y": copy.deepcopy(subject["y_pred"])})
            out = apply_inverse_on_new_subject(records, pred_subject,
                                               include_types=label_types, warn=False)
            subject.add_image(out.get_first_image(), "y_pred_eval")

        if "y" in subject:
            target_subject = Subject({"y": copy.deepcopy(subject["y"])})
            out = apply_inverse_on_new_subject(records, target_subject,
                                               include_types=label_types, warn=False)
            subject.add_image(out.get_first_image(), "y_eval")
