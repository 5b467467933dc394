"""Predictors, ported from segmentation_pipeline_tpu/prediction.py:
``StandardPredict`` (whole images, with the sagittal split-and-flip batching
trick), ``PatchPredict`` (sliding-window patches, ops/sliding_window.py) and
``add_evaluation_labels``.

The prediction stays on the device through the model; with ``device_argmax``
only the label ids come back to the host, bit-packed (ops/bitpack.py).
PatchPredict's ``device_postprocess`` runs a cleanup chain on those ids on
the device first (ops/morphology.py), and a trainer's device-confusion plan
(training/device_confusion.py) reduces them to counts there.
"""
from __future__ import annotations

import copy
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.subject import LabelMap, Subject, collate_subjects
from .device import resolve_device
from .ops.bitpack import argmax_ids, fetch_ids, idx_dtype_for, start_fetch
from .ops.sliding_window import sliding_window_inference
from .parallel.halo import distributed_sliding_window
from .parallel.mesh import SPATIAL_ITEM, Mesh, MeshRecipe
from .training.model import SegModel, to_channels_first, to_channels_last
from .training.train_step import apply_stochastic_matrix_cl
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


def apply_stochastic_matrix(y_pred: torch.Tensor, y_prior: torch.Tensor) -> torch.Tensor:
    """The cascade's refinement, channel-first: y_pred (N, C^2, W, H, D) holds
    each voxel's column-stochastic C x C matrix M (row-major), y_prior
    (N, C, W, H, D) the prior; refined[row] = sum_col M[row, col] *
    prior[col], the JAX package's Markov update of the prior
    (training/train_step.py's channels-last contraction)."""
    return to_channels_first(apply_stochastic_matrix_cl(to_channels_last(y_pred),
                                                        to_channels_last(y_prior)))


class Predictor(ABC):
    """Gets model predictions for a list of subjects; attaches 'y_pred'."""

    @abstractmethod
    def predict(self, model, subjects: Sequence[Subject],
                label_attributes: Optional[Dict[str, Any]] = None
                ) -> Tuple[Sequence[Subject], Dict[str, torch.Tensor]]:
        ...


class _LazyBatch(dict):
    """Batch dict whose input-image entries collate on first access.

    PatchPredict's main consumer, the trainer's scheduled validation sweep,
    discards the returned batch, so collating the input volumes eagerly would
    upload each one to the device for nothing. ``y_pred`` is set eagerly; the
    named input images collate (to the predictor's device, through the device
    mirrors when ``cache``) only when indexed.
    """

    def __init__(self, subjects, image_names, cache: bool, device):
        super().__init__()
        self._subjects = list(subjects)
        self._lazy = list(image_names)
        self._cache = cache
        self._device = device

    def _materialize(self, key):
        value = collate_subjects(self._subjects, image_names=[key], device=self._device,
                                 cache=self._cache)[key]
        dict.__setitem__(self, key, value)
        return value

    def __missing__(self, key):
        if key in self._lazy:
            return self._materialize(key)
        raise KeyError(key)

    def __contains__(self, key):
        return dict.__contains__(self, key) or key in self._lazy

    def get(self, key, default=None):
        # only an ABSENT key returns the default: a KeyError raised while
        # materializing a present key (a subject missing the image) is a
        # data problem and propagates
        if key not in self:
            return default
        return self[key]

    def _all_keys(self):
        return list(dict.keys(self)) + [k for k in self._lazy if not dict.__contains__(self, k)]

    def keys(self):
        return self._all_keys()

    def __iter__(self):
        return iter(self._all_keys())

    def __len__(self):
        return len(self._all_keys())

    def items(self):
        return [(k, self[k]) for k in self._all_keys()]

    def values(self):
        return [self[k] for k in self._all_keys()]


# the transform types whose inverses produce evaluation-space labels
EVAL_LABEL_TYPES = (LabelTransform, CopyProperty, RenameProperty,
                    ConcatenateImages)


def ids_to_onehot(ids: np.ndarray, n_channels: int, channel_axis: int = 0
                  ) -> np.ndarray:
    """Expand argmax ids back to the float32 one-hot the framework's y_pred
    consumers expect. Host-side: a memory-bandwidth op, never a transfer."""
    return np.moveaxis(np.eye(n_channels, dtype=np.float32)[ids], -1, channel_axis)


def _attach_prediction(subject: Subject, y_pred: np.ndarray, label_attributes):
    image = LabelMap(tensor=y_pred, **copy.deepcopy(label_attributes or {}))
    if "X" in subject:
        image.affine = subject["X"].affine.copy()
    subject.add_image(image, "y_pred")
    EnforceConsistentAffine(source_image_name="X")(subject)
    return subject


def _deliver_deferred(plan, joint_pairs, deferred, preds, n_ch, label_attributes):
    """Fetch the device counts of a sweep in one transfer (``plan.deliver``);
    a subject whose counts could not be delivered (an instance reduction
    past its component budget) has its prediction fetched after all."""
    delivered = {id(s) for s in plan.deliver(joint_pairs)}
    for slot, subject, ids_dev in deferred:
        if id(subject) in delivered:
            continue
        y_np = ids_to_onehot(fetch_ids(ids_dev, n_ch), n_ch)
        preds[slot] = y_np
        _attach_prediction(subject, y_np, label_attributes)


class StandardPredict(Predictor):
    """Whole-image batched prediction on ``device`` (the card unless the
    caller passes ``device="cpu"``).

    With ``refine_image`` (the cascade) the model's C^2 channels are each
    voxel's transition matrix, contracted with that image of the batch (the
    prior) by ``apply_stochastic_matrix``; the image joins ``image_names``."""

    # a trainer's device-confusion plan for one sweep
    # (training/device_confusion.py)
    _confusion_plan = None

    def __init__(self, image_names: Sequence[str] = ("X",), sagittal_split: bool = False,
                 refine_image: str = None, device_argmax: bool = False,
                 cache_inputs: Optional[bool] = None, device=None):
        image_names = list(image_names)
        if refine_image is not None and refine_image not in image_names:
            image_names.append(refine_image)
        self.image_names = image_names
        self.sagittal_split = sagittal_split
        self.refine_image = refine_image
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
        if self.refine_image is not None:
            y_pred = apply_stochastic_matrix(y_pred, batch[self.refine_image])

        batch["y_pred"] = y_pred
        n_ch = y_pred.shape[1]
        if self.device_argmax and n_ch > 1:
            ids_dev = argmax_ids(y_pred, 1)
            plan = self._confusion_plan
            if plan is not None:
                # the sweep's counts on the device
                joint_pairs = []
                for i, subject in enumerate(subjects):
                    res = plan.device_joint(subject, ids_dev[i], n_ch)
                    if res is not None:
                        joint_pairs.append((subject, res))
                delivered = plan.deliver(joint_pairs) if joint_pairs else []
                if plan.skip_fetch and len(delivered) == len(subjects):
                    # a validated reduction-only sweep: only counts crossed
                    # the link, no prediction is attached
                    return list(subjects), batch
            y_np = ids_to_onehot(fetch_ids(ids_dev, n_ch), n_ch, channel_axis=1)
        else:
            # C == 1: the single channel IS the mask/probability — argmax
            # would collapse it to all-zero ids; fall back to the full fetch
            y_np = y_pred.cpu().numpy()
        out_subjects = []
        for i, subject in enumerate(subjects):
            out_subjects.append(_attach_prediction(subject, y_np[i], label_attributes))
        return out_subjects, batch


class PatchPredict(Predictor):
    """Sliding-window patch prediction with overlap-add on ``device`` (the
    card unless the caller passes ``device="cpu"``).

    Each subject's ``X`` is padded where it is smaller than the patch
    (``padding_mode``: None or 0 for zeros, ``"edge"``, or a constant) and,
    with ``shape_bucket``, up to the next multiple of it; uploaded (cast to
    the model's ``compute_dtype`` on the host first, or kept on the device
    through ``Image.device_mirror`` with ``cache_inputs``); run through
    ``sliding_window_inference``; and, with ``device_argmax`` and more than
    one output channel, fetched as bit-packed argmax ids and attached as
    their one-hot expansion. Subject i's fetch waits only for its own
    device work: subject i+1's window is queued before it. ``batch["y_pred"]``
    is host numpy, a list for a ragged cohort.

    ``device_postprocess`` ([(op, arg), ...]; needs ``device_argmax`` and
    more than one channel) runs that cleanup chain on each subject's ids on
    the device before the fetch (ops/morphology.py::apply_device_postprocess:
    'remove_holes', 'keep_components', 'remove_small_components', exactly
    the host functions' labels). It cleans in model space, before the
    inversion of the tape; pipelines that clean after it keep the host
    functions.

    A SegModel runs its module on channels-last patches in its
    ``compute_dtype``; any other callable (an ensemble) gets channel-first
    patches. Out of device memory, the patch batch halves and stays halved
    for later subjects and calls.

    With a ``mesh`` (parallel/mesh.py) each rank runs its share of each
    subject's patch grid and one all-reduce merges the shares
    (``distributed_sliding_window``); every rank then holds the whole
    prediction and goes on as one device does. Pickled, the mesh is its
    ``MeshRecipe``, rebuilt over the process group at the first predict
    after loading, on the predictor's device. ``volume_sharded=True`` (a
    W-sharded volume) waits for ROADMAP Queue 1 item 10b.
    """

    # a trainer's device-confusion plan for one sweep
    # (training/device_confusion.py); never pickled
    _confusion_plan = None

    def __init__(self, image_names: Sequence[str] = ("X",), patch_batch_size: int = 16,
                 patch_size=None, patch_overlap=(0, 0, 0), padding_mode=None,
                 overlap_mode: str = "average", shape_bucket: int = 0,
                 mesh=None, volume_sharded: bool = False,
                 device_argmax: bool = False,
                 cache_inputs: Optional[bool] = None,
                 device_postprocess: Optional[Sequence] = None,
                 device=None):
        if volume_sharded:
            raise NotImplementedError(
                f"PatchPredict(volume_sharded=True) waits for the port of {SPATIAL_ITEM}")
        self.image_names = list(image_names)
        self.patch_batch_size = patch_batch_size
        self.patch_size = patch_size
        self.patch_overlap = patch_overlap
        self.padding_mode = padding_mode
        self.overlap_mode = overlap_mode
        self.shape_bucket = shape_bucket
        self.device_argmax = device_argmax
        self.cache_inputs = cache_inputs
        self.device_postprocess = list(device_postprocess) if device_postprocess else None
        self.mesh = mesh
        self.device = resolve_device(device)

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_confusion_plan", None)
        if isinstance(state.get("mesh"), Mesh):
            state["mesh"] = MeshRecipe.of(state["mesh"])
        return state

    def __setstate__(self, state):
        # attributes newer than a pickled checkpoint
        state.setdefault("mesh", None)
        state.setdefault("device_postprocess", None)
        state.setdefault("cache_inputs", None)
        state.setdefault("device_argmax", False)
        state.setdefault("shape_bucket", 0)
        self.__dict__.update(state)

    def _pad_volume(self, volume: np.ndarray, pad) -> np.ndarray:
        if self.padding_mode in (None, 0):
            return np.pad(volume, pad)
        if self.padding_mode == "edge":
            return np.pad(volume, pad, mode="edge")
        return np.pad(volume, pad, mode="constant", constant_values=float(self.padding_mode))

    def _upload(self, data, pad, padded: bool, dtype: Optional[torch.dtype]) -> torch.Tensor:
        """Pad on the host, cast there (to ``dtype`` through torch, since
        numpy has no bfloat16), then one host-to-device copy."""
        volume = np.asarray(data)
        if padded:
            volume = self._pad_volume(volume, pad)
        volume = torch.as_tensor(volume, dtype=torch.float32)
        if dtype is not None:
            volume = volume.to(dtype)
        return volume.to(self.device)

    def _model_fn(self, model):
        """The model on channels-last patches -> channels-last float32, and
        the dtype its input volume is uploaded in (None: float32)."""
        if isinstance(model, SegModel):
            model.ensure_initialized()
            module, dtype = model.module, model._dtype()
            module.eval()
            return (lambda patches: module(patches).float()), dtype

        def generic(patches):
            return model(patches.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).float()

        return generic, None

    def _run_with_batch_degrade(self, run):
        """``run(batch_size)``, halving the patch batch while the device runs
        out of memory; the batch that ran is remembered for later subjects
        and calls."""
        batch_size = getattr(self, "_effective_patch_batch", self.patch_batch_size)
        while True:
            try:
                out = run(batch_size)
                self._effective_patch_batch = batch_size
                return out
            except torch.cuda.OutOfMemoryError:
                if batch_size <= 1:
                    raise
                batch_size = max(1, batch_size // 2)
                torch.cuda.empty_cache()
                print(f"PatchPredict: out of device memory; retrying with "
                      f"patch_batch_size={batch_size}", flush=True)

    def _postprocess_error(self, n_ch):
        # the caller asked for the fused cleanup and may have skipped the
        # host one: demoting it would ship an uncleaned segmentation
        return ValueError(
            "device_postprocess requires device_argmax with a multi-channel model (the fused "
            f"cleanup runs on argmax ids); got device_argmax={self.device_argmax}, "
            f"out_channels={n_ch}. Use the host post_processing functions instead.")

    def predict(self, model, subjects, label_attributes=None):
        if self.device_postprocess and subjects and not self.device_argmax:
            raise self._postprocess_error(None)
        patch_size = self.patch_size
        if patch_size is None:
            raise ValueError("PatchPredict needs a patch_size")
        if isinstance(patch_size, int):
            patch_size = (patch_size,) * 3
        model_fn, dtype = self._model_fn(model)
        if isinstance(self.mesh, MeshRecipe):
            self.mesh = self.mesh.build(self.device)
        if self.mesh is None:
            window = sliding_window_inference
        else:
            def window(volume, fn, size, overlap, batch, mode):
                return distributed_sliding_window(volume, fn, size, overlap, batch, mode,
                                                  mesh=self.mesh)

        out_subjects, preds = [], []
        plan = self._confusion_plan if self.device_argmax else None
        # the sweep's device counts, and the subjects whose fetch waits on
        # their delivery
        joint_pairs, deferred = [], []
        n_ch = None

        def finalize(subject, spatial, padded, n_ch, finish):
            y_np = finish()
            if n_ch is not None:
                if padded:
                    y_np = y_np[:spatial[0], :spatial[1], :spatial[2]]
                y_np = ids_to_onehot(y_np, n_ch)
            elif padded:
                y_np = y_np[:, :spatial[0], :spatial[1], :spatial[2]]
            preds.append(y_np)
            out_subjects.append(_attach_prediction(subject, y_np, label_attributes))

        pending = None
        for subject in subjects:
            image = subject["X"]
            spatial = image.spatial_shape
            targets = [max(p, s) for p, s in zip(patch_size, spatial)]
            if self.shape_bucket:
                b = self.shape_bucket
                targets = [((t + b - 1) // b) * b for t in targets]
            pad = [(0, 0)] + [(0, t - s) for t, s in zip(targets, spatial)]
            padded = any(p[1] for p in pad)
            if self.cache_inputs:
                key = ("swi", tuple(targets), str(self.padding_mode), str(dtype),
                       str(self.device))
                volume = image.device_mirror(
                    key, lambda data, pad=pad, padded=padded: self._upload(data, pad, padded,
                                                                           dtype))
            else:
                volume = self._upload(image.data, pad, padded, dtype)
            y = self._run_with_batch_degrade(lambda bs: window(
                volume, model_fn, patch_size, self.patch_overlap, bs, self.overlap_mode))
            del volume
            # with one channel, the channel is the mask: an argmax would be 0
            n_ch = y.shape[0] if self.device_argmax and y.shape[0] > 1 else None
            if self.device_postprocess and n_ch is None:
                raise self._postprocess_error(y.shape[0])
            if n_ch is None:
                finish = start_fetch(y, None)
            else:
                ids = argmax_ids(y, 0)
                if padded and (self.device_postprocess or plan is not None):
                    ids = ids[:spatial[0], :spatial[1], :spatial[2]]
                    padded = False
                if self.device_postprocess:
                    # the cleanup on the device: the fetch ships the cleaned ids
                    from .ops.morphology import apply_device_postprocess

                    ids = apply_device_postprocess(ids, self.device_postprocess, n_ch).to(
                        idx_dtype_for(n_ch))
                res = plan.device_joint(subject, ids, n_ch) if plan is not None else None
                if res is not None:
                    joint_pairs.append((subject, res))
                if res is not None and plan.skip_fetch:
                    # a validated reduction-only sweep: no fetch, nothing
                    # attached, unless delivery fails (then fetched late)
                    del y
                    if pending is not None:
                        finalize(*pending)
                        pending = None
                    deferred.append((len(preds), subject, ids))
                    out_subjects.append(subject)
                    preds.append(None)
                    continue
                finish = start_fetch(ids, n_ch)
            del y
            if pending is not None:
                finalize(*pending)
            pending = (subject, spatial, padded, n_ch, finish)
        if pending is not None:
            finalize(*pending)
        if joint_pairs:
            _deliver_deferred(plan, joint_pairs, deferred, preds, n_ch, label_attributes)

        batch = _LazyBatch(subjects, self.image_names, cache=bool(self.cache_inputs),
                           device=self.device)
        if not preds or any(p is None for p in preds):
            # no subject, or a reduction-only sweep: no volumes
            batch["y_pred"] = None
        elif len({p.shape for p in preds}) == 1:
            batch["y_pred"] = np.stack(preds)
        else:
            # a ragged cohort (what shape_bucket serves) has no rectangular
            # stack: the per-subject arrays, in subject order
            batch["y_pred"] = list(preds)
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
