"""Transform engine and the invertible applied-transform tape, ported from
segmentation_pipeline_tpu/transforms/base.py.

A transform application mutates the subject in place and records its
reproducible applied args on the subject's history tape; inversion replays
concrete inverse transforms built from those args, newest first
(``invert_records``). Host-side numpy, as in the JAX package.
"""
from __future__ import annotations

import copy
import threading as _threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..core.subject import Image, LabelMap, Subject
from ..utils.misc import as_list, auto_str

# Each thread gets its own Generator spawned from a shared SeedSequence so
# threads never race on one BitGenerator's state (numpy Generators are not
# thread-safe). seed_all() resets the sequence.
_RNG_LOCK = _threading.Lock()
_SEED_SEQ = np.random.SeedSequence()
_THREAD_LOCAL = _threading.local()
_EPOCH = 0


def seed_all(seed: int):
    """Reset every host RNG domain: the per-thread transform Generators,
    numpy's legacy global state and Python's ``random`` module."""
    import random as _pyrandom

    global _SEED_SEQ, _EPOCH
    with _RNG_LOCK:
        _SEED_SEQ = np.random.SeedSequence(seed)
        _EPOCH += 1
        _pyrandom.seed(seed)
        np.random.seed(seed % (2 ** 32))


def get_rng() -> np.random.Generator:
    if getattr(_THREAD_LOCAL, "epoch", None) != _EPOCH:
        with _RNG_LOCK:
            child = _SEED_SEQ.spawn(1)[0]
        _THREAD_LOCAL.rng = np.random.default_rng(child)
        _THREAD_LOCAL.epoch = _EPOCH
    return _THREAD_LOCAL.rng


class TransformRecord:
    """One applied transform on the history tape."""

    __slots__ = ("transform", "args")

    def __init__(self, transform: "Transform", args: Optional[Dict[str, Any]]):
        self.transform = transform
        self.args = args or {}

    def __repr__(self):
        return f"TransformRecord({type(self.transform).__name__}, {self.args})"


class Transform:
    """Base transform.

    Subclasses implement ``apply_transform(subject) -> args | None`` which
    mutates the subject in place and returns the reproducible applied args
    needed for inversion (None if the constructor params already suffice).
    """

    def __init__(self, p: float = 1.0, include=None, exclude=None):
        self.p = p
        self.include = as_list(include) if include is not None else None
        self.exclude = as_list(exclude) if exclude is not None else None

    # ---- application ---------------------------------------------------
    def __call__(self, subject, record: bool = True):
        if isinstance(subject, (list, tuple)):
            return [self(s, record=record) for s in subject]
        if self.p < 1.0 and get_rng().random() > self.p:
            return subject
        args = self.apply_transform(subject)
        if record:
            subject.add_transform_record(TransformRecord(self, args))
        return subject

    def apply_transform(self, subject: Subject) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    # ---- image selection ----------------------------------------------
    def get_images_dict(self, subject: Subject, intensity_only: bool = False) -> Dict[str, Image]:
        out = {}
        for name, image in subject.get_images_dict(intensity_only=intensity_only).items():
            if self.include is not None and name not in self.include:
                continue
            if self.exclude is not None and name in self.exclude:
                continue
            out[name] = image
        return out

    def get_images(self, subject: Subject, intensity_only: bool = False) -> List[Image]:
        return list(self.get_images_dict(subject, intensity_only).values())

    # ---- inversion -----------------------------------------------------
    def is_invertible(self) -> bool:
        return False

    def inverse(self, args: Optional[Dict[str, Any]] = None) -> "Transform":
        raise NotImplementedError(f"{type(self).__name__} is not invertible")

    def _selection_kwargs(self) -> Dict[str, Any]:
        return dict(include=self.include, exclude=self.exclude)

    def _sel(self) -> Dict[str, Any]:
        """Non-None selection kwargs, for propagating include/exclude onto an
        inverse transform — an inverse that drops the selection would
        pad/crop/flip images the forward transform never touched."""
        return {k: v for k, v in self._selection_kwargs().items() if v is not None}

    def __repr__(self):
        return auto_str(self)


# Marker base classes of the torchio taxonomy that the tape is filtered on
# (EVAL_LABEL_TYPES in prediction.py).
class SpatialTransform(Transform):
    pass


class IntensityTransform(Transform):
    """Applies to scalar images only."""

    def get_images_dict(self, subject, intensity_only: bool = True):
        return super().get_images_dict(subject, intensity_only=True)


class LabelTransform(Transform):
    """Label-map manipulation; part of the evaluation-space inverse set.
    Applies only to LabelMap images."""

    def get_images_dict(self, subject, intensity_only: bool = False):
        return {name: image
                for name, image in super().get_images_dict(subject, intensity_only).items()
                if isinstance(image, LabelMap)}


class RandomTransform(Transform):
    @property
    def rng(self) -> np.random.Generator:
        return get_rng()


class Compose(Transform):
    """Sequential composition. Child applications are recorded individually on
    the tape (the tape is flat), so filtering and inversion work uniformly."""

    def __init__(self, transforms: Sequence[Transform], **kwargs):
        super().__init__(**kwargs)
        self.transforms = list(transforms)

    def __iter__(self):
        return iter(self.transforms)

    def __call__(self, subject, record: bool = True):
        if isinstance(subject, (list, tuple)):
            return [self(s, record=record) for s in subject]
        if self.p < 1.0 and get_rng().random() > self.p:
            return subject
        for t in self.transforms:
            if self.exclude is not None:
                t = _with_extra_exclude(t, self.exclude)
            subject = t(subject, record=record)
        return subject

    def apply_transform(self, subject):  # pragma: no cover - __call__ overridden
        raise RuntimeError("Compose dispatches via __call__")


def _with_extra_exclude(t: Transform, extra: List[str]) -> Transform:
    """A shallow copy of ``t`` that also excludes a Compose-level exclude
    list."""
    if not extra:
        return t
    t2 = copy.copy(t)
    t2.exclude = list(set((t.exclude or []) + list(extra)))
    return t2


class OneOf(Transform):
    """Probabilistic choice between transforms (tio.OneOf semantics)."""

    def __init__(self, transforms: Union[Dict[Transform, float], Sequence[Transform]], **kwargs):
        super().__init__(**kwargs)
        if isinstance(transforms, dict):
            self.transforms = list(transforms.keys())
            weights = np.array(list(transforms.values()), dtype=np.float64)
        else:
            self.transforms = list(transforms)
            weights = np.ones(len(self.transforms), dtype=np.float64)
        self.weights = weights / weights.sum()

    def __call__(self, subject, record: bool = True):
        if isinstance(subject, (list, tuple)):
            return [self(s, record=record) for s in subject]
        if self.p < 1.0 and get_rng().random() > self.p:
            return subject
        idx = int(get_rng().choice(len(self.transforms), p=self.weights))
        return self.transforms[idx](subject, record=record)

    def apply_transform(self, subject):  # pragma: no cover
        raise RuntimeError("OneOf dispatches via __call__")


# ---------------------------------------------------------------------------
# History-tape operations
# ---------------------------------------------------------------------------

def filter_records(
    records: Sequence[TransformRecord],
    include_types: Sequence[type] = None,
    exclude_types: Sequence[type] = None,
) -> List[TransformRecord]:
    """Filter a flat history tape by transform type."""
    out = []
    for rec in records:
        t = rec.transform
        if include_types is not None and not any(isinstance(t, typ) for typ in include_types):
            continue
        if exclude_types is not None and any(isinstance(t, typ) for typ in exclude_types):
            continue
        out.append(rec)
    return out


def filter_transform(
    transform: Transform,
    include_types: Sequence[type] = None,
    exclude_types: Sequence[type] = None,
) -> Transform:
    """Recursively filter a Compose pipeline by transform type, inside
    OneOf choices too (their weights renormalized)."""
    def _keep(t):
        if include_types is not None and not any(isinstance(t, typ) for typ in include_types):
            return False
        if exclude_types is not None and any(isinstance(t, typ) for typ in exclude_types):
            return False
        return True

    def _copy_meta(out):
        out.p = transform.p
        out.include = transform.include
        out.exclude = transform.exclude
        return out

    if isinstance(transform, Compose):
        kept = []
        for t in transform:
            if isinstance(t, (Compose, OneOf)):
                sub = filter_transform(t, include_types, exclude_types)
                if not isinstance(sub, (Compose, OneOf)) or sub.transforms:
                    kept.append(sub)
                continue
            if _keep(t):
                kept.append(t)
        return _copy_meta(Compose(kept))
    if isinstance(transform, OneOf):
        pairs = []
        for t, w in zip(transform.transforms, transform.weights):
            if isinstance(t, (Compose, OneOf)):
                sub = filter_transform(t, include_types, exclude_types)
                if not isinstance(sub, (Compose, OneOf)) or sub.transforms:
                    pairs.append((sub, float(w)))
                continue
            if _keep(t):
                pairs.append((t, float(w)))
        if not pairs:
            return _copy_meta(Compose([]))
        return _copy_meta(OneOf(dict(pairs)))
    return transform


def invert_records(
    subject: Subject,
    records: Sequence[TransformRecord],
    warn: bool = True,
) -> Subject:
    """Undo a history tape (newest first) on ``subject``; non-invertible
    entries are skipped (torchio ``Compose.inverse(warn=False)``)."""
    for rec in reversed(list(records)):
        t = rec.transform
        if not t.is_invertible():
            if warn:
                warnings.warn(f"Skipping non-invertible transform {type(t).__name__}")
            continue
        inv = t.inverse(rec.args)
        subject = inv(subject, record=False)
    return subject


def apply_inverse_on_new_subject(
    source_records: Sequence[TransformRecord],
    subject: Subject,
    include_types: Sequence[type] = None,
    warn: bool = False,
) -> Subject:
    """Build the (optionally type-filtered) inverse pipeline from another
    subject's tape and run it on ``subject`` (add_evaluation_labels)."""
    records = filter_records(source_records, include_types=include_types)
    return invert_records(subject, records, warn=warn)
