"""Transform base and the applied-transform tape, ported from
segmentation_pipeline_tpu/transforms/base.py (``Transform``,
``TransformRecord`` and the host RNG they draw from).

A transform application mutates the subject in place and records its
reproducible applied args on the subject's history tape, so that the tape can
be inverted once the invertible transforms are ported.
"""
from __future__ import annotations

import threading as _threading
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.subject import Image, Subject
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
